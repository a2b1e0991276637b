"""Training runtime: a fault-tolerant loop over an SPDL data pipeline.

The PyTorch port of ``repro.runtime.trainer`` on one card:
  - checkpoint/restart: periodic asynchronous checkpoints of params,
    optimizer state, step and the sampler cursor; ``Trainer.from_checkpoint``
    resumes with the sampler where the checkpoint left it;
  - starvation monitoring: wall time splits into data wait (``next`` on the
    pipeline) and step time (the step until its loss is ready on the card),
    and ``tuning_hint`` names the pipeline stage to widen when the trainer
    waits for data (the paper's "Visibility" put to work);
  - the data pipeline runs on its scheduler thread and worker pool, so the
    main thread spends its time enqueueing steps.

Batches arrive on the card from the loader's ``DeviceTransfer``, whose copy
stream the current stream already waits for; the step runs on that stream,
the main thread's default stream.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable

import torch

from ..ckpt import CheckpointManager, latest_step, load_checkpoint
from ..configs.base import ModelConfig, ShapeConfig
from ..core import Pipeline
from ..device import resolve_device
from ..launch.steps import build_train_step, opt_config_for
from ..optim import init_opt_state

logger = logging.getLogger("repro_torch.trainer")


@dataclasses.dataclass
class TrainerConfig:
    ckpt_dir: str = "checkpoints"
    ckpt_every: int = 50
    ckpt_keep: int = 2
    log_every: int = 10
    starvation_threshold: float = 0.25  # data-wait fraction that flags the loader


class Trainer:
    def __init__(
        self,
        cfg: ModelConfig,
        shape: ShapeConfig,
        *,
        tcfg: TrainerConfig | None = None,
        grad_accum: int | None = None,
        seed: int = 0,
        device: torch.device | str | None = None,  # None = torch.device("cuda")
    ):
        self.device = resolve_device(device, "Trainer")
        self.cfg = cfg
        self.shape = shape
        self.tcfg = tcfg or TrainerConfig()
        self.bundle = build_train_step(cfg, shape, grad_accum=grad_accum, device=self.device)
        self.model = self.bundle.model
        self.opt_cfg = opt_config_for(cfg)
        self.params = self.model.init(seed, self.device)
        self.opt_state = init_opt_state(self.opt_cfg, self.params)
        self.step = 0
        self.manager = CheckpointManager(
            self.tcfg.ckpt_dir, every=self.tcfg.ckpt_every, keep=self.tcfg.ckpt_keep
        )
        self.data_wait_s = 0.0
        self.step_s = 0.0

    # -- restart -----------------------------------------------------------
    @classmethod
    def from_checkpoint(
        cls, cfg, shape, *, sampler=None, tcfg=None, grad_accum=None, device=None
    ) -> "Trainer":
        t = cls(cfg, shape, tcfg=tcfg, grad_accum=grad_accum, device=device)
        if latest_step(t.tcfg.ckpt_dir) is not None:
            restored = load_checkpoint(t.tcfg.ckpt_dir, t.params, t.opt_state)
            t.params = restored["params"]
            t.opt_state = restored["opt_state"]
            t.step = restored["step"]
            if sampler is not None and restored["sampler"] is not None:
                sampler.load_state_dict(restored["sampler"])
            logger.info("resumed from step %d", t.step)
        return t

    # -- loop ---------------------------------------------------------------
    def fit(
        self,
        pipeline: Pipeline,
        *,
        steps: int,
        sampler=None,
        on_metrics: Callable[[int, dict], None] | None = None,
    ) -> dict:
        history: list[dict] = []
        it = iter(pipeline)
        target = self.step + steps
        while self.step < target:
            t0 = time.monotonic()
            try:
                batch = next(it)
            except StopIteration:
                logger.warning("pipeline exhausted at step %d", self.step)
                break
            t1 = time.monotonic()
            self.params, self.opt_state, metrics = self.bundle.fn(
                self.params, self.opt_state, batch
            )
            # wait for the step on the card before the clock stops: the
            # copy of the loss is ordered after everything the step enqueued
            float(metrics["loss"])
            t2 = time.monotonic()
            self.data_wait_s += t1 - t0
            self.step_s += t2 - t1
            self.step += 1
            if self.step % self.tcfg.log_every == 0 or self.step == target:
                m = {k: float(v) for k, v in metrics.items()}
                m.update(self.health())
                history.append({"step": self.step, **m})
                if on_metrics:
                    on_metrics(self.step, m)
                logger.info("step %d %s", self.step, m)
            self.manager.maybe_save(
                self.step,
                self.params,
                self.opt_state,
                sampler.state_dict() if sampler is not None else None,
            )
        self.manager.wait()
        return {"history": history, **self.health()}

    # -- health / straggler signal -------------------------------------------
    def health(self) -> dict:
        total = self.data_wait_s + self.step_s
        frac = self.data_wait_s / total if total > 0 else 0.0
        return {
            "data_wait_frac": round(frac, 4),
            "starved": frac > self.tcfg.starvation_threshold,
        }

    def tuning_hint(self, pipeline: Pipeline) -> str:
        """Visibility-driven advice: which stage to widen when starved."""
        if not self.health()["starved"]:
            return "loader keeps up (sink occupancy healthy); no action"
        stats = pipeline.stats()
        busiest = max(stats, key=lambda s: s.occupancy)
        return (
            f"trainer is data-starved; bottleneck stage is {busiest.name!r} "
            f"(occupancy {busiest.occupancy:.0%}) — raise its concurrency "
            f"or the worker pool size"
        )
