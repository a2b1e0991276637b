"""End-to-end driver: train a ~100M-param LM for a few hundred steps on the
CUDA card, fed by the SPDL pipeline, with checkpoint/resume fault
tolerance.

The twin of ``examples/train_lm.py``: the same arguments and defaults, the
port's loader, ``Trainer.from_checkpoint`` and ``fit``.  A second run on
the same ``--ckpt-dir`` resumes at the last checkpoint.

Run: PYTHONPATH=src python examples_torch/train_lm.py [--steps 300] [--arch qwen3-0.6b] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses

from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import Pipeline
from repro_torch.data import SyntheticTokenDataset, build_lm_loader
from repro_torch.data.sampler import CheckpointableSampler
from repro_torch.runtime import Trainer, TrainerConfig

CKPT_EVERY, LOG_EVERY = 100, 20


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default="/tmp/repro_torch_train_lm")
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    return ap.parse_args(argv)


def build(args: argparse.Namespace) -> tuple[Trainer, Pipeline, CheckpointableSampler]:
    """The trainer, restored from ``args.ckpt_dir`` where it holds a
    checkpoint, and its loader (not started) with the sampler they share."""
    # ~100M-param config: widen the smoke config
    cfg = get_smoke_config(args.arch)
    cfg = dataclasses.replace(
        cfg,
        d_model=args.d_model,
        num_layers=args.layers,
        num_heads=8,
        num_kv_heads=4,
        head_dim=0,
        d_ff=4 * args.d_model,
        vocab_size=50304,
    )
    shape = ShapeConfig("example_train", args.seq_len, args.batch, "train")

    ds = SyntheticTokenDataset(5_000, vocab=cfg.vocab_size, min_len=64, max_len=512)
    sampler = CheckpointableSampler(len(ds), batch_size=8, seed=0)
    pipe, sampler = build_lm_loader(
        ds, seq_len=args.seq_len, batch_size=args.batch, sampler=sampler, num_threads=6,
        device=args.device,
    )

    tcfg = TrainerConfig(ckpt_dir=args.ckpt_dir, ckpt_every=CKPT_EVERY, log_every=LOG_EVERY)
    trainer = Trainer.from_checkpoint(cfg, shape, sampler=sampler, tcfg=tcfg, device=args.device)
    print(f"arch={cfg.name}  params={trainer.model.param_count() / 1e6:.1f}M  start_step={trainer.step}")
    return trainer, pipe, sampler


def train(trainer: Trainer, pipe: Pipeline, sampler: CheckpointableSampler, steps: int) -> dict:
    """``steps`` steps of ``fit``, then the tuning hint and the history
    printed; returns ``fit``'s result."""
    with pipe.auto_stop():
        out = trainer.fit(pipe, steps=steps, sampler=sampler)
        print(trainer.tuning_hint(pipe))
    for h in out["history"]:
        print(h)
    print(f"data-wait fraction: {out['data_wait_frac']:.1%} (starved={out['starved']})")
    return out


def main(argv: list[str] | None = None) -> dict:
    args = parse_args(argv)
    trainer, pipe, sampler = build(args)
    return train(trainer, pipe, sampler, args.steps)


if __name__ == "__main__":
    main()
