"""Checkpointing: asynchronous, atomic, and inclusive of data-pipeline state.

The checkpoint is (params, opt_state, step, sampler state), in the JAX
package's on-disk format, so either package restores what the other saved:

* ``arrays.npz`` holds one array a leaf, keyed ``params`` or ``opt`` plus
  the leaf's ``jax.tree_util.keystr`` path
  (``params['segments'][0]['blocks'][0]['mixer']['wq']``, ``opt['step']``);
* bf16 is not a numpy type: it is stored as its 16 bits (``uint16``), with
  ``"bfloat16"`` in the dtype manifest;
* ``meta.json`` holds ``step``, the manifest (``dtypes``), ``sampler`` and
  ``extra``.

A checkpoint is written into ``.tmp_step_N`` and renamed to ``step_N``, so
a preemption mid-write never leaves a partial checkpoint behind the latest
complete one.  ``CheckpointManager`` takes the host snapshot on the
caller's thread and writes it on a background thread while training goes
on.
"""

from __future__ import annotations

import json
import pathlib
import shutil
import threading
import time
from typing import Any

import numpy as np
import torch

from ..tree import tree_items, tree_map_with_path


def _snapshot(tree: Any) -> dict[str, tuple[np.ndarray, str]]:
    """keystr path → (a host copy as stored, its dtype for the manifest);
    bf16 is stored as its bits, uint16."""
    out = {}
    for path, t in tree_items(tree):
        t = t.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            out[path] = (t.view(torch.int16).numpy().view(np.uint16), "bfloat16")
        else:
            a = t.numpy()
            out[path] = (a, str(a.dtype))
    return out


def _write(ckpt_dir: pathlib.Path, step: int, blobs: dict, sampler_state, extra) -> pathlib.Path:
    final = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f".tmp_step_{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    np.savez(tmp / "arrays.npz", **{k: a for k, (a, _) in blobs.items()})
    meta = {
        "step": step,
        "dtypes": {k: dt for k, (_, dt) in blobs.items()},
        "sampler": sampler_state,
        "extra": extra or {},
    }
    (tmp / "meta.json").write_text(json.dumps(meta))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)  # atomic publish
    return final


def _blobs(params: Any, opt_state: Any | None) -> dict:
    blobs = {f"params{k}": v for k, v in _snapshot(params).items()}
    if opt_state is not None:
        blobs.update({f"opt{k}": v for k, v in _snapshot(opt_state).items()})
    return blobs


def save_checkpoint(
    ckpt_dir: str | pathlib.Path,
    step: int,
    params: Any,
    opt_state: Any | None = None,
    sampler_state: dict | None = None,
    extra: dict | None = None,
) -> pathlib.Path:
    """Write trees of tensors (on any device) as checkpoint ``step``."""
    return _write(pathlib.Path(ckpt_dir), step, _blobs(params, opt_state), sampler_state, extra)


def latest_step(ckpt_dir: str | pathlib.Path) -> int | None:
    ckpt_dir = pathlib.Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = [
        int(p.name.split("_")[1])
        for p in ckpt_dir.iterdir()
        if p.name.startswith("step_")
    ]
    return max(steps) if steps else None


def _restore_into(template: Any, flat: dict[str, torch.Tensor]) -> Any:
    """A tree of ``template``'s structure from the checkpoint's leaves, each
    on the template leaf's device and in its dtype."""

    def one(key: str, t: torch.Tensor) -> torch.Tensor:
        if key not in flat:
            raise KeyError(f"checkpoint missing {key}")
        return flat[key].to(device=t.device, dtype=t.dtype)

    return tree_map_with_path(one, template)


def load_checkpoint(
    ckpt_dir: str | pathlib.Path,
    params_template: Any,
    opt_template: Any | None = None,
    step: int | None = None,
) -> dict:
    """Restore into the given trees of tensors (the authority on structure,
    device and dtype); ``step=None`` takes the latest."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = ckpt_dir / f"step_{step:08d}"
    meta = json.loads((d / "meta.json").read_text())
    raw = {}
    with np.load(d / "arrays.npz") as z:
        for k in z.files:
            a = z[k]
            if meta["dtypes"][k] == "bfloat16":
                raw[k] = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
            else:
                raw[k] = torch.from_numpy(a)
    params = _restore_into(
        params_template, {k[len("params"):]: v for k, v in raw.items() if k.startswith("params")}
    )
    out = {"step": meta["step"], "params": params, "sampler": meta["sampler"], "extra": meta["extra"]}
    if opt_template is not None:
        out["opt_state"] = _restore_into(
            opt_template, {k[len("opt"):]: v for k, v in raw.items() if k.startswith("opt")}
        )
    return out


class CheckpointManager:
    """Periodic asynchronous checkpoints with retention; ``wait()`` before exit.

    ``snapshot_ms`` is the time the last save held the caller's thread: the
    copy of every leaf to the host (on the card, a synchronising copy)."""

    def __init__(self, ckpt_dir: str | pathlib.Path, *, every: int = 100, keep: int = 3):
        self.ckpt_dir = pathlib.Path(ckpt_dir)
        self.every = every
        self.keep = keep
        self.snapshot_ms = 0.0
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def maybe_save(self, step: int, params, opt_state, sampler_state=None, extra=None) -> bool:
        if step % self.every:
            return False
        self.wait()  # at most one write in flight
        # snapshot on the caller's thread (host copies); write in the background
        t0 = time.perf_counter()
        blobs = _blobs(params, opt_state)
        self.snapshot_ms = (time.perf_counter() - t0) * 1e3

        def write():
            try:
                _write(self.ckpt_dir, step, blobs, sampler_state, extra)
                self._gc()
            except BaseException as e:  # surfaced on the next wait()
                self._error = e

        self._thread = threading.Thread(target=write, daemon=True, name="ckpt-writer")
        self._thread.start()
        return True

    def _gc(self) -> None:
        steps = sorted(
            int(p.name.split("_")[1])
            for p in self.ckpt_dir.iterdir()
            if p.name.startswith("step_")
        )
        for s in steps[: -self.keep]:
            shutil.rmtree(self.ckpt_dir / f"step_{s:08d}", ignore_errors=True)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
