"""Where the host CPU's time goes in ``chip_smoke.py``'s ``train_check`` of
DeepSeek-V3: one ``build_train_step`` step (1 layer and the MTP block,
one row of 128 tokens), the optimizer's update and its zeroed moments
included, on the CPU in bf16 and in f32 under ``torch.profiler``, and the
parameters' draw on the CPU against a draw on the card and a copy.

    python3 probes_torch/train_step_cpu_profile.py

Needs a CUDA card (for the draw on the card).  Prints one JSON line for the
host (threads, AMX), one for the draws, and one for each step: its wall
seconds, its metrics and the 12 aten ops with the most self CPU time."""

import dataclasses
import json
import os
import pathlib
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402


def main() -> None:
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models import Model
    from repro_torch.optim import init_opt_state
    from repro_torch.tree import tree_map

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    flags = open("/proc/cpuinfo").read().split("flags")[1].split("\n")[0].split()
    print(json.dumps({"host": {"threads": torch.get_num_threads(), "cpus": os.cpu_count(),
                               "amx_bf16": "amx_bf16" in flags, "avx512_bf16": "avx512_bf16" in flags}}))
    cfg = dataclasses.replace(get_config("deepseek-v3-671b"), num_layers=cs.DEEPSEEK_CHECK_LAYERS)
    t0 = time.monotonic()
    host = Model(cfg).init(seed=0, device="cpu")
    cpu_s = time.monotonic() - t0
    t0 = time.monotonic()
    copied = tree_map(lambda t: t.cpu(), Model(cfg).init(seed=0, device=dev))
    print(json.dumps({"draw": {"params": Model(cfg).param_count(), "on_cpu_s": cpu_s,
                               "on_card_and_copy_s": time.monotonic() - t0}}))
    del copied
    batch = cs.train_batch(cfg, 1, cs.DEEPSEEK_CHECK_SEQ, seed=6)
    for dtype in ("bfloat16", "float32"):
        c = dataclasses.replace(cfg, dtype=dtype)
        params = tree_map(lambda t: t.to(getattr(torch, dtype), copy=True), host)
        bundle = build_train_step(c, ShapeConfig("check", cs.DEEPSEEK_CHECK_SEQ, 1, "train"), grad_accum=1,
                                  device="cpu")
        t0 = time.monotonic()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            _, _, metrics = bundle.fn(params, init_opt_state(bundle.opt_cfg, params), batch)
        wall = time.monotonic() - t0
        top = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:12]
        print(json.dumps({"step": dtype, "wall_s": wall, "metrics": {k: float(v) for k, v in metrics.items()},
                          "top_self_cpu_s": [[e.key, e.count, e.self_cpu_time_total / 1e6] for e in top]}))
        del params


if __name__ == "__main__":
    main()
