"""Where the card's time goes in one microbatch of ``chip_smoke.py``'s
``train`` cases: ``build_train_step`` at ``train_4k``'s sequence (4,096)
on one microbatch's rows (the config's global batch of 8 over its
``grad_accum``), so one step is one microbatch's forward, recompute and
backward and the optimizer's update.  Seed-0 weights, a packed batch
(``chip_smoke.train_batch``).  One step warms up; the next is timed on the
host clock to its end on the card, and one more runs under
``torch.profiler``: the card's busy time and the kernels with the most of
it, each named as the profiler names it, with its launches.

    python3 probes_torch/train_step_trace.py [arch:layers ...]
    # default deepseek-v3-671b:3 yi-6b:16, chip_smoke's train depths

Needs a CUDA card.  One JSON line an arch."""

import dataclasses
import json
import pathlib
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402

TOP = 12


def trace(dev: torch.device, arch: str, layers: int) -> dict:
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.configs.base import SHAPES
    from repro_torch.launch.steps import build_train_step
    from repro_torch.optim import init_opt_state

    cfg = dataclasses.replace(get_config(arch), num_layers=layers)
    rows = cs.TRAIN_BATCH // cfg.grad_accum["train_4k"]
    shape = dataclasses.replace(SHAPES["train_4k"], global_batch=rows)
    bundle = build_train_step(cfg, shape, grad_accum=1, device=dev)
    params = bundle.model.init(seed=0, device=dev)
    opt_state = init_opt_state(bundle.opt_cfg, params)
    batch = cs.train_batch(cfg, rows, shape.seq_len, seed=0)
    bundle.fn(params, opt_state, batch)
    cs.sync(dev)
    t0 = time.perf_counter()
    bundle.fn(params, opt_state, batch)
    enqueue = time.perf_counter() - t0
    cs.sync(dev)
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        bundle.fn(params, opt_state, batch)
        cs.sync(dev)
    on_card = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in on_card) / 1e3
    top = sorted(on_card, key=lambda e: -e.self_device_time_total)[:TOP]
    return {"probe": "train_step_trace", "arch": cfg.name, "layers": layers, "rows": rows, "seq": shape.seq_len,
            "microbatch_wall_ms": wall * 1e3, "microbatch_enqueue_ms": enqueue * 1e3, "device_busy_ms": busy,
            "device_launches": sum(e.count for e in on_card),
            "top_kernels": [[e.key[:90], e.self_device_time_total / 1e3, e.count] for e in top],
            "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
            "card": torch.cuda.get_device_name(0)}


def main(argv: list[str]) -> int:
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.phase_device(), flush=True)
    for spec in argv or ["deepseek-v3-671b:3", "yi-6b:16"]:
        arch, layers = spec.split(":")
        print(json.dumps(trace(dev, arch, int(layers))), flush=True)
        cs.release_card()
        torch.cuda.reset_peak_memory_stats(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
