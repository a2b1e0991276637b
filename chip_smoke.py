"""Drive the PyTorch port's image path, its LM serving path (dense, SSD,
Mixture-of-Experts, MLA, multi-codebook and vision-prefix models) and its
LM training path on one CUDA card and check them.

    python3 chip_smoke.py

Builds the hand-written kernels from ``src/repro_torch/kernels/csrc``,
holds each against its plain PyTorch version at the main paths' shapes
(with timings and the card's bound; the decode kernels bit for bit, also at
the edges of their row staging, and timed once more in turn beside a cast
and a copy of the same bytes), then runs
  - the port's image loader at ImageNet training geometry (256x256 RGB
    frames, batch 128, random 224x224 crops and flips decoded on the card),
    checks every delivered batch against the same loader run on the CPU,
    and times one batch's host→device copy;
  - the same frames from the sharded record store (``shards``): packed into
    6 shards of 256 and read (a) by mmap, (b) over loopback HTTP through a
    prefetch cache of about two shards, (c) projected to the image column
    of an image + caption pack, (d) through (b)'s warm cache as a peer, (e)
    under ``HealthMonitor.guard()`` with 1% of reads failed and the metrics
    exporter scraped once; every image batch equal to (a)'s, which equals
    its CPU run; (f) token documents in shards over HTTP into
    ``build_lm_loader`` on the card (equal to the in-memory CPU run) and
    two ``Trainer.fit`` steps of Qwen3-0.6B in 2 layers; (g) the
    ``MPLoader`` baseline (4 spawned workers) into K2;
  - Qwen3-0.6B and Mamba2-780m at full width, cut to 2 layers, on the card
    against the same model and weights on the CPU (prefill, then 4 decode
    steps), and each so again at a prompt of 20 tokens: Qwen3's prefill
    pads it to K3's 64-row tiles (``prefill_ragged``), Mamba2's scans it in
    one chunk of 20 steps, not a multiple of K4's 16-row tiles
    (``prefill_ragged_ssd``), and Qwen3 at prompts of two packed
    documents whose positions restart, which K3 masks by position
    (``prefill_restart``);
  - ``apply_moe`` at Granite-MoE-1B-A400M's prefill shape on the card
    against the CPU, in f32 and bf16, and under
    ``torch.cuda.set_sync_debug_mode("error")`` (``moe``);
  - Granite-MoE-1B-A400M at full width, cut to 2 layers, on the card
    against the CPU in f32 with TF32 off (every route equal) and in bf16,
    and Jamba-1.5-Large (2 layers: attention with its dense FFN, then SSD
    with a 16-expert MoE; K3 and K4 in one stack) in bf16; every MoE
    route that differs is printed with its probability gap;
  - DeepSeek-V3 at full width on the card against the CPU: 2 dense MLA
    layers in f32 with TF32 off, and 4 layers (3 dense, then one of 256
    experts top 8 and a shared expert; 31.6 GB of bf16 weights) in bf16,
    MLA's prefill in K3 at head dim 192;
  - ``BatchServer`` on Qwen3-0.6B at full width and depth (28 layers,
    seed-initialized weights), prefill attention in ``flash_attention``;
  - ``BatchServer`` on Mamba2-780m at full width and depth (48 SSD layers,
    seed-initialized weights), the prefill scan in ``ssd_scan``;
  - ``BatchServer`` on Granite-MoE-1B-A400M at full width and depth (24
    attention layers, each FFN 32 experts top 8), K3 in its prefill;
  - ``BatchServer`` on DeepSeek-V3 at full width, cut to 4 layers, K3 in
    its MLA prefill;
  - MusicGen-medium (48 layers, four codebooks) and InternVL2-2B (24
    layers, a vision prefix of 256 positions) at full width and depth
    through ``build_prefill_step`` and ``build_decode_step`` in the
    server's greedy loop (``BatchServer`` takes byte prompts, which carry
    neither), K3 in every prefill; each checked before at 2 layers against
    the CPU in f32 and bf16;
  - one training step of Qwen3-0.6B, Mamba2-780m, Granite-MoE-1B-A400M,
    DeepSeek-V3, MusicGen-medium and InternVL2-2B at full width, cut to 2
    layers (DeepSeek's MTP block beside them), on the card against the same step on the CPU, in f32
    with TF32 off and in bf16 (``train_check``; Granite's aux loss and
    routes, DeepSeek's MTP loss too);
  - ``Trainer.fit`` on ``build_lm_loader`` batches at full width and depth
    (``train``; sequence 4096, global batch 8): Qwen3-0.6B for 6 steps,
    with a checkpoint at step 3 that a fresh ``Trainer.from_checkpoint``
    restores bit for bit, Mamba2-780m for 2 steps, and Granite-MoE-1B-A400M
    for 2 steps (its aux loss beside the LM loss).  Training launches
    none of the four kernels: the reference trains through its plain
    attention and SSD scan, which the port repeats under autograd.
Each phase prints one JSON line.  The last three lines are the kernel
summary, the card's name and power limit as ``nvidia-smi`` gives them, and
``{"ok": true, "device": ...}``.

Exits non-zero, printing no result, when torch sees no CUDA card or when
any phase fails.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tools"))  # route_check

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
BATCH, FRAME, CROP = 128, (256, 256), (224, 224)
FRAMES = 1536  # 12 batches an epoch; 2 epochs cycle the 10-slab ring twice over
# Peaks of the H100 SXM part (NVIDIA's data sheet, dense, at 700 W); every
# bound row carries the nvidia-smi name of the card it ran on beside them.
PEAKS_FOR = "H100 SXM"
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12  # outside the tensor cores
BF16_TC_OPS_PER_S = 989e12  # bf16 on the tensor cores
OPS_PER_ELEMENT = 3  # x*scale, -mean_c, *(1/std_c)
BF16_BAR, F32_BAR = "1 bf16 ulp", 2e-5
TIMED_RUNS = 30
HOST_COVER_CYCLES = 200_000  # a device sleep of ~0.1 ms, longer than a wrapper's host time
FA_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}  # tests/test_kernels.py TOL, atol and rtol
SSD_TOL = {torch.float32: 3e-5, torch.bfloat16: 6e-2}  # tests/test_kernels.py's SSD sweep, atol and rtol
MODEL_REL = 2e-2  # bf16 model outputs: max |card - cpu| over max |cpu|
TRAIN_F32_REL = 1e-4  # f32 train step, TF32 off: the CPU tests' f32 gradient bar, of the largest |cpu value|
SWAP_GAP = 1e-2  # bf16: a MoE route may differ from the CPU's only where its k-th and (k+1)-th probabilities are closer
SWAP_GAP_F32 = 1e-5  # f32, TF32 off: the same, for rounding some 1e-6 of a value
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW, SERVE_PROMPTS = 8, 512, 16, 16
MLA_V_DIM = 128  # DeepSeek-V3's v head dim, padded to q's 192 for K3
CHECK_SEQ, CHECK_BATCH = 512, 2  # train_check: one step, card against CPU, 2 layers
DEEPSEEK_CHECK_SEQ = 128  # DeepSeek-V3's train_check, one row: 3.71 B parameters, two steps on the CPU
TRAIN_SEQ, TRAIN_BATCH = 4096, 8  # train: TRAIN_4K's sequence, its global batch 256 cut to 8
TRAIN_STEPS, TRAIN_CKPT_AT, TRAIN_RESUME_STEPS = 6, 3, 2  # Qwen3's train phase
OWN_ROUNDING = 1.5  # a bf16 gradient leaf may differ by 1.5x the CPU's own bf16 rounding of it
SHARD_SAMPLES, SHARD_WINDOW = 256, 512  # shards phase: 6 shards of about 50 MB; the shuffle spans two
SHARD_CACHE_BYTES = 110_000_000  # about two shards: every epoch over HTTP evicts
LM_DOCS, LM_BATCHES = 4096, 3  # shards phase (f): token documents in 4 shards; batches held to the CPU run
MP_WORKERS = 4  # shards phase (g): the process-pool baseline's workers


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def bf16_ulp_steps(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Distance in bf16 ulps between two bf16 tensors of equal shape."""
    def order(t):
        bits = t.contiguous().view(torch.int16).to(torch.int32)
        mag = bits & 0x7FFF
        return torch.where(bits < 0, -mag, mag)
    return (order(got) - order(want)).abs()


def compare(got: torch.Tensor, want: torch.Tensor) -> dict:
    """max |got - want| and the count of elements over the dtype's bar."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"shape/dtype {got.shape} {got.dtype} vs {want.shape} {want.dtype}")
    err = (got.float() - want.float()).abs()
    if got.dtype == torch.bfloat16:
        over = int((bf16_ulp_steps(got, want) > 1).sum())
        bar = BF16_BAR
    else:
        over = int((err > F32_BAR).sum())
        bar = F32_BAR
    if not torch.isfinite(got.float()).all():
        raise AssertionError("non-finite output")
    return {"max_abs_err": float(err.max()), "mismatches": int((err > 0).sum()),
            "over_bar": over, "bar": bar}


def release_card() -> None:
    """Return what earlier phases left to the card before a phase that needs
    most of it: objects in reference cycles (a pipeline's, a trainer's) go
    only when the collector runs, and with them the tensors they hold."""
    gc.collect()
    torch.cuda.empty_cache()


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _timed_once(fn, flush: torch.Tensor, hide_host: bool) -> float:
    flush.zero_()
    if hide_host:
        torch.cuda._sleep(HOST_COVER_CYCLES)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def time_ms(fn, flush: torch.Tensor, hide_host: bool = True) -> float:
    """Median device time of ``fn`` over TIMED_RUNS launches, each after an
    L2 flush (the decode reads a batch that was just copied in, cold).  With
    ``hide_host`` the card sleeps after the flush while the host enqueues
    ``fn``, so the wrapper's host time before its launch is not counted."""
    for _ in range(3):
        fn()
    return statistics.median(_timed_once(fn, flush, hide_host) for _ in range(TIMED_RUNS))


def time_interleaved_ms(fns: dict, flush: torch.Tensor) -> dict:
    """``time_ms`` of each of ``fns``, taken in turn within each of the
    TIMED_RUNS rounds, so that all of them see the same card state."""
    for fn in fns.values():
        for _ in range(3):
            fn()
    times: dict[str, list[float]] = {name: [] for name in fns}
    for _ in range(TIMED_RUNS):
        for name, fn in fns.items():
            times[name].append(_timed_once(fn, flush, True))
    return {name: statistics.median(t) for name, t in times.items()}


def host_ms(fn, dev: torch.device) -> float:
    """Median host time of one call of ``fn`` with the card idle: what the
    caller's thread spends before it returns."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(TIMED_RUNS):
        sync(dev)
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    sync(dev)
    return statistics.median(times)


def bound(nbytes: int, ops: int, ops_per_s: float, card: str) -> dict:
    """The least time for ``nbytes`` of memory traffic and ``ops`` operations
    at the published peaks of ``PEAKS_FOR``, with the card it ran on."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "ops": ops, "peaks_for": PEAKS_FOR, "card": card}


def dequant_bound(n_read: int, in_size: int, n_out: int, out_size: int, extra_bytes: int, card: str) -> dict:
    return bound(n_read * in_size + n_out * out_size + extra_bytes, n_out * OPS_PER_ELEMENT, F32_OPS_PER_S, card)


def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return smi


def phase_build() -> None:
    from repro_torch.kernels import _build

    seconds, log = _build.build_all()
    ptxas = [ln.strip() for ln in log.splitlines()
             if "entry function" in ln or ("ptxas info" in ln and "Used" in ln) or "spill" in ln]
    emit({"phase": "build", "seconds": seconds, "dir": str(_build.BUILD_DIR.relative_to(ROOT)), "ptxas": ptxas})


def phase_kernels(dev: torch.device, summary: dict, card: str) -> None:
    """K1 and K2 against their plain versions on the card, every case bit
    for bit: the main paths' shapes, and the edges of the kernel's row
    staging (spans that end at x's last byte, rows of 51 bytes, odd left
    offsets that start a span mid-word, a batch of 1, a row tile cut short,
    draws outside the frame and flips other than 0 and 1).  The main cases
    are timed, K1 also through its wrapper, and K1, K2 and a same-bytes
    cast once more in turn."""
    from repro_torch.kernels import dequant_normalize as dn

    gen = torch.Generator(device="cpu").manual_seed(0)
    mean = torch.tensor(MEAN, device=dev)
    std = torch.tensor(STD, device=dev)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)  # > the 50 MB L2
    k1, k2 = summary["dequant_normalize_augment"], summary["dequant_normalize"]

    def frames(shape, dtype):
        if dtype == torch.uint8:
            return torch.randint(0, 256, shape, generator=gen, dtype=torch.uint8).to(dev)
        return torch.rand(shape, generator=gen).to(dev)

    def draws(kind, n, h, w, oh, ow):
        flip = torch.randint(0, 2, (n,), generator=gen, dtype=torch.int32)
        top = torch.randint(0, h - oh + 1, (n,), generator=gen)
        left = torch.randint(0, w - ow + 1, (n,), generator=gen)
        if kind == "corner":
            top, left = torch.full((n,), h - oh), torch.full((n,), w - ow)
        elif kind == "odd_left":
            left = (left | 1).clamp(max=w - ow)
        elif kind == "wild":
            flip = torch.tensor([2, -1, 7, 0] * n, dtype=torch.int32)[:n]
            top = torch.tensor([-5, 100, -1, 1000] * n)[:n]
            left = torch.tensor([100, -5, -1, 3] * n)[:n]
        return flip, torch.stack([top, left], 1).to(torch.int32)

    def exact(row, what):
        if row["mismatches"]:
            emit(row)
            raise AssertionError(f"{what}: {row['mismatches']} elements differ from the plain version")

    u8, f32, bf16 = torch.uint8, torch.float32, torch.bfloat16
    odd = (3, 13, 17, 3)  # 51-byte rows; x ends 5 bytes into a 16-byte word
    cases = [  # name, shape, in dtype, out_hw, out dtype, draws
        ("main", (BATCH, *FRAME, 3), u8, CROP, bf16, "random"),
        ("f32_in", (BATCH, *FRAME, 3), f32, CROP, bf16, "random"),
        ("f32_out", (BATCH, *FRAME, 3), u8, CROP, f32, "random"),
        ("odd", odd, u8, (9, 11), bf16, "random"),
        ("far_corner", (BATCH, *FRAME, 3), u8, CROP, bf16, "corner"),
        ("far_corner_odd", odd, u8, (9, 11), bf16, "corner"),
        ("odd_left", (BATCH, *FRAME, 3), u8, CROP, bf16, "odd_left"),
        ("batch1", (1, *FRAME, 3), u8, CROP, bf16, "random"),
        ("ragged_rows", (4, 40, 48, 3), u8, (27, 32), bf16, "random"),  # 27 rows: 3 tiles of 8 and one of 3
        ("wild_draws", (4, 40, 48, 3), u8, (27, 32), bf16, "wild"),
        ("odd_f32_in_out", odd, f32, (9, 11), f32, "corner"),
    ]
    for case, shape, in_dtype, (oh, ow), out_dtype, kind in cases:
        n, h, w, c = shape
        x = frames(shape, in_dtype)
        flip, crop = draws(kind, n, h, w, oh, ow)
        got = dn.dequant_normalize_augment(x, mean, std, flip, crop, out_hw=(oh, ow), out_dtype=out_dtype)
        want = dn.dequant_normalize_augment_plain(x, mean, std, flip, crop, out_hw=(oh, ow), out_dtype=out_dtype)
        sync(dev)
        row = {"phase": "kernels", "kernel": "dequant_normalize_augment", "case": case,
               "shape": list(shape), "in": str(in_dtype), "out_hw": [oh, ow], "out": str(out_dtype),
               "draws": kind, **compare(got, want)}
        k1["max_abs_err"] = max(k1["max_abs_err"], row["max_abs_err"])
        exact(row, f"dequant_normalize_augment {case}")
        if case == "main":
            dflip, dcrop = flip.to(dev), crop.to(dev)
            params = dn._card_draws(x, dflip, dcrop)

            def wrapper():
                return dn.dequant_normalize_augment(x, mean, std, flip, crop, out_hw=(oh, ow), out_dtype=out_dtype)

            row["ms"] = time_ms(lambda: dn._launch(x, mean, std, params, oh, ow, dn.U8_SCALE, out_dtype, "k1"),
                                flush)
            row["wrapper_ms"] = time_ms(wrapper, flush, hide_host=False)
            row["wrapper_host_ms"] = host_ms(wrapper, dev)
            row["plain_ms"] = time_ms(lambda: dn.dequant_normalize_augment_plain(
                x, mean, std, dflip, dcrop, out_hw=(oh, ow), out_dtype=out_dtype), flush)
            row.update(dequant_bound(n * oh * ow * c, x.element_size(), n * c * oh * ow, got.element_size(),
                                     params.numel() * 4 + 2 * c * 4, card))
            row["over_bound"] = row["ms"] / row["bound_ms"]
            row["wrapper_note"] = ("wrapper_ms: device time with the host's draws staged and copied in the "
                                   "timed window; wrapper_host_ms: the caller's host time a call, card idle")
            k1_main = (x, params)
            k1.update({key: row[key] for key in
                       ("ms", "plain_ms", "bound_ms", "bound_by", "wrapper_ms", "wrapper_host_ms")})
        emit(row)

    k2_cases = [  # name, shape, in dtype, out dtype
        ("main", (BATCH, *CROP, 3), u8, bf16),
        ("odd", odd, u8, bf16),
        ("odd_f32_out", odd, u8, f32),
        ("batch1", (1, *CROP, 3), u8, bf16),
    ]
    for case, shape, in_dtype, out_dtype in k2_cases:
        x = frames(shape, in_dtype)
        got = dn.dequant_normalize(x, mean, std, out_dtype=out_dtype)
        want = dn.dequant_normalize_plain(x, mean, std, out_dtype=out_dtype)
        sync(dev)
        row = {"phase": "kernels", "kernel": "dequant_normalize", "case": case,
               "shape": list(x.shape), "out": str(out_dtype), **compare(got, want)}
        k2["max_abs_err"] = max(k2["max_abs_err"], row["max_abs_err"])
        exact(row, f"dequant_normalize {case}")
        if case == "main":
            row["ms"] = time_ms(lambda: dn.dequant_normalize(x, mean, std), flush)
            row["plain_ms"] = time_ms(lambda: dn.dequant_normalize_plain(x, mean, std), flush)
            row.update(dequant_bound(x.numel(), 1, x.numel(), 2, 2 * 3 * 4, card))
            row["over_bound"] = row["ms"] / row["bound_ms"]
            k2_x = x
            k2.update({key: row[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by")})
        emit(row)

    # K1 and K2 in turn, with a cast that reads and writes K2's bytes beside them
    x1, params = k1_main
    half = torch.empty(k2_x.numel() * 3 // 2, dtype=torch.uint8, device=dev)  # half of K2's bytes
    half_out = torch.empty_like(half)
    both = time_interleaved_ms({
        "k1": lambda: dn._launch(x1, mean, std, params, *CROP, dn.U8_SCALE, bf16, "k1"),
        "k2": lambda: dn._launch(k2_x, mean, std, None, *CROP, dn.U8_SCALE, bf16, "k2"),
        "same_bytes": lambda: k2_x.to(bf16),
        "memcpy_same_bytes": lambda: half_out.copy_(half),
    }, flush)
    emit({"phase": "kernels", "case": "k1_k2_interleaved", "k1_ms": both["k1"], "k2_ms": both["k2"],
          "same_bytes_ms": both["same_bytes"], "memcpy_same_bytes_ms": both["memcpy_same_bytes"],
          "bound_ms": k2["bound_ms"],
          "same_bytes": "x.to(torch.bfloat16) on K2's input: the same bytes read and written, "
                        "no transpose, no normalize; a yardstick, not library_ms",
          "memcpy_same_bytes": "a device-to-device copy of half K2's bytes: the same bytes moved as "
                               "plainly as the card moves them",
          "order": "K1, K2, same_bytes, memcpy_same_bytes in turn, each after an L2 flush, "
                   "median of TIMED_RUNS rounds"})
    k1["interleaved_ms"], k2["interleaved_ms"] = both["k1"], both["k2"]
    k2["same_bytes_ms"], k2["memcpy_same_bytes_ms"] = both["same_bytes"], both["memcpy_same_bytes"]


def run_loader(ds, device, decode, epochs: int, keep) -> tuple[int, float]:
    """Drive the port's image loader; ``keep(batch)`` sees each batch on
    the consumer thread.  Returns (batches, wall seconds to the last one)."""
    from repro_torch.data import CheckpointableSampler, build_image_loader

    pipe = build_image_loader(
        ds, batch_size=BATCH, hw=FRAME, device=device, device_decode=decode, epochs=epochs,
        sampler=CheckpointableSampler(len(ds), batch_size=BATCH, seed=0),
    )
    t0 = time.monotonic()
    n = 0
    with pipe.auto_stop():
        for batch in pipe:
            keep(batch["images"])
            n += 1
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return n, time.monotonic() - t0


def h2d_copy(dev: torch.device) -> dict:
    """One batch's host→device copy as ``DeviceTransfer._put`` makes it:
    from a pinned slab-shaped tensor, on a side stream, timed with CUDA
    events on that stream (median of TIMED_RUNS copies)."""
    host = torch.full((BATCH, *FRAME, 3), 7, dtype=torch.uint8, pin_memory=True)
    side = torch.cuda.Stream(dev)
    times = []
    for i in range(3 + TIMED_RUNS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(side):
            start.record(side)
            host.to(dev, non_blocking=True)
            end.record(side)
        end.synchronize()
        if i >= 3:
            times.append(start.elapsed_time(end))
    ms = statistics.median(times)
    return {"h2d_ms": ms, "h2d_gb_per_s": host.numel() / ms * 1e-6, "h2d_batch_bytes": host.numel()}


def phase_main(ds, dev: torch.device, summary: dict) -> None:
    from repro_torch.data.transfer import DeviceDecode
    from repro_torch.kernels import dequant_normalize as dn

    decode = DeviceDecode(MEAN, STD, out_hw=CROP, flip=True, crop=True, seed=0)
    host: list[torch.Tensor] = []
    n_host, _ = run_loader(ds, "cpu", decode, 2, host.append)

    card: list[torch.Tensor] = []
    dn.dequant_normalize_augment.launches = 0
    n_card, wall = run_loader(ds, dev, decode, 2, card.append)
    launches = dn.dequant_normalize_augment.launches

    worst = {"max_abs_err": 0.0, "mismatches": 0, "over_bar": 0}
    for got, want in zip(card, host):
        if got.device != dev or tuple(got.shape) != (BATCH, 3, *CROP):
            raise AssertionError(f"delivered {got.device} {tuple(got.shape)}")
        r = compare(got.cpu(), want)
        worst = {"max_abs_err": max(worst["max_abs_err"], r["max_abs_err"]),
                 "mismatches": worst["mismatches"] + r["mismatches"],
                 "over_bar": worst["over_bar"] + r["over_bar"], "bar": r["bar"]}
    expected = 2 * (FRAMES // BATCH)
    emit({"phase": "main", "frames": FRAMES, "hw": list(FRAME), "batch": BATCH, "out_hw": list(CROP),
          "batches": n_card, "cpu_batches": n_host, "k1_launches": launches,
          "slabs_pinned": n_card == expected,
          "pinned_rule": "on CUDA the transfer copies each slab batch from its pinned tensor and raises otherwise",
          "all_batches_vs_cpu_run": worst, "wall_s": wall, "images_per_s": n_card * BATCH / wall,
          "h2d_bytes": n_card * BATCH * FRAME[0] * FRAME[1] * 3, "loader_ms_per_batch": wall / n_card * 1e3,
          **h2d_copy(dev), "k1_ms": summary["dequant_normalize_augment"]["ms"],
          "reading": "images_per_s, the copy's time and h2d_bytes are not gates"})
    if n_card != expected or n_host != expected:
        raise AssertionError(f"delivered {n_card} (card) / {n_host} (cpu) batches, expected {expected}")
    if launches != n_card:
        raise AssertionError(f"K1 launched {launches} times for {n_card} batches")
    if worst["over_bar"]:
        raise AssertionError(f"{worst['over_bar']} decoded elements over the bar against the CPU run")
    summary["dequant_normalize_augment"]["launches"] = launches
    summary["dequant_normalize_augment"]["max_abs_err"] = max(
        summary["dequant_normalize_augment"]["max_abs_err"], worst["max_abs_err"])


def phase_example(ds, dev: torch.device, summary: dict) -> None:
    """The uint8 wire without device_decode: the consumer decodes the raw
    batches it receives with ``ops.dequant_normalize``."""
    from repro_torch.kernels import dequant_normalize as dn
    from repro_torch.kernels import ops

    mean = torch.tensor(MEAN, device=dev)
    std = torch.tensor(STD, device=dev)
    pairs = []

    def keep(x: torch.Tensor) -> None:
        pairs.append((ops.dequant_normalize(x, mean, std), dn.dequant_normalize_plain(x, mean, std)))

    dn.dequant_normalize.launches = 0
    n, _ = run_loader(ds, dev, None, 1, keep)
    launches = dn.dequant_normalize.launches
    worst = max((compare(g, w) for g, w in pairs), key=lambda r: (r["over_bar"], r["max_abs_err"]))
    emit({"phase": "example", "batches": n, "k2_launches": launches, "vs_plain": worst})
    if launches < 1 or launches != n:
        raise AssertionError(f"K2 launched {launches} times for {n} batches")
    if worst["over_bar"]:
        raise AssertionError("K2 over the bar on delivered batches")
    summary["dequant_normalize"]["launches"] = launches
    summary["dequant_normalize"]["max_abs_err"] = max(
        summary["dequant_normalize"]["max_abs_err"], worst["max_abs_err"])


class Captioned:
    """The frames as a two-column source for a format-v2 pack: each frame's
    encoded image, and a short caption beside it."""

    schema_fields = ("image", "caption")

    def __init__(self, frames):
        self.frames = frames

    def __len__(self) -> int:
        return len(self.frames)

    @staticmethod
    def caption(i: int) -> bytes:
        return b"a synthetic photograph, frame %d of the shard phase" % i

    def read_fields(self, i: int, fields=None) -> dict:
        blobs = {"image": self.frames.read_bytes(i), "caption": self.caption(i)}
        return {f: blobs[f] for f in (fields or self.schema_fields)}


def shard_loader(ds, device, **kw):
    """``build_image_loader`` at ``main``'s geometry and decode over a shard
    dataset, with the shard-aware shuffle, 2 epochs."""
    from repro_torch.data import CheckpointableSampler, build_image_loader
    from repro_torch.data.transfer import DeviceDecode

    sampler = CheckpointableSampler(len(ds), batch_size=BATCH, seed=0, shard_sizes=ds.shard_sizes,
                                    shard_window=SHARD_WINDOW)
    return build_image_loader(
        ds, batch_size=BATCH, hw=FRAME, device=device, epochs=2, sampler=sampler,
        device_decode=DeviceDecode(MEAN, STD, out_hw=CROP, flip=True, crop=True, seed=0), **kw,
    )


def drain(pipe, keep, batches=None) -> list[float]:
    """Iterate ``batches`` (default: the pipeline itself) under the pipeline's
    auto-stop, ``keep(images)`` on each; returns each batch's arrival
    seconds after the start, the card synchronized at the end."""
    times, t0 = [], time.monotonic()
    with pipe.auto_stop():
        for batch in (pipe if batches is None else batches):
            keep(batch["images"])
            times.append(time.monotonic() - t0)
    torch.cuda.synchronize()
    return times


def shard_row(sub: str, times: list[float], launches: int, pipe, **extra) -> dict:
    stats = {st.name: st for st in pipe.stats()}
    n = len(times)
    return {"phase": "shards", "sub": sub, "batches": n, "k1_launches": launches,
            "images_per_s": n * BATCH / times[-1], "loader_ms_per_batch": times[-1] / n * 1e3,
            "wall_s": times[-1], "read_failed": stats["read"].num_failed,
            "slabs_in_flight": stats["batch"].slabs_in_flight, **extra}


def equal_batches(got: list[torch.Tensor], want: list[torch.Tensor], sub: str) -> None:
    if len(got) != len(want):
        raise AssertionError(f"shards {sub}: {len(got)} batches against {len(want)}")
    for j, (g, w) in enumerate(zip(got, want)):
        if g.device != w.device or not torch.equal(g, w):
            raise AssertionError(f"shards {sub}: batch {j} differs from (a)'s")


def phase_shards(ds, root: pathlib.Path, dev: torch.device, summary: dict) -> None:
    """The image path from the sharded record store, sub-phases (a)-(g)
    (their docstrings in ``shards_*``): ``main``'s frames packed into 6
    shards of 256 (about 50 MB each; the noise frames do not compress),
    read by mmap, over loopback HTTP, projected from a two-column pack,
    through a peer's warm cache and under the health monitor with injected
    read faults, each into K1 on the card; token documents from shards
    into ``build_lm_loader`` and ``Trainer.fit``; and the process-pool
    baseline into K2."""
    from repro_torch.data import ShardDataset, pack
    from repro_torch.data.shards.testing import serve_shards
    from repro_torch.kernels import dequant_normalize as dn

    k1 = dn.dequant_normalize_augment
    launches: dict[str, int] = {}
    t0 = time.monotonic()
    v1 = pack(ds, root / "shards", samples_per_shard=SHARD_SAMPLES)
    emit({"phase": "shards", "sub": "pack", "shards": v1.num_shards, "samples": len(v1),
          "bytes": sum(f.stat().st_size for f in (root / "shards").glob("*.rpshard")),
          "seconds": time.monotonic() - t0})
    v1.close()

    # (a) local: mmap views decoded into pinned slabs, every batch against a CPU run
    local = ShardDataset(root / "shards")
    host: list[torch.Tensor] = []
    drain(shard_loader(local, "cpu"), host.append)
    base: list[torch.Tensor] = []
    k1.launches = 0
    pipe = shard_loader(local, dev)
    times = drain(pipe, base.append)
    launches["local"] = k1.launches
    worst = {"max_abs_err": 0.0, "mismatches": 0}
    for got, want in zip(base, host):
        r = compare(got.cpu(), want)
        worst = {"max_abs_err": max(worst["max_abs_err"], r["max_abs_err"]),
                 "mismatches": worst["mismatches"] + r["mismatches"]}
    clean = shard_row("local", times, launches["local"], pipe, cpu_batches=len(host),
                      all_batches_vs_cpu_run=worst)
    emit(clean)
    local.close()
    expected = 2 * (FRAMES // BATCH)
    if len(base) != expected or len(host) != expected or worst["mismatches"]:
        raise AssertionError(f"shards local: {len(base)} / {len(host)} batches, {worst} against the CPU run")
    if launches["local"] != expected:
        raise AssertionError(f"shards local: K1 launched {launches['local']} times for {expected} batches")
    del host

    with serve_shards(root / "shards") as origin:
        b_ds = shards_http(origin, root, dev, base, launches)
        shards_peers(origin, b_ds, root, dev, base, launches)
        shards_guarded(origin, root, dev, launches, clean["slabs_in_flight"])
        b_ds.close()
    shards_projection(ds, root, dev, base, launches)
    del base
    summary["dequant_normalize_augment"]["launches"] += sum(launches.values())
    summary["dequant_normalize_augment"].setdefault("launches_by_path", {}).update(
        {f"shards {sub}": n for sub, n in launches.items()})
    shards_lm(root, dev)
    shards_baseline(root, dev, summary, clean["images_per_s"])
    emit({"phase": "shards", "sub": "done", "k1_launches": launches, "seconds": time.monotonic() - t0})


def shards_http(origin, root: pathlib.Path, dev, base: list, launches: dict):
    """(b) the shards over loopback HTTP into a prefetch cache of about two
    shards: every epoch misses and evicts.  Returns the open dataset, whose
    warm cache (d) serves."""
    from repro_torch.data import ShardDataset
    from repro_torch.kernels import dequant_normalize as dn

    ds = ShardDataset(origin.url, cache_dir=root / "cache_b", cache_bytes=SHARD_CACHE_BYTES)
    got: list[torch.Tensor] = []
    dn.dequant_normalize_augment.launches = 0
    pipe = shard_loader(ds, dev)
    times = drain(pipe, got.append)
    launches["http"] = dn.dequant_normalize_augment.launches
    pf = ds.prefetcher.stats()
    half = len(times) // 2
    emit(shard_row("http", times, launches["http"], pipe, cache_bytes=SHARD_CACHE_BYTES,
                   cold_epoch_s=times[half - 1], warm_epoch_s=times[-1] - times[half - 1],
                   prefetcher={key: pf[key] for key in ("hits", "misses", "evictions", "bytes_fetched",
                                                        "index_fetches", "range_fetches", "sparse_shards")},
                   origin_requests=origin.requests, origin_bytes_served=origin.bytes_served))
    equal_batches(got, base, "http")
    if launches["http"] != len(got):
        raise AssertionError(f"shards http: K1 launched {launches['http']} times for {len(got)} batches")
    if not pf["evictions"]:
        raise AssertionError("shards http: a cache of about two shards evicted nothing")
    return ds


def shards_peers(origin, warm, root: pathlib.Path, dev, base: list, launches: dict) -> None:
    """(d) (b)'s warm prefetcher served by a ``PeerShardServer``; a second
    rank reads the origin with that peer in front of it."""
    from repro_torch.data import PeerShardServer, ShardDataset
    from repro_torch.kernels import dequant_normalize as dn

    with PeerShardServer(warm.prefetcher) as peer:
        before = origin.requests
        ds = ShardDataset(origin.url, cache_dir=root / "cache_d", cache_bytes=SHARD_CACHE_BYTES,
                          peers=[peer.url])
        got: list[torch.Tensor] = []
        dn.dequant_normalize_augment.launches = 0
        pipe = shard_loader(ds, dev)
        times = drain(pipe, got.append)
        launches["peers"] = dn.dequant_normalize_augment.launches
        pf = ds.prefetcher.stats()
        served = peer.stats()
        ds.close()
    emit(shard_row("peers", times, launches["peers"], pipe,
                   tier={key: pf.get(f"source_{key}") for key in ("peer_hits", "peer_bytes", "origin_fetches",
                                                                    "origin_bytes", "peer_errors")},
                   origin_requests_this_rank=origin.requests - before,
                   peer_served={key: served[key] for key in ("requests", "misses", "served_whole",
                                                              "served_ranges", "bytes_served")}))
    equal_batches(got, base, "peers")
    if launches["peers"] != len(got):
        raise AssertionError(f"shards peers: K1 launched {launches['peers']} times for {len(got)} batches")
    if not pf.get("source_peer_hits"):
        raise AssertionError("shards peers: no read came from the peer")


def shards_guarded(origin, root: pathlib.Path, dev, launches: dict, clean_slabs: int) -> None:
    """(e) (b)'s loader under ``HealthMonitor.guard()`` (degrading by
    ``disable_verify``), reads failed by a seeded ``FaultInjectingStage``
    (1%: the same count every run), and a ``MetricsExporter`` scraped once
    over loopback after the 12th batch.  The holes must show as the read
    stage's failures, batches stay dense, and the drained loader holds as
    many slabs as (a)'s clean one."""
    import urllib.request

    from repro_torch.core import FaultInjectingStage, HealthMonitor, MetricsExporter, disable_verify
    from repro_torch.data import ShardDataset
    from repro_torch.kernels import dequant_normalize as dn

    ds = ShardDataset(origin.url, cache_dir=root / "cache_e", cache_bytes=SHARD_CACHE_BYTES)
    chaos = FaultInjectingStage(ds.read_bytes, seed=23, error_rate=0.01)
    ds.read_bytes = chaos
    pipe = shard_loader(ds, dev)
    exporter = MetricsExporter()
    exporter.add_pipeline(pipe, name="images")
    monitor = HealthMonitor(pipe, degraded_after_s=5.0, stalled_after_s=60.0,
                            actions=[disable_verify(ds.prefetcher)])
    shapes, scrape = set(), {}

    def keep(x: torch.Tensor) -> None:
        shapes.add((x.device.type, tuple(x.shape)))
        if keep.n == 11:  # mid-run, after the 12th batch
            with exporter.serve() as server:
                scrape["text"] = urllib.request.urlopen(server.url, timeout=30).read().decode()
        keep.n += 1

    keep.n = 0
    dn.dequant_normalize_augment.launches = 0
    times = drain(pipe, keep, monitor.guard(tick=0.5))
    launches["guarded"] = dn.dequant_normalize_augment.launches
    ds.close()
    errors = chaos.stats()["injected_errors"]
    families = sorted({line.split()[2] for line in scrape.get("text", "").splitlines() if line.startswith("# TYPE")})
    row = shard_row("guarded", times, launches["guarded"], pipe, injected_errors=errors,
                    clean_slabs_in_flight=clean_slabs, degrade_actions=monitor.applied_actions(),
                    shapes=sorted(str(sh) for sh in shapes), scrape_families=len(families),
                    scrape_has=[f for f in families if "shard_cache" in f or f.endswith("stage_items_out_total")])
    emit(row)
    want_batches = (2 * FRAMES - errors) // BATCH
    if not errors or row["read_failed"] != errors or row["batches"] != want_batches:
        raise AssertionError(f"shards guarded: {errors} injected, {row['read_failed']} failed reads, "
                             f"{row['batches']} batches (expected {want_batches})")
    if shapes != {(dev.type, (BATCH, 3, *CROP))}:
        raise AssertionError(f"shards guarded: delivered {shapes}")
    if launches["guarded"] != row["batches"]:
        raise AssertionError(f"shards guarded: K1 launched {launches['guarded']} times for {row['batches']} batches")
    if row["slabs_in_flight"] != clean_slabs:
        raise AssertionError(f"shards guarded: {row['slabs_in_flight']} slabs in flight after the drain, "
                             f"a clean run {clean_slabs}")
    for family in ("repro_stage_items_out_total", "repro_shard_cache_hits_total", "repro_arena_slabs_in_flight"):
        if family not in families:
            raise AssertionError(f"shards guarded: the scrape lacks {family}")


def shards_projection(ds, root: pathlib.Path, dev, base: list, launches: dict) -> None:
    """(c) the same frames packed as format v2 with an image and a caption
    column, read over HTTP with ``fields=("image",)``.  The image column is
    most of a shard, so the prefetcher's sparse threshold goes to 1.0 (a
    projected fetch then always pulls column ranges) and its sparse→full
    promotion is off (it fetches whole shards).  No caption byte may
    cross: every shard enters the cache as a projected sparse entry, and the
    origin serves at most the shard files less their caption columns."""
    from repro_torch.data import ShardDataset, pack
    from repro_torch.data.shards.testing import serve_shards
    from repro_torch.kernels import dequant_normalize as dn

    pack(Captioned(ds), root / "shards_v2", samples_per_shard=SHARD_SAMPLES, format_version=2).close()
    captions = sum(len(Captioned.caption(i)) for i in range(len(ds)))
    files = sum(f.stat().st_size for f in (root / "shards_v2").iterdir())
    with serve_shards(root / "shards_v2") as origin:
        proj = ShardDataset(origin.url, fields=("image",), cache_dir=root / "cache_c")
        proj.prefetcher.sparse_threshold = 1.0
        proj.prefetcher.promote_threshold = None  # a sparse→full upgrade would fetch the caption column
        got: list[torch.Tensor] = []
        dn.dequant_normalize_augment.launches = 0
        pipe = shard_loader(proj, dev, fields=("image",))
        times = drain(pipe, got.append)
        launches["projection"] = dn.dequant_normalize_augment.launches
        pf = proj.prefetcher.stats()
        with origin.lock:
            served = origin.bytes_served
        proj.close()
    emit(shard_row("projection", times, launches["projection"], pipe, caption_bytes=captions,
                   files_bytes=files, origin_bytes_served=served,
                   prefetcher={key: pf[key] for key in ("sparse_shards", "fields_requested", "bytes_fetched",
                                                        "bytes_skipped", "range_fetches", "index_fetches")}))
    equal_batches(got, base, "projection")
    if launches["projection"] != len(got):
        raise AssertionError(f"shards projection: K1 launched {launches['projection']} times for {len(got)} batches")
    if pf["sparse_shards"] != FRAMES // SHARD_SAMPLES or served > files - captions:
        raise AssertionError(f"shards projection: {pf['sparse_shards']} sparse shards, {served} bytes served "
                             f"of {files} ({captions} of them captions)")


def shards_lm(root: pathlib.Path, dev) -> None:
    """(f) token documents packed into shards and served over HTTP into
    ``build_lm_loader`` on the card: the first LM_BATCHES batches equal the
    same loader's CPU run over the in-memory documents; then ``Trainer.fit``
    takes 2 steps of Qwen3-0.6B at full width, cut to 2 layers, from the
    same pipeline."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import CheckpointableSampler, ShardDataset, SyntheticTokenDataset, build_lm_loader, pack
    from repro_torch.data.shards.testing import serve_shards
    from repro_torch.runtime import Trainer, TrainerConfig

    t0 = time.monotonic()
    cfg = dataclasses.replace(get_config("qwen3-0.6b"), num_layers=2)
    docs = SyntheticTokenDataset(LM_DOCS, vocab=cfg.vocab_size)
    shards = pack(docs, root / "docs", samples_per_shard=LM_DOCS // 4)

    def loader(ds, device):
        sampler = CheckpointableSampler(len(ds), batch_size=8, seed=0, shard_sizes=shards.shard_sizes,
                                        shard_window=SHARD_WINDOW)
        return build_lm_loader(ds, seq_len=TRAIN_SEQ, batch_size=TRAIN_BATCH, sampler=sampler, device=device)

    def first(it) -> list[dict]:
        return [{k: v.clone() for k, v in next(it).items()} for _ in range(LM_BATCHES)]

    pipe, _ = loader(docs, "cpu")
    with pipe.auto_stop():
        want = first(iter(pipe))
    with serve_shards(root / "docs") as origin, tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as ckpt:
        ds = ShardDataset(origin.url, cache_dir=root / "cache_f")
        pipe, sampler = loader(ds, dev)
        with pipe.auto_stop():
            t1 = time.monotonic()
            got = first(iter(pipe))
            load_s = time.monotonic() - t1
            trainer = Trainer(cfg, ShapeConfig("train_4k", TRAIN_SEQ, TRAIN_BATCH, "train"),
                              tcfg=TrainerConfig(ckpt_dir=ckpt, ckpt_every=10**9, log_every=1), device=dev)
            history = trainer.fit(pipe, steps=2, sampler=sampler)["history"]
            health = trainer.health()
        pf = ds.prefetcher.stats()
        ds.close()
    shards.close()
    same = all(g.keys() == w.keys() and all(torch.equal(g[k].cpu(), w[k]) for k in g) for g, w in zip(got, want))
    emit({"phase": "shards", "sub": "lm", "docs": LM_DOCS, "shards": shards.num_shards, "seq": TRAIN_SEQ,
          "batch": TRAIN_BATCH, "batches": len(got), "equal_to_cpu_in_memory": same,
          "devices": sorted({str(v.device) for g in got for v in g.values()}),
          "loader_ms_per_batch": load_s / len(got) * 1e3, "tokens_per_s_loader": len(got) * TRAIN_SEQ * TRAIN_BATCH / load_s,
          "arch": cfg.name, "layers": cfg.num_layers, "train_steps": len(history),
          "losses": [h["loss"] for h in history], "data_wait_frac": health["data_wait_frac"],
          "prefetcher": {key: pf[key] for key in ("hits", "misses", "bytes_fetched")},
          "k1_launches": 0, "reading": "data_wait_frac is a reading, not a gate", "seconds": time.monotonic() - t0})
    if not same or len(got) != LM_BATCHES or any(v.device.type != dev.type for g in got for v in g.values()):
        raise AssertionError("shards lm: the card's batches from shards differ from the CPU run in memory")
    if len(history) != 2 or not all(math.isfinite(h["loss"]) for h in history):
        raise AssertionError(f"shards lm: {len(history)} steps, losses {[h['loss'] for h in history]}")


def shards_baseline(root: pathlib.Path, dev, summary: dict, local_images_per_s: float) -> None:
    """(g) the paper's baseline: ``MPLoader``, 4 spawned worker processes,
    each unpickling (a)'s ``ShardDataset`` (and so importing the port and
    torch), batches pickled back over a pipe in order; the consumer copies
    each to the card and decodes it with ``ops.dequant_normalize`` (K2).
    One epoch; the first batch is held to K2's plain version."""
    from repro_torch.data import ShardDataset
    from repro_torch.data.baselines import MPLoader
    from repro_torch.kernels import dequant_normalize as dn
    from repro_torch.kernels import ops

    mean = torch.tensor(MEAN, device=dev)
    std = torch.tensor(STD, device=dev)
    ds = ShardDataset(root / "shards")
    loader = MPLoader(ds, batch_size=BATCH, hw=FRAME, num_workers=MP_WORKERS)
    dn.dequant_normalize.launches = 0
    n, check, times, t0 = 0, None, [], time.monotonic()
    for batch in loader:
        x = torch.from_numpy(batch).to(dev)
        y = ops.dequant_normalize(x, mean, std)
        if check is None:
            check = compare(y, dn.dequant_normalize_plain(x, mean, std))
        n += 1
        times.append(time.monotonic() - t0)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = dn.dequant_normalize.launches
    ds.close()
    emit({"phase": "shards", "sub": "baseline", "loader": "MPLoader", "workers": MP_WORKERS, "batches": n,
          "k2_launches": launches, "startup_s": loader.startup_s, "first_batch_s": times[0] if times else None,
          "images_per_s": n * BATCH / wall, "images_per_s_after_first": (n - 1) * BATCH / (wall - times[0]),
          "local_images_per_s": local_images_per_s,
          "loader_ms_per_batch": wall / n * 1e3, "wall_s": wall, "first_batch_vs_plain": check,
          "reading": "images_per_s beside (a)'s is a reading, not a gate"})
    if n != FRAMES // BATCH or launches != n:
        raise AssertionError(f"shards baseline: {n} batches, K2 launched {launches} times")
    if check["over_bar"]:
        raise AssertionError("shards baseline: K2 over the bar on the first batch")
    summary["dequant_normalize"]["launches"] += launches
    summary["dequant_normalize"].setdefault("launches_by_path", {})["shards baseline"] = launches


def within_tol(got: torch.Tensor, want: torch.Tensor, tols: dict = FA_TOL) -> dict:
    """|got - want| against ``tols[dtype]`` as atol and rtol, and bf16 ulps apart."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"shape/dtype {got.shape} {got.dtype} vs {want.shape} {want.dtype}")
    if not torch.isfinite(got.float()).all():
        raise AssertionError("non-finite output")
    tol = tols[got.dtype]
    err = (got.float() - want.float()).abs()
    row = {"max_abs_err": float(err.max()), "bar": f"atol=rtol={tol}",
           "over_bar": int((err > tol + tol * want.float().abs()).sum())}
    if got.dtype == torch.bfloat16:
        row["max_bf16_ulps"] = int(bf16_ulp_steps(got, want).max())
    return row


def causal_pairs(sq: int, skv: int, causal: bool) -> int:
    """(query, key) pairs the mask admits for one (batch, head): row i of q
    sees keys 0 .. i + skv - sq."""
    if not causal:
        return sq * skv
    return sq * (skv - sq + 1) + sq * (sq - 1) // 2


def k3_tiles(sq: int, skv: int, causal: bool, block_k: int, rows: int = 64, keys: int = 64) -> dict:
    """What the bf16 kernel's loop bounds give for one (batch, head): blocks
    of 64 query rows, 64-key sub-tiles loaded (K and V each) and multiplied
    by a warp of 16 rows, and the share of those on the diagonal (masked
    element by element)."""
    blocks = loaded = multiplied = diagonal = 0
    for q0 in range(0, sq, rows):
        blocks += 1
        last = min(q0 + rows, sq) - 1 + skv - sq
        n_sub = min(skv // keys, last // keys + 1) if causal else skv // keys
        steps = -(-n_sub // (block_k // keys))
        loaded += n_sub
        for w0 in range(q0, min(q0 + rows, sq), 16):
            first = w0 + skv - sq
            for sub in range(steps * (block_k // keys)):
                if sub < n_sub and (not causal or sub * keys <= first + 15):
                    multiplied += 1
                    diagonal += causal and sub * keys + keys - 1 > first
    return {"blocks": blocks, "kv_tiles_loaded": loaded, "warp_tiles": multiplied,
            "diagonal_share": diagonal / multiplied}


def restart_positions(b: int, s: int, gen: torch.Generator) -> torch.Tensor:
    """(b, s) int32 rows of two packed prompts each, the second restarting at
    0 after a seeded split; the last row repeats every position instead
    (0, 0, 1, 1, ...).  The index mask gets every row wrong."""
    rows = []
    for _ in range(b - 1):
        k = int(torch.randint(1, s, (1,), generator=gen))
        rows.append(torch.cat([torch.arange(k), torch.arange(s - k)]))
    rows.append(torch.arange(s) // 2)
    return torch.stack(rows).to(torch.int32)


def position_pairs(q_pos: torch.Tensor, kv_pos: torch.Tensor) -> int:
    """(query, key) pairs the position mask admits, summed over the batch."""
    return int((q_pos[:, :, None] >= kv_pos[:, None, :]).sum())


def library_attention(q, k, v, causal: bool):
    """One PyTorch call for the same function (the yardstick; never on the
    port's path).  SDPA's causal mask is top-left aligned, so it is timed
    only where sq == skv."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return lambda: sdpa(q, k, v, is_causal=causal, enable_gqa=True)


def phase_flash(dev: torch.device, summary: dict, card: str) -> None:
    """K3 against its plain version on the card, each case on the route its
    dtype picks (bf16: the tensor-core kernel; f32: the CUDA-core kernel);
    times at the serving shape for both routes, with each kernel's ptxas
    registers and spills."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cpu").manual_seed(1)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [  # name, b, h, hkv, sq, skv, hd, dtype, causal, block_q, block_k
        ("main", 8, 16, 8, SERVE_PROMPT, SERVE_PROMPT, 128, bf16, True, 128, 128),
        ("f32", 8, 16, 8, SERVE_PROMPT, SERVE_PROMPT, 128, f32, True, 128, 128),
        ("noncausal", 8, 16, 8, SERVE_PROMPT, SERVE_PROMPT, 128, bf16, False, 128, 128),
        ("right_aligned", 8, 16, 8, 128, SERVE_PROMPT, 128, bf16, True, 128, 128),
        ("mha_hd64", 4, 8, 8, 256, 256, 64, bf16, True, 128, 128),
        ("hd32", 2, 4, 2, 256, 256, 32, bf16, True, 128, 128),  # Qwen3's smoke heads
        ("block_k64", 8, 16, 8, SERVE_PROMPT, SERVE_PROMPT, 128, bf16, True, 64, 64),
        ("block_k128_gqa4", 2, 8, 2, 384, 384, 64, bf16, True, 128, 128),  # 3 steps of 128 keys
        ("ragged_rows", 1, 4, 2, 96, 192, 128, bf16, True, 32, 64),  # sq not a multiple of 64 rows
        ("f32_hd64", 2, 8, 2, 384, 384, 64, f32, False, 128, 64),
        ("granite", 8, 16, 8, SERVE_PROMPT, SERVE_PROMPT, 64, bf16, True, 128, 128),  # Granite-MoE's prefill
        ("musicgen", 8, 24, 24, SERVE_PROMPT, SERVE_PROMPT, 64, bf16, True, 128, 128),  # MusicGen's: MHA, groups of 1
        ("jamba", 2, 64, 8, 128, 128, 128, bf16, True, 128, 128),  # Jamba's model_check prefill
        # DeepSeek-V3's MLA prefill: 128 heads as kv groups of 1, q and k of
        # 128 + 64 rope dims, v of 128 zero-padded to 192
        ("mla", 8, 128, 128, SERVE_PROMPT, SERVE_PROMPT, 192, bf16, True, 128, 128),
        ("mla_f32", 8, 128, 128, SERVE_PROMPT, SERVE_PROMPT, 192, f32, True, 128, 128),
        ("mla_block_k64", 8, 128, 128, SERVE_PROMPT, SERVE_PROMPT, 192, bf16, True, 64, 64),  # no spills at 64
        ("mla_ragged_rows", 1, 16, 16, 96, 192, 192, bf16, True, 32, 64),  # sq not a multiple of 64 rows
        # the position route (q_pos >= kv_pos) on restart positions: Qwen3's serving shape on both
        # kernels, block_k 64, MLA's head dim, and rows past sq with keys padded at INT32_MAX
        ("pos_main", 8, 16, 8, SERVE_PROMPT, SERVE_PROMPT, 128, bf16, True, 128, 128),
        ("pos_f32", 8, 16, 8, SERVE_PROMPT, SERVE_PROMPT, 128, f32, True, 128, 128),
        ("pos_block_k64", 8, 16, 8, SERVE_PROMPT, SERVE_PROMPT, 128, bf16, True, 64, 64),
        ("pos_mla", 2, 16, 16, 256, 256, 192, bf16, True, 64, 64),
        ("pos_ragged_rows", 2, 4, 2, 96, 192, 128, bf16, True, 32, 64),
    ]
    ptxas = _build.ptxas("flash_attention")
    entry = summary["flash_attention"]
    for name, b, h, hkv, sq, skv, hd, dtype, causal, bq, bk in cases:
        q, k, v = (torch.randn(shape, generator=gen).to(dev, dtype)
                   for shape in ((b, h, sq, hd), (b, hkv, skv, hd), (b, hkv, skv, hd)))
        if "mla" in name:
            v[..., MLA_V_DIM:] = 0  # mla_prefill's zero padding of v
        kw = {"causal": causal, "block_q": bq, "block_k": bk}
        if name.startswith("pos"):
            kv_pos = restart_positions(b, skv, gen)
            q_pos = kv_pos[:, :sq].clone()
            if sq < skv:  # keys past the prompt padded as _causal_flash pads them
                kv_pos[:, sq:] = 2**31 - 1
            kw.update(q_pos=q_pos.to(dev), kv_pos=kv_pos.to(dev))
        got = fa.flash_attention(q, k, v, **kw)
        want = fa.flash_attention_plain(q, k, v, **kw)
        sync(dev)
        row = {"phase": "kernels", "kernel": "flash_attention", "case": name, "q": [b, h, sq, hd],
               "kv": [b, hkv, skv, hd], "dtype": str(dtype), "causal": causal, "block_q": bq, "block_k": bk,
               "route": fa.kernel_route(dtype, hd, bk), **within_tol(got, want)}
        entry["max_abs_err"] = max(entry["max_abs_err"], row["max_abs_err"])
        if row["over_bar"]:
            emit(row)
            raise AssertionError(f"flash_attention {name}: {row['over_bar']} elements over the bar")
        if "mla" in name and got[..., MLA_V_DIM:].any():
            raise AssertionError(f"flash_attention {name}: the zero-padded v's output columns are not zero")
        if name.startswith("pos"):
            row["positions"] = "restart (two packed prompts a row, seeded split), last row repeated"
        if name in ("main", "f32", "granite", "musicgen", "mla", "mla_f32", "mla_block_k64", "pos_main", "pos_f32"):
            row["ms"] = time_ms(lambda: fa.flash_attention(q, k, v, **kw), flush)
            nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, got, kw.get("q_pos"), kw.get("kv_pos"))
                         if t is not None)
            pairs = (position_pairs(kw["q_pos"].cpu(), kw["kv_pos"].cpu()) if "q_pos" in kw
                     else causal_pairs(sq, skv, causal) * b)
            ops = 4 * hd * pairs * h
            row.update(bound(nbytes, ops, BF16_TC_OPS_PER_S if dtype == bf16 else F32_OPS_PER_S, card))
        if name in ("pos_main", "pos_f32"):  # beside the index route on the same q, k, v
            index_kw = {key: kw[key] for key in ("causal", "block_q", "block_k")}
            row["index_ms"] = time_ms(lambda: fa.flash_attention(q, k, v, **index_kw), flush)
            row["over_index"] = row["ms"] / row["index_ms"]
            row["over_bound"] = row["ms"] / row["bound_ms"]
        if name == "pos_main":
            row["plain_ms"] = time_ms(lambda: fa.flash_attention_plain(q, k, v, **kw), flush)
            entry["by_position"] = {key: row[key] for key in ("ms", "index_ms", "plain_ms", "bound_ms", "bound_by")}
        if name == "pos_f32":
            entry["by_position"].update(f32_ms=row["ms"], f32_index_ms=row["index_ms"])
        if name in ("main", "granite", "musicgen", "mla"):
            row["plain_ms"] = time_ms(lambda: fa.flash_attention_plain(q, k, v, **kw), flush)
            if name == "mla":  # SDPA takes v's own 128 dims; its default scale is 1/sqrt(192), as K3's
                v_lib = v[..., :MLA_V_DIM].contiguous()
                row["library_ms"] = time_ms(library_attention(q, k, v_lib, causal), flush)
                row["library"] = "torch.nn.functional.scaled_dot_product_attention(is_causal=True) on v (8,128,512,128)"
            else:
                row["library_ms"] = time_ms(library_attention(q, k, v, causal), flush)
                row["library"] = "torch.nn.functional.scaled_dot_product_attention(is_causal=True, enable_gqa=True)"
            row["over_library"] = row["ms"] / row["library_ms"]
            row["over_bound"] = row["ms"] / row["bound_ms"]
        if name in ("granite", "musicgen", "mla"):
            entry[name] = {key: row[key] for key in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}
        if name == "musicgen":  # the instance its prefill runs
            instance = f"fa_tc_bf16<{hd},{bk // 64}>"
            row["ptxas"] = entry[name]["ptxas"] = {instance: ptxas.get(instance)}
        if name in ("mla_f32", "mla_block_k64"):
            entry["mla"][f"{name[4:]}_ms"] = row["ms"]
        if name == "main":
            row["ptxas"] = ptxas  # both kernels, each instantiation
            per_head = k3_tiles(sq, skv, causal, bk)
            staged = b * h * (per_head["kv_tiles_loaded"] * 2 * 64 * hd + sq * hd) * q.element_size()
            row["tiles"] = {**per_head, "staged_bytes": staged, "staged_tb_per_s": staged / row["ms"] * 1e-9,
                            "note": "blocks, kv_tiles_loaded and warp_tiles per (batch, head); staged_bytes: q and every K/V tile the blocks copy in, whole call"}
            entry.update({key: row[key] for key in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")})
        emit(row)


def ssd_inputs(gen, b, l, h, p, g, n, dtype, dev):
    """The reference sweep's distributions: x ~ N(0, 1), dt = softplus(N(0, 1)),
    a = -exp(N(0, 1) / 2), b and c ~ N(0, 0.3^2)."""
    x = torch.randn((b, l, h, p), generator=gen).to(dev, dtype)
    dt = torch.nn.functional.softplus(torch.randn((b, l, h), generator=gen)).to(dev)
    a = (-torch.exp(torch.randn(h, generator=gen) * 0.5)).to(dev)
    bm = (torch.randn((b, l, g, n), generator=gen) * 0.3).to(dev, dtype)
    cm = (torch.randn((b, l, g, n), generator=gen) * 0.3).to(dev, dtype)
    return x, dt, a, bm, cm


def ssd_ops(b: int, l: int, h: int, p: int, n: int, chunk: int) -> int:
    """Multiply-adds x 2 of the scan over the lower triangle of each chunk:
    C.B^T and S.x on the i >= j pairs, C.h^T and the state update whole."""
    pairs = chunk * (chunk + 1) // 2
    per_chunk = 2 * pairs * n + 2 * pairs * p + 2 * chunk * n * p + 2 * chunk * p * n
    return b * h * (l // chunk) * per_chunk


def phase_ssd(dev: torch.device, summary: dict, card: str) -> None:
    """K4 against its plain version on the card, each case on the route its
    dtype picks (bf16: the tensor-core kernel; f32: the CUDA-core kernel);
    times at the serving shape (Mamba2-780m, batch 8, prompt 512: chunk 256,
    48 heads of 64, one group of d_state 128) for both routes, with each
    kernel's ptxas registers and spills.  The ragged cases scan in the
    chunks ``models.ssm.scan_chunk`` picks for prompts of 40 and 300 tokens
    (40 and 4), neither a multiple of 16."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import ssd_scan as ks

    gen = torch.Generator(device="cpu").manual_seed(4)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    cases = [  # name, (b, l, h, p, g, n), chunk, dtype
        ("main", (SERVE_BATCH, SERVE_PROMPT, 48, 64, 1, 128), 256, torch.bfloat16),
        ("f32", (SERVE_BATCH, SERVE_PROMPT, 48, 64, 1, 128), 256, torch.float32),
        ("g2", (2, 256, 4, 64, 2, 32), 64, torch.bfloat16),
        ("g2_f32", (2, 256, 4, 64, 2, 32), 64, torch.float32),
        ("g4", (1, 256, 4, 64, 4, 128), 128, torch.bfloat16),
        ("g4_f32", (1, 256, 4, 64, 4, 128), 128, torch.float32),
        ("ragged_chunk40", (2, 40, 4, 64, 1, 128), 40, torch.bfloat16),
        ("ragged_chunk4", (2, 300, 4, 64, 1, 128), 4, torch.bfloat16),
        ("p48_n48", (1, 192, 3, 48, 1, 48), 96, torch.bfloat16),
        ("p16_n112_g2", (1, 300, 2, 16, 2, 112), 100, torch.bfloat16),
        ("jamba", (2, 128, 256, 64, 8, 128), 128, torch.bfloat16),  # Jamba's model_check prefill
    ]
    ptxas = _build.ptxas("ssd_scan")
    entry = summary["ssd_scan"]
    for name, shape, chunk, dtype in cases:
        args = ssd_inputs(gen, *shape, dtype, dev)
        y, h_final = ks.ssd_scan(*args, chunk=chunk)
        want_y, want_h = ks.ssd_scan_plain(*args, chunk=chunk)
        sync(dev)
        on_y, on_h = within_tol(y, want_y, SSD_TOL), within_tol(h_final, want_h, SSD_TOL)
        if dtype == torch.bfloat16:  # near 0 the ulps are many and atol decides: also count them above atol
            big = want_y.float().abs() >= SSD_TOL[dtype]
            on_y["max_bf16_ulps_above_atol"] = int(bf16_ulp_steps(y[big], want_y[big]).max()) if big.any() else 0
        row = {"phase": "kernels", "kernel": "ssd_scan", "case": name, "b_l_h_p_g_n": list(shape),
               "chunk": chunk, "dtype": str(dtype), "route": ks.kernel_route(dtype, shape[3], shape[5]),
               "y": on_y, "h_final": on_h, "max_abs_err": max(on_y["max_abs_err"], on_h["max_abs_err"])}
        entry["max_abs_err"] = max(entry["max_abs_err"], row["max_abs_err"])
        if on_y["over_bar"] or on_h["over_bar"]:
            emit(row)
            raise AssertionError(f"ssd_scan {name}: elements over the bar")
        if name in ("main", "f32"):
            b, l, h, p, g, n = shape
            row["ms"] = time_ms(lambda: ks.ssd_scan(*args, chunk=chunk), flush)
            nbytes = sum(t.numel() * t.element_size() for t in (*args, y, h_final))
            ops = ssd_ops(b, l, h, p, n, chunk)
            row.update(bound(nbytes, ops, BF16_TC_OPS_PER_S if dtype == torch.bfloat16 else F32_OPS_PER_S, card))
            row["over_bound"] = row["ms"] / row["bound_ms"]
        if name == "main":
            row["plain_ms"] = time_ms(lambda: ks.ssd_scan_plain(*args, chunk=chunk), flush)
            row["library_ms"] = None
            row["f32_cores_ms"] = ops / F32_OPS_PER_S * 1e3  # where products on the CUDA cores in f32 would stop
            row["ptxas"] = ptxas  # both kernels, each instantiation
            # batch 1: 48 blocks, fewer than the SMs, so this is one block's time (the
            # main case runs 384 blocks of one SM each in three waves)
            one = tuple(t[:1] if t.dim() > 1 else t for t in args)
            row["batch1_ms"] = time_ms(lambda: ks.ssd_scan(*one, chunk=chunk), flush)
            entry.update({key: row[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by")})
        emit(row)


def _rel_err(got: torch.Tensor, want: torch.Tensor, what: str) -> float:
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {tuple(got.shape)} vs {tuple(want.shape)}")
    got, want = got.float().cpu(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: non-finite values")
    return float((got - want).abs().max() / want.abs().max())


def condition_attention(cfg, params: dict) -> dict:
    """``params`` with each attention block's ``wq`` and ``wk`` scaled, in
    place, as if drawn at fan-in d_model: by sqrt(heads / d_model) and
    sqrt(kv_heads / d_model); and each MLA block's ``w_uq`` and ``w_uk``
    (the MTP block's too) as if drawn at fan-in over their latent rank: by
    sqrt(heads / q_lora_rank) and sqrt(heads / kv_lora_rank), for
    DeepSeek-V3 sqrt(128/1536) and sqrt(128/512).  The reference's init
    draws them with fan-in over the heads dim (16 and 8 for Granite, 128
    for DeepSeek), so without qk_norm a score has a wide spread (about 90
    for Granite) and attention is nearly one-hot: any rounding moves the
    weights of near-tied keys far, in the card's run and the CPU's alike,
    and a card-against-CPU check then measures that and not the port.  The
    checks compare the port with itself, so they run on weights where it
    is well conditioned."""
    h, kv, d = cfg.num_heads, cfg.num_kv_heads, cfg.d_model
    scale = {"wq": (h / d) ** 0.5, "wk": (kv / d) ** 0.5}
    if cfg.mla is not None:
        scale = {"w_uq": (h / cfg.mla.q_lora_rank) ** 0.5, "w_uk": (h / cfg.mla.kv_lora_rank) ** 0.5}
    mixers = [blk["mixer"] for seg in params["segments"] for blk in seg["blocks"]]
    if "mtp" in params:
        mixers.append(params["mtp"]["block"]["mixer"])
    for mixer in mixers:
        for name, factor in scale.items():
            if name in mixer:
                mixer[name].mul_(factor)
    return params


def conditioned_weights(cfg) -> str:
    if cfg.mla is not None:
        return "seed 0, w_uq/w_uk at fan-in q_lora_rank/kv_lora_rank (condition_attention)"
    return "seed 0, wq/wk at fan-in d_model (condition_attention)"


def moe_layers(cfg) -> int:
    return sum(is_moe for _, is_moe in cfg.layer_plan())


def prompt_batch(cfg, b: int, s: int, gen: torch.Generator) -> dict:
    """Seeded prefill inputs for ``cfg``: token ids (b, s), or (b, s,
    n_codebooks) codebook ids for MusicGen; a vision-prefix config also
    gets ``vis_embed`` (b, vis_prefix_len, d_model), bf16 N(0, 1), which
    the model splices over the first positions."""
    shape = (b, s, cfg.n_codebooks) if cfg.n_codebooks > 1 else (b, s)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, shape, generator=gen)}
    if cfg.vis_prefix_len:
        batch["vis_embed"] = torch.randn((b, cfg.vis_prefix_len, cfg.d_model), generator=gen).to(torch.bfloat16)
    return batch


def serve_run(model, params, batch: dict, forced, device, vocab: int, replay: list | None = None) -> dict:
    """A prefill of ``batch`` (``tokens``, and ``vis_embed`` for a
    vision-prefix config) then one decode step a row of ``forced`` on
    ``device``: the logits (vocab columns), the prefill cache (a copy), the
    final cache, and each MoE layer's router probabilities and expert
    choices in call order (``replay``: another run's choices to take)."""
    import route_check
    from repro_torch.tree import tree_map

    s, steps = batch["tokens"].shape[1], forced.shape[0]
    with route_check.RouteRecorder(replay) as routes:
        logits, cache = model.prefill(params, {k: v.to(device) for k, v in batch.items()}, seq_cap=s + steps)
        out = {"logits": [logits[..., :vocab]], "prefill_cache": tree_map(lambda t: t.clone(), cache)}
        for t in range(steps):
            logits, cache = model.decode_step(params, cache, forced[t].to(device), s + t)
            out["logits"].append(logits[..., :vocab])
    out["final_cache"], out["probs"], out["idx"] = cache, routes.probs, routes.idx
    return out


def output_errors(got: dict, want: dict) -> dict:
    """Each output of ``serve_run`` (logits, every cache entry), its
    largest |got - want| over the largest |want|."""
    worst: dict[str, float] = {}

    def note(what, g, w):
        worst[what] = max(worst.get(what, 0.0), _rel_err(g, w, what))

    for call, (g, w) in enumerate(zip(got["logits"], want["logits"])):
        note("prefill_logits" if call == 0 else "decode_logits", g, w)
    for when in ("prefill", "final"):
        for seg, want_seg in zip(got[f"{when}_cache"], want[f"{when}_cache"]):
            for blk, want_blk in zip(seg["blocks"], want_seg["blocks"]):
                for name in blk:
                    note(f"{when}_cache_{name}", blk[name], want_blk[name])
    return worst


def route_row(cfg, want: list, got: list, diffs: list | None = None) -> dict:
    """Every (token, MoE layer) whose choice differs between two runs'
    records (``diffs``, default ``route_check.compare`` of them), with the
    gap bar of the runs' dtype, and the largest difference of the two
    runs' router probabilities."""
    import route_check

    diffs = route_check.compare(cfg, want, got) if diffs is None else diffs
    row = route_check.summary(diffs, sum(p.shape[0] * p.shape[1] for p in want))
    row["swap_gap_bar"] = SWAP_GAP_F32 if cfg.dtype == "float32" else SWAP_GAP
    row["probs_max_abs_diff"] = max((float(np.abs(a - b).max()) for a, b in zip(want, got)), default=0.0)
    return row


def phase_model_check(dev: torch.device, arch: str, seq: int, phase: str = "model_check",
                      dtype: str | None = None, conditioned: bool = False, layers: int = 2,
                      restart: bool = False) -> None:
    """``arch`` at full width, ``layers`` layers (2 by default, for the CPU
    run's sake), in its own dtype or ``dtype``: the port on the card
    against the same model and weights on the CPU, prefill of ``seq``
    tokens (``prompt_batch``: MusicGen's (2, seq, 4) codebook ids,
    InternVL2's vision prefix over the first 256 of them) then 4 forced
    decode steps, logits and every cache entry (k/v of attention blocks, the ssm
    state and conv window of SSD blocks), each within MODEL_REL (bf16) or
    TRAIN_F32_REL (f32, TF32 off) of its largest CPU value.  The card's
    prefill launches one kernel a layer, K3 for attention and K4 for SSD,
    counted (MLA's prefill is K3 too).  With ``conditioned`` the seed-0
    weights go through ``condition_attention`` first, on both sides.

    MoE layers route discretely (``tools/route_check.py``): the CPU runs
    first and records each layer's expert choices, and the card replays
    them, so a near-tie that rounding breaks the other way cannot move
    other tokens' outputs.  The card's own choices are compared with the
    CPU's and every (token, layer) that differs is printed with the CPU's
    gap between its k-th and (k+1)-th probability: a swap at a gap over
    SWAP_GAP (bf16) or SWAP_GAP_F32 (f32) fails.

    With ``restart`` the prompts carry ``restart_positions``, which RoPE
    rotates by and K3 masks by (its position route)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention, ssd_scan
    from repro_torch.models import Model
    from repro_torch.tree import tree_map

    cfg = dataclasses.replace(get_config(arch), num_layers=layers, **({"dtype": dtype} if dtype else {}))
    bar = TRAIN_F32_REL if cfg.dtype == "float32" else MODEL_REL
    model = Model(cfg)
    b, s, steps = 2, seq, 4
    rng = torch.Generator(device="cpu").manual_seed(2)
    batch = prompt_batch(cfg, b, s, rng)
    if restart:
        batch["positions"] = restart_positions(b, s, rng)
    forced = torch.randint(0, cfg.vocab_size, (steps, *batch["tokens"][:, :1].shape), generator=rng)
    t0 = time.monotonic()
    with torch.inference_mode():
        params = model.init(seed=0, device=dev)
        if conditioned:
            condition_attention(cfg, params)
        host_params = tree_map(lambda t: t.cpu(), params)
        cpu = serve_run(model, host_params, batch, forced, torch.device("cpu"), cfg.vocab_size)
        del host_params
        cpu_s = time.monotonic() - t0
        _zero_kernel_launches()
        card = serve_run(model, params, batch, forced, dev, cfg.vocab_size, cpu["idx"] if moe_layers(cfg) else None)
        sync(dev)
        launches = {"flash_attention": flash_attention.flash_attention.launches,
                    "ssd_scan": ssd_scan.ssd_scan.launches}
        del params
        worst = output_errors(card, cpu)
    row = {"phase": phase, "arch": cfg.name, "layers": cfg.num_layers, "d_model": cfg.d_model,
           "batch": b, "seq": s, "decode_steps": steps, "dtype": cfg.dtype, "prefill_launches": launches,
           "weights": conditioned_weights(cfg) if conditioned else "seed 0",
           **({"positions": "restart_positions: two packed prompts a row, the last row repeated"} if restart else {}),
           "params": model.param_count(), "max_rel_err_vs_cpu": worst,
           "bar": f"max |card - cpu| <= {bar} * max |cpu|", "cpu_seconds": cpu_s, "seconds": time.monotonic() - t0}
    if moe_layers(cfg):
        row["routes"] = route_row(cfg, cpu["probs"], card["probs"])
        row["routes"]["note"] = "the card replays the CPU's choices; these are the card's own that differ"
    emit(row)
    over = {k: v for k, v in worst.items() if v > bar}
    if over:
        raise AssertionError(f"{phase} {arch} over the bar: {over}")
    if moe_layers(cfg) and row["routes"]["max_swap_gap"] > row["routes"]["swap_gap_bar"]:
        raise AssertionError(f"{phase} {arch}: a route swapped at a gap of {row['routes']['max_swap_gap']}")
    kinds = [kind for kind, _ in cfg.layer_plan()]
    want_launches = {"flash_attention": kinds.count("attn") + kinds.count("mla"), "ssd_scan": kinds.count("ssd")}
    if launches != want_launches:
        raise AssertionError(f"{phase} {arch}: the prefill launched {launches}, expected {want_launches}")


def moe_grad_check(cfg, host_p: dict, card_p: dict, x: torch.Tensor, routes: list) -> dict:
    """The gradients of sum(y * dy) + aux by x and each expert leaf, the
    card (replaying ``routes``) against the CPU: each leaf's largest
    difference over its largest |CPU value|."""
    import route_check
    from repro_torch.models import moe

    dy = torch.randn(x.shape, generator=torch.Generator().manual_seed(8))
    grads = {}
    for where, p in (("cpu", host_p), ("card", card_p)):
        dev = p["router"].device
        leaves = {"x": x.to(dev).requires_grad_(), **{k: v.detach().requires_grad_() for k, v in p.items()}}
        with route_check.RouteRecorder(routes if where == "card" else None):
            y, aux = moe.apply_moe(cfg, {k: v for k, v in leaves.items() if k != "x"}, leaves["x"])
            g = torch.autograd.grad((y * dy.to(dev)).sum() + aux, list(leaves.values()))
        grads[where] = dict(zip(leaves, g))
    return {k: _rel_err(grads["card"][k], grads["cpu"][k], k) for k in grads["cpu"]}


def phase_moe(dev: torch.device, card: str) -> None:
    """``apply_moe`` at Granite-MoE-1B-A400M's prefill shape (batch 8,
    prompt 512: x (8, 512, 1024), 32 experts, top 8, capacity 160), seeded
    weights and input, on the card against the same call on the CPU, the
    card replaying the CPU's expert choices (``phase_model_check`` says
    why).  f32 with TF32 off: y within TRAIN_F32_REL of its largest value,
    aux within 1e-6 of its value.  bf16: y within MODEL_REL.  Every
    (token) whose own choice on the card differs is printed; a swap at a gap
    over SWAP_GAP_F32 (f32) or SWAP_GAP (bf16) fails.  f32 also holds the
    gradients of x and every expert leaf within TRAIN_F32_REL.
    One prefill-shaped and one decode-shaped (x (8, 1, 1024), capacity 4)
    call run under ``torch.cuda.set_sync_debug_mode("error")``: any host
    sync in the layer fails the phase.  Readings: ms a call, the expert
    products' FLOPs and their bound on the bf16 tensor cores, the dispatch
    buffer's bytes."""
    from repro_torch.configs import get_config
    import route_check
    from repro_torch.models import moe
    from repro_torch.models.params import init_params
    from repro_torch.tree import tree_map

    base = get_config("granite-moe-1b-a400m")
    m = base.moe
    b, s, d = SERVE_BATCH, SERVE_PROMPT, base.d_model
    cap = moe.capacity_per_seq(base, s)
    x32 = torch.randn((b, s, d), generator=torch.Generator().manual_seed(7))
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    row = {"phase": "moe", "arch": base.name, "x": [b, s, d], "experts": m.n_experts, "top_k": m.experts_per_token,
           "d_expert": m.d_expert, "capacity": cap}
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(base, dtype=dtype)
        host_p = init_params(moe.moe_defs(cfg), seed=7, device="cpu")
        card_p = tree_map(lambda t: t.to(dev), host_p)
        x = x32.to(torch.bfloat16 if dtype == "bfloat16" else torch.float32)
        with torch.inference_mode():
            with route_check.RouteRecorder() as want_routes:
                want_y, want_aux = moe.apply_moe(cfg, host_p, x)
            with route_check.RouteRecorder(replay=want_routes.idx) as got_routes:
                y, aux = moe.apply_moe(cfg, card_p, x.to(dev))
        diffs = route_check.differences(cfg, want_routes.probs[0], got_routes.probs[0])
        res = {**route_row(cfg, want_routes.probs, got_routes.probs, diffs), "y_rel_err": _rel_err(y, want_y, "y"),
               "aux": {"card": float(aux), "cpu": float(want_aux)}}
        if dtype == "float32":
            res["grad_rel_err"] = moe_grad_check(cfg, host_p, card_p, x, want_routes.idx)
        row[dtype] = res
        aux_ok = dtype == "bfloat16" or abs(float(aux) - float(want_aux)) <= 1e-6 * abs(float(want_aux))
        if dtype == "float32" and max(res["grad_rel_err"].values()) > TRAIN_F32_REL:
            aux_ok = False
        if (res["y_rel_err"] > (TRAIN_F32_REL if dtype == "float32" else MODEL_REL) or not aux_ok
                or res["max_swap_gap"] > res["swap_gap_bar"]):
            emit(row)
            raise AssertionError(f"moe {dtype}: card against CPU over the bar")
    x = x32.to(dev, torch.bfloat16)
    sync(dev)
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.inference_mode():
            moe.apply_moe(cfg, card_p, x)
            moe.apply_moe(cfg, card_p, x[:, :1])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    row["host_syncs"] = "none: a prefill- and a decode-shaped call under set_sync_debug_mode('error')"
    with torch.inference_mode():
        row["ms"] = time_ms(lambda: moe.apply_moe(cfg, card_p, x), flush)
    flops = 2 * b * m.n_experts * cap * d * m.d_expert * 3
    row["expert_flops"] = flops
    row["expert_tc_bound_ms"] = flops / BF16_TC_OPS_PER_S * 1e3
    row["dispatch_bytes"] = b * m.n_experts * cap * d * x.element_size()
    row.update({"card": card, "peaks_for": PEAKS_FOR,
                "reading": "ms, expert_flops and dispatch_bytes are readings; bf16 is the config's dtype"})
    emit(row)


def serve_prompts(n: int) -> list[str]:
    """n seeded prompts of 400-700 printable ASCII bytes."""
    gen = torch.Generator(device="cpu").manual_seed(3)
    out = []
    for _ in range(n):
        size = int(torch.randint(400, 701, (1,), generator=gen))
        out.append(bytes(torch.randint(32, 127, (size,), generator=gen).tolist()).decode())
    return out


def trace_step(dev: torch.device, fn, kernel_symbol: str) -> dict:
    """One call of ``fn`` under ``torch.profiler``, the card's activity only:
    the card's busy time (the sum of its kernels' times), the named kernel's
    share, and the top five."""
    from torch.profiler import ProfilerActivity, profile

    sync(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        sync(dev)
    on_card = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    mine = [e for e in on_card if kernel_symbol in e.key]
    top = sorted(on_card, key=lambda e: -e.self_device_time_total)[:5]
    return {"device_busy_ms": sum(e.self_device_time_total for e in on_card) / 1e3,
            "kernel_ms": sum(e.self_device_time_total for e in mine) / 1e3,
            "kernel_launches": sum(e.count for e in mine), "device_launches": sum(e.count for e in on_card),
            "top_kernels": [[e.key[:80], e.self_device_time_total / 1e3, e.count] for e in top]}


def greedy(prefill, decode, params, batch: dict) -> list[list]:
    """``BatchServer._generate_batch``'s loop on one batch through the step
    functions: a prefill, then SERVE_NEW greedy decode steps (argmax over
    the last dim, first index on ties; a multi-codebook config feeds its
    (B, n_codebooks) ids back as (B, 1, n_codebooks)); each row's ids."""
    logits, cache = prefill(params, batch, seq_cap=SERVE_PROMPT + SERVE_NEW)
    cur = logits.argmax(dim=-1)
    steps = []
    for t in range(SERVE_NEW):
        steps.append(cur)
        logits, cache = decode(params, cache, cur[:, None], SERVE_PROMPT + t)
        cur = logits.argmax(dim=-1)
    return torch.stack(steps, dim=1).cpu().tolist()  # one sync per batch


def phase_serve(dev: torch.device, summary: dict, arch: str, kernel: str, kernel_symbol: str,
                layers: int | None = None) -> None:
    """The serving path at full width and depth (or cut to ``layers``),
    seed-initialized on the card, two prefill batches of SERVE_BATCH;
    ``kernel`` is the one its prefill launches once a layer
    (``kernel_symbol`` in its CUDA name), and every batch must launch it
    exactly once a layer.  ``BatchServer`` serves byte prompts; MusicGen
    (codebook ids) and InternVL2 (a vision prefix), which it cannot take,
    run ``build_prefill_step`` and ``build_decode_step`` in its greedy
    loop (``greedy``) on ``prompt_batch`` inputs of SERVE_PROMPT tokens.
    Each step's host time to enqueue is kept beside its time to finish, and
    one more prefill and decode step run under the profiler."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import flash_attention, ssd_scan
    from repro_torch.launch.steps import build_decode_step, build_prefill_step
    from repro_torch.models import Model
    from repro_torch.runtime import BatchServer
    from repro_torch.tree import tree_leaves

    wrapper = {"flash_attention": flash_attention.flash_attention, "ssd_scan": ssd_scan.ssd_scan}[kernel]
    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    model = Model(cfg)
    params = model.init(seed=0, device=dev)
    times: dict[str, list[float]] = {"prefill": [], "decode": [], "prefill_enqueue": [], "decode_enqueue": []}
    finite, batch_launches = [], []

    def timed(fn, key):
        def run(*args, **kwargs):
            sync(dev)
            before = wrapper.launches
            t0 = time.perf_counter()
            logits, cache = fn(*args, **kwargs)
            times[key + "_enqueue"].append((time.perf_counter() - t0) * 1e3)
            sync(dev)
            times[key].append((time.perf_counter() - t0) * 1e3)
            finite.append(bool(torch.isfinite(logits).all()))
            if key == "prefill":
                batch_launches.append(wrapper.launches - before)
            return logits, cache
        return run

    batches = -(-SERVE_PROMPTS // SERVE_BATCH)
    prefill_step = build_prefill_step(cfg, ShapeConfig("serve", SERVE_PROMPT, SERVE_BATCH, "prefill"), dev).fn
    decode_step = build_decode_step(cfg, ShapeConfig("serve_d", SERVE_PROMPT + SERVE_NEW, SERVE_BATCH, "decode"),
                                    dev).fn
    gen = torch.Generator().manual_seed(5)
    by_steps = cfg.n_codebooks > 1 or bool(cfg.vis_prefix_len)
    if by_steps:
        inputs = [prompt_batch(cfg, SERVE_BATCH, SERVE_PROMPT, gen) for _ in range(batches)]
        trace_batch = inputs[0]
        request = {"served_by": "build_prefill_step, build_decode_step in BatchServer's greedy loop",
                   "inputs": {k: [list(v.shape), str(v.dtype)] for k, v in trace_batch.items()}}
        prefill, decode = timed(prefill_step, "prefill"), timed(decode_step, "decode")
        requests = batches * SERVE_BATCH
        generate = lambda: [ids for batch in inputs for ids in greedy(prefill, decode, params, batch)]  # noqa: E731
    else:
        server = BatchServer(cfg, params, batch_size=SERVE_BATCH, prompt_len=SERVE_PROMPT,
                             max_new=SERVE_NEW, device=dev)
        server.prefill = timed(server.prefill, "prefill")
        server.decode = timed(server.decode, "decode")
        prompts = serve_prompts(SERVE_PROMPTS)
        trace_batch = {"tokens": torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT), generator=gen)}
        request = {"served_by": "BatchServer", "prompts": len(prompts),
                   "prompt_bytes": [min(map(len, prompts)), max(map(len, prompts))]}
        requests = len(prompts)
        generate = lambda: [r.token_ids for r in server.generate(prompts)]  # noqa: E731
    wrapper.launches = 0
    t0 = time.monotonic()
    results = generate()
    wall = time.monotonic() - t0
    launches = wrapper.launches
    held = {}

    def prefill_once():
        held["logits"], held["cache"] = prefill_step(params, trace_batch, seq_cap=SERVE_PROMPT + SERVE_NEW)

    prefill_trace = trace_step(dev, prefill_once, kernel_symbol)
    cur = held["logits"].argmax(dim=-1)[:, None]
    decode_trace = trace_step(dev, lambda: decode_step(params, held["cache"], cur, SERVE_PROMPT), kernel_symbol)
    param_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    cache_bytes = sum(
        math.prod(shape) * dt.itemsize
        for seg in model.cache_spec(SERVE_BATCH, SERVE_PROMPT + SERVE_NEW)
        for blk in seg["blocks"] for shape, dt in blk.values()
    )
    emit({"phase": "serve", "arch": cfg.name, "layers": cfg.num_layers, "d_model": cfg.d_model,
          "params": model.param_count(), "dtype": cfg.dtype, "batch": SERVE_BATCH,
          "prompt_len": SERVE_PROMPT, "max_new": SERVE_NEW, **request, "prefill_batches": batches,
          "kernel": kernel, "launches": launches, "launches_per_batch": batch_launches, "results": len(results),
          "tokens_per_result": sorted({len(ids) for ids in results}), "all_logits_finite": all(finite),
          "reading": "the timings and bytes below are readings, not gates",
          "prefill_ms_per_batch": times["prefill"], "prefill_enqueue_ms_per_batch": times["prefill_enqueue"],
          "decode_ms_per_token": statistics.median(times["decode"]),
          "decode_enqueue_ms_per_token": statistics.median(times["decode_enqueue"]),
          "prefill_trace": prefill_trace, "decode_trace": decode_trace,
          "trace_note": "one more prefill and decode step under torch.profiler: device_busy_ms sums the card's kernel times",
          "card_busy_share": {"prefill": prefill_trace["device_busy_ms"] / min(times["prefill"]),
                              "decode": decode_trace["device_busy_ms"] / statistics.median(times["decode"]),
                              "note": "traced busy ms over the untraced step's wall ms (prefill: the faster batch)"},
          "generated_tokens_per_s": sum(len(ids) for ids in results) / wall, "wall_s": wall,
          "param_bytes": param_bytes, "cache_bytes": cache_bytes})
    if batch_launches != [cfg.num_layers] * batches:
        raise AssertionError(f"{kernel} launched {batch_launches} times in {batches} prefill batches of "
                             f"{cfg.num_layers} layers")
    # the profiler may drop a few of a step's ~2,800 kernel records, so the
    # exact count is the wrapper's (above); the trace must show the kernel
    if prefill_trace["kernel_launches"] < 1 or prefill_trace["kernel_ms"] <= 0:
        raise AssertionError(f"the traced prefill shows no launch of {kernel_symbol}")
    if len(results) != requests or any(len(ids) != SERVE_NEW for ids in results):
        raise AssertionError("a request did not get its tokens")
    if not all(finite):
        raise AssertionError("non-finite logits")
    summary[kernel]["launches"] += launches
    summary[kernel].setdefault("launches_by_path", {})[f"serve {cfg.name}"] = launches


def _kernel_launches() -> dict:
    from repro_torch.kernels import dequant_normalize, flash_attention, ssd_scan

    return {"dequant_normalize_augment": dequant_normalize.dequant_normalize_augment.launches,
            "dequant_normalize": dequant_normalize.dequant_normalize.launches,
            "flash_attention": flash_attention.flash_attention.launches,
            "ssd_scan": ssd_scan.ssd_scan.launches}


def _zero_kernel_launches() -> None:
    from repro_torch.kernels import dequant_normalize, flash_attention, ssd_scan

    for wrapper in (dequant_normalize.dequant_normalize_augment, dequant_normalize.dequant_normalize,
                    flash_attention.flash_attention, ssd_scan.ssd_scan):
        wrapper.launches = 0


def packed_batch(vocab: int, b: int, s: int, seed: int) -> dict:
    """b packed rows of s tokens from seeded documents of 64-400 tokens:
    positions restart and segment ids count per document."""
    from repro_torch.data.packing import SequencePacker, collate

    rng = np.random.default_rng(seed)
    packer, rows = SequencePacker(s), []
    while len(rows) < b:
        rows += packer.add(rng.integers(0, vocab, int(rng.integers(64, 401)), dtype=np.int32))
    return collate(rows[:b])


def train_batch(cfg, b: int, s: int, seed: int) -> dict:
    """``packed_batch`` for ``cfg``.  MusicGen: tokens and labels (b, s, 4),
    the packed ids in codebook 0 beside seeded ids in the other three,
    whose labels are the next position's ids, masked where the packed
    labels are.  InternVL2: ``vis_embed`` (b, 256, d_model), bf16 N(0, 1),
    with the labels over the prefix masked, as ``tests/test_arch_smoke.py``
    does."""
    batch = packed_batch(cfg.vocab_size, b, s, seed)
    if cfg.n_codebooks > 1:
        rng = np.random.default_rng(seed + 1)
        tokens, labels = batch["tokens"][..., None], batch["labels"][..., None]
        more = rng.integers(0, cfg.vocab_size, (b, s, cfg.n_codebooks - 1), dtype=tokens.dtype)
        batch["tokens"] = np.concatenate([tokens, more], axis=-1)
        batch["labels"] = np.concatenate([labels, np.where(labels >= 0, np.roll(more, -1, axis=1), -1)], axis=-1)
    if cfg.vis_prefix_len:
        gen = torch.Generator().manual_seed(seed + 1)
        batch["vis_embed"] = torch.randn((b, cfg.vis_prefix_len, cfg.d_model), generator=gen).to(torch.bfloat16)
        batch["labels"][:, :cfg.vis_prefix_len] = -1
    return batch


def one_train_step(cfg, dev: torch.device, params: dict, batch: dict, replay: list | None = None):
    """One ``build_train_step`` step of ``cfg`` on ``dev`` from ``params``:
    its metrics, the gradient leaves it applied (read from its call of
    ``apply_update``, which only reads them; on the host, copied there from
    the card) and its MoE layers' route records in call order (the
    forward pass, then each layer's recompute in the backward pass), taking
    the expert choices of ``replay`` if given."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import steps
    import route_check
    from repro_torch.optim import init_opt_state
    from repro_torch.tree import tree_leaves

    rows, seq = batch["tokens"].shape[:2]
    bundle = steps.build_train_step(cfg, ShapeConfig("check", seq, rows, "train"), grad_accum=1, device=dev)
    seen = []
    real_update = steps.apply_update

    def update(opt_cfg, params, grads, state):
        seen.extend(g.detach().cpu() for g in tree_leaves(grads))
        return real_update(opt_cfg, params, grads, state)

    steps.apply_update = update
    try:
        with route_check.RouteRecorder(replay) as routes:
            _, _, metrics = bundle.fn(params, init_opt_state(bundle.opt_cfg, params), batch)
    finally:
        steps.apply_update = real_update
    return {k: float(v) for k, v in metrics.items()}, seen, routes


def train_route_differences(cfg, want: list, got: list) -> list[dict]:
    """The forward pass's (token, layer) pairs whose own expert choice
    differs between two steps' records, with the experts (and so the expert
    weight leaves) they would have touched differently."""
    import route_check
    from repro_torch.models import moe

    moe_layers = [i for i, (_, is_moe) in enumerate(cfg.layer_plan()) if is_moe]
    out = []
    for pw, pg, layer in zip(want, got, moe_layers):  # the forward pass's records come first
        cap, k = moe.capacity_per_seq(cfg, pw.shape[1]), cfg.moe.experts_per_token
        kw, kg = route_check.kept_experts(pw, k, cap), route_check.kept_experts(pg, k, cap)
        for diff in route_check.differences(cfg, pw, pg, layer=layer):
            experts = np.nonzero(kw[diff.row, diff.token] != kg[diff.row, diff.token])[0].tolist()
            out.append({**dataclasses.asdict(diff), "experts": experts,
                        "leaves": f"layer {layer} ffn w_gate, w_up, w_down [experts {experts}]"})
    return out


def phase_train_check(dev: torch.device, arch: str, conditioned: bool = False,
                      seq: int = CHECK_SEQ, rows: int = CHECK_BATCH) -> None:
    """One training step of ``arch`` at full width, 2 layers (and the MTP
    block where the config has one), on the card against the same step on
    the CPU from the same parameters (``Model.init(0)`` on the CPU, copied;
    with ``conditioned`` through ``condition_attention`` first) and one
    seeded packed batch of ``rows`` rows of ``seq`` tokens (``train_batch``:
    MusicGen's four codebooks, InternVL2's vision prefix): the loss (and the
    MTP loss beside it), the global gradient norm and each gradient leaf's
    largest difference over its largest |value|, in two checks.

    f32 (the config at ``dtype="float32"``, TF32 off): every one of them
    within 1e-4, the bar the CPU tests hold the port's f32 gradients to
    against the reference.  A wrong rounding or a dropped term fails here.

    bf16 (the config as it trains): loss and grad norm within 2e-2.  A bf16
    gradient is only as good as bf16's rounding, which moves the CPU's own
    bf16 gradient 1-4% of the largest value off its f32 one; two bf16 runs
    differ by about 1.4x that.  So a leaf is held, on the card, to the CPU's
    f32 gradient of the same step: within 2e-2 or within 1.5x the CPU's own
    bf16 rounding of that leaf, whichever is larger; its difference from the
    CPU's bf16 leaf is reported beside it.  None of the steps launches any
    of K1-K4.

    MoE configs: the CPU's bf16 step runs first and records each layer's
    expert choices, and the CPU's f32 step and both card steps replay them
    (``phase_model_check`` says why), so every gradient compared, the f32
    one that bf16 leaves are held to included, is taken on the same
    routes; each step's own choices that differ from the CPU's in its dtype
    are printed with the expert leaves they would reach, a swap at a gap
    over SWAP_GAP (bf16) or SWAP_GAP_F32 (f32) fails, and the f32 aux loss
    must be non-zero and within 1e-4 of the CPU's."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.tree import tree_items, tree_map

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("train_check needs TF32 off: torch.backends.cuda.matmul.allow_tf32 is set")
    cfg = dataclasses.replace(get_config(arch), num_layers=2)
    f32 = dataclasses.replace(cfg, dtype="float32")
    t0 = time.monotonic()
    host = Model(cfg).init(seed=0, device="cpu")
    if conditioned:
        condition_attention(cfg, host)
    batch = train_batch(cfg, rows, seq, seed=6)
    has_moe = moe_layers(cfg) > 0
    cpu_m, cpu_g, cpu_r = one_train_step(cfg, torch.device("cpu"), tree_map(lambda t: t.clone(), host), batch)
    routes = cpu_r.idx if has_moe else None  # the CPU bf16 step's expert choices, replayed by the other three
    cpu32_m, f32_g, cpu32_r = one_train_step(
        f32, torch.device("cpu"), tree_map(lambda t: t.to(torch.float32, copy=True), host), batch, routes)
    cpu_s = time.monotonic() - t0
    _zero_kernel_launches()
    card_m, card_g, card_r = one_train_step(cfg, dev, tree_map(lambda t: t.to(dev, copy=True), host), batch, routes)
    card32_m, card32_g, card32_r = one_train_step(
        f32, dev, tree_map(lambda t: t.to(dev, torch.float32, copy=True), host), batch, routes)
    sync(dev)
    launches = _kernel_launches()
    names = [k for k, _ in tree_items(host)]
    leaves, over = {}, {}
    for name, g, want, w32 in zip(names, card_g, cpu_g, f32_g):
        own = float((want.float() - w32).abs().max() / w32.abs().max())
        leaves[name] = {"rel_err": _rel_err(g, want, name), "vs_cpu_f32": _rel_err(g, w32, name),
                        "cpu_bf16_vs_f32": own}
        if leaves[name]["vs_cpu_f32"] > max(MODEL_REL, OWN_ROUNDING * own):
            over[name] = leaves[name]
    leaves32 = {name: _rel_err(g, want, name) for name, g, want in zip(names, card32_g, f32_g)}
    mtp = ("loss_mtp",) if cfg.mtp else ()
    scalars = {k: abs(card_m[k] - cpu_m[k]) / abs(cpu_m[k]) for k in ("loss", "grad_norm", *mtp)}
    scalar_names = ("loss", "grad_norm", *mtp, *(("aux",) if has_moe else ()))
    scalars32 = {k: abs(card32_m[k] - cpu32_m[k]) / abs(cpu32_m[k]) for k in scalar_names}
    over.update({f"f32 {k}": v for k, v in leaves32.items() if v > TRAIN_F32_REL})
    moe_row = {}
    if has_moe:  # the aux loss, and every route the two steps took differently
        moe_row = {"aux": {"card": card_m["aux"], "cpu": cpu_m["aux"], "card_f32": card32_m["aux"],
                           "cpu_f32": cpu32_m["aux"]},
                   "routes": {"bf16": train_route_differences(cfg, cpu_r.probs, card_r.probs),
                              "f32": train_route_differences(f32, cpu32_r.probs, card32_r.probs),
                              "records": len(card_r.probs), "pairs_a_record": rows * seq,
                              "f32_probs_max_abs_diff": max(float(np.abs(a - b).max())
                                                            for a, b in zip(cpu32_r.probs, card32_r.probs)),
                              "note": "every step replays the CPU bf16 step's choices; these are the forward "
                                      "pass's own choices on the card that differ from the CPU's in its dtype, "
                                      "with the expert leaves they would reach"}}
        if not card32_m["aux"] > 0:
            over["f32 aux"] = moe_row["aux"]
        for name, gap_bar in (("bf16", SWAP_GAP), ("f32", SWAP_GAP_F32)):
            if max((r["gap"] for r in moe_row["routes"][name] if r["kind"] == "swap"), default=0.0) > gap_bar:
                over[f"{name} route swapped at a gap over {gap_bar}"] = moe_row["routes"][name]
    emit({"phase": "train_check", "arch": cfg.name, "layers": cfg.num_layers, "mtp": cfg.mtp, "d_model": cfg.d_model,
          "params": Model(cfg).param_count(), "batch": rows, "seq": seq, "dtype": cfg.dtype,
          "weights": conditioned_weights(cfg) if conditioned else "seed 0",
          "documents_in_batch": int(batch["segment_ids"].max()) + 1,
          **{k: {"card": card_m[k], "cpu": cpu_m[k]} for k in ("loss", "grad_norm", *mtp)},
          "rel_err": scalars, "max_leaf_rel_err": max(v["rel_err"] for v in leaves.values()),
          "leaves": leaves, "bar": f"loss, grad_norm (loss_mtp): card vs cpu <= {MODEL_REL}; a leaf: vs_cpu_f32 <= "
          f"max({MODEL_REL}, {OWN_ROUNDING} x cpu_bf16_vs_f32), of the largest |cpu value|",
          "f32": {**{k: {"card": card32_m[k], "cpu": cpu32_m[k]} for k in ("loss", "grad_norm", *mtp)},
                  "rel_err": scalars32, "max_leaf_rel_err": max(leaves32.values()), "leaves": leaves32,
                  "bar": f"loss, grad_norm (loss_mtp, aux) and every leaf: card vs cpu <= {TRAIN_F32_REL} of "
                  "the largest |cpu value|, TF32 off"},
          **moe_row, "kernel_launches": launches, "cpu_seconds": cpu_s, "seconds": time.monotonic() - t0})
    if any(v > MODEL_REL for v in scalars.values()) or any(v > TRAIN_F32_REL for v in scalars32.values()) or over:
        raise AssertionError(f"train_check {arch} over the bar: {scalars} {scalars32} {over}")
    if any(launches.values()):
        raise AssertionError(f"train_check {arch} launched a kernel: {launches}")


def phase_train(dev: torch.device, arch: str, steps: int, resume: bool, trace: bool = True) -> None:
    """The training path at full width and depth: ``build_lm_loader`` on the
    card feeding ``Trainer.fit`` on ``arch``, seed-0 weights, seq 4096,
    global batch 8 at the config's own ``grad_accum["train_4k"]``.  Each
    step's time runs to its end on the card.  With ``resume`` a checkpoint
    is saved at step ``TRAIN_CKPT_AT``, and a fresh ``Trainer.from_checkpoint``
    must restore the parameters and optimizer state bit for bit, the step and the
    sampler, then take 2 steps.  With ``trace`` one more step runs under
    the profiler (at 130-280 K kernel launches a step it takes 40-80 s).
    K1-K4 must not launch."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import CheckpointableSampler, SyntheticTokenDataset, build_lm_loader
    from repro_torch.runtime import Trainer, TrainerConfig
    from repro_torch.tree import tree_items, tree_map

    cfg = get_config(arch)
    shape = ShapeConfig("train_4k", TRAIN_SEQ, TRAIN_BATCH, "train")
    accum = cfg.grad_accum["train_4k"]
    step_ms: list[float] = []
    row: dict = {"phase": "train", "arch": cfg.name, "layers": cfg.num_layers, "d_model": cfg.d_model,
                 "vocab": cfg.vocab_size, "dtype": cfg.dtype, "seq": TRAIN_SEQ, "global_batch": TRAIN_BATCH,
                 "grad_accum": accum, "microbatch": TRAIN_BATCH // accum, "steps": steps, "remat": cfg.remat}

    def loader():
        ds = SyntheticTokenDataset(10_000, vocab=cfg.vocab_size)
        sampler = CheckpointableSampler(len(ds), batch_size=8, seed=0)
        return build_lm_loader(ds, seq_len=TRAIN_SEQ, batch_size=TRAIN_BATCH, sampler=sampler, device=dev)

    def timed(fn):
        def run(*args):
            sync(dev)
            t0 = time.perf_counter()
            out = fn(*args)
            sync(dev)
            step_ms.append((time.perf_counter() - t0) * 1e3)
            return out
        return run

    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as d:
        tcfg = TrainerConfig(ckpt_dir=d, ckpt_every=TRAIN_CKPT_AT if resume else 10**9, ckpt_keep=1, log_every=1)
        t0 = time.monotonic()
        trainer = Trainer(cfg, shape, tcfg=tcfg, device=dev)
        row["params"] = trainer.model.param_count()
        row["state_bytes"] = sum(t.numel() * t.element_size()
                                 for _, t in tree_items({"p": trainer.params, "o": trainer.opt_state}))
        trainer.bundle.fn = timed(trainer.bundle.fn)
        pipe, sampler = loader()
        _zero_kernel_launches()
        history, peaks = [], []
        first = TRAIN_CKPT_AT if resume else steps
        with pipe.auto_stop():
            torch.cuda.reset_peak_memory_stats(dev)
            history += trainer.fit(pipe, steps=first, sampler=sampler)["history"]
            peaks.append(torch.cuda.max_memory_allocated(dev))
            if resume:
                row["resume"] = check_resume(dev, cfg, shape, tcfg, trainer, loader)
                trainer.manager.every = 10**9  # the one checkpoint is step TRAIN_CKPT_AT's
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats(dev)
                history += trainer.fit(pipe, steps=steps - first, sampler=sampler)["history"]
                peaks.append(torch.cuda.max_memory_allocated(dev))
            health = {**trainer.health(), "data_wait_s": trainer.data_wait_s, "step_s": trainer.step_s}
            if trace:  # one more step under the profiler, after the readings above
                t_trace = time.monotonic()
                row["step_trace"] = trace_step(dev, lambda: trainer.fit(pipe, steps=1, sampler=sampler), "gemm")
                row["step_trace"]["seconds"] = time.monotonic() - t_trace
                row["step_trace"]["note"] = f"step {steps + 1} under torch.profiler; kernel_ms sums the GEMM kernels"
        launches = _kernel_launches()
    tokens = TRAIN_BATCH * TRAIN_SEQ
    step_ms, history = step_ms[:steps], history[:steps]
    steady = statistics.median(step_ms[1:])
    row.update({
        "step_ms": step_ms, "first_step_ms": step_ms[0], "step_ms_median_2_on": steady,
        "tokens_per_step": tokens, "tokens_per_s": tokens / steady * 1e3,
        **health,
        "loss": {h["step"]: h["loss"] for h in history if h["step"] in (1, steps)},
        "grad_norm": {h["step"]: h["grad_norm"] for h in history if h["step"] in (1, steps)},
        "losses": [h["loss"] for h in history],
        **({"loss_lm": [h["loss_lm"] for h in history], "aux": [h["aux"] for h in history]}
           if moe_layers(cfg) else {}),
        "max_memory_allocated_gb": max(peaks) / 1e9, "kernel_launches": launches,
        "reading": "the timings and bytes are readings, not gates", "seconds": time.monotonic() - t0,
    })
    emit(row)
    if len(history) != steps or not all(math.isfinite(h["loss"]) for h in history):
        raise AssertionError(f"train {arch}: {len(history)} of {steps} steps, losses {row['losses']}")
    if any(launches.values()):
        raise AssertionError(f"train {arch} launched a kernel: {launches}")


def check_resume(dev, cfg, shape, tcfg, trainer, loader) -> dict:
    """A fresh ``Trainer.from_checkpoint`` in the trainer's directory must hold
    the trainer's state bit for bit (it took no step since its save), the
    saved step and the saved sampler state, and then train 2 steps."""
    from repro_torch.runtime import Trainer
    from repro_torch.tree import tree_items

    ckpt = pathlib.Path(tcfg.ckpt_dir) / f"step_{TRAIN_CKPT_AT:08d}"
    saved_sampler = json.loads((ckpt / "meta.json").read_text())["sampler"]
    pipe, sampler = loader()
    t0 = time.monotonic()
    resumed = Trainer.from_checkpoint(cfg, shape, sampler=sampler, tcfg=tcfg, device=dev)
    restore_s = time.monotonic() - t0
    want = dict(tree_items({"p": trainer.params, "o": trainer.opt_state}))
    got = dict(tree_items({"p": resumed.params, "o": resumed.opt_state}))
    unequal = [k for k in want if not (got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]))]
    out = {"step": resumed.step, "leaves": len(want), "unequal_leaves": unequal,
           "sampler_restored": sampler.state_dict() == saved_sampler, "restore_s": restore_s,
           "ckpt_bytes": (ckpt / "arrays.npz").stat().st_size,
           "snapshot_ms": trainer.manager.snapshot_ms}
    with pipe.auto_stop():
        hist = resumed.fit(pipe, steps=TRAIN_RESUME_STEPS, sampler=sampler)["history"]
    out["resumed_steps"] = [h["step"] for h in hist]
    out["resumed_losses"] = [h["loss"] for h in hist]
    del resumed
    if out["step"] != TRAIN_CKPT_AT or unequal or not out["sampler_restored"]:
        raise AssertionError(f"resume: {out}")
    if len(hist) != TRAIN_RESUME_STEPS or not all(math.isfinite(x) for x in out["resumed_losses"]):
        raise AssertionError(f"resume: {out}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; nothing was run", file=sys.stderr)
        return 2
    try:
        from repro_torch.data import SyntheticImageDataset
    except ImportError as e:
        print(f"chip_smoke: the port is not importable from {ROOT / 'src'}: {e}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    summary = {
        name: {"name": name, "route": "cuda", "source": "src/repro_torch/kernels/csrc/dequant_normalize.cu",
               "replaces": f"src/repro/kernels/dequant_normalize.py:{line}", "launches": 0,
               "max_abs_err": 0.0, "ms": None, "plain_ms": None, "bound_ms": None, "bound_by": None,
               "library_ms": None, "library_note": f"no single PyTorch call computes {what} to NCHW"}
        for name, line, what in (
            ("dequant_normalize_augment", 89, "crop, flip, dequant and normalize"),
            ("dequant_normalize", 44, "dequant and normalize"),
        )
    }
    summary["flash_attention"] = {
        "name": "flash_attention", "route": "cuda", "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:88", "launches": 0, "max_abs_err": 0.0,
        "ms": None, "plain_ms": None, "bound_ms": None, "bound_by": None, "library_ms": None,
    }
    summary["ssd_scan"] = {
        "name": "ssd_scan", "route": "cuda", "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:91", "launches": 0, "max_abs_err": 0.0,
        "ms": None, "plain_ms": None, "bound_ms": None, "bound_by": None, "library_ms": None,
        "library_note": "no single PyTorch call computes the SSD chunked scan",
        "cuda_route": "tc_bf16",  # ssd_tc_bf16, the main path's (bf16) kernel; f32 runs ssd_cuda_f32
    }
    try:
        dev = torch.device("cuda", 0)
        smi = phase_device()
        phase_build()
        phase_kernels(dev, summary, smi)
        phase_flash(dev, summary, smi)
        phase_ssd(dev, summary, smi)
        phase_model_check(dev, "qwen3-0.6b", 256)
        phase_model_check(dev, "qwen3-0.6b", 20, "prefill_ragged")  # padded to 64 for K3
        phase_model_check(dev, "qwen3-0.6b", 256, "prefill_restart", restart=True)  # K3's position route
        phase_model_check(dev, "mamba2-780m", 512)  # two chunks of 256
        phase_model_check(dev, "mamba2-780m", 20, "prefill_ragged_ssd")  # one chunk of 20 for K4
        phase_moe(dev, smi)
        phase_model_check(dev, "granite-moe-1b-a400m", 256, dtype="float32", conditioned=True)
        phase_model_check(dev, "granite-moe-1b-a400m", 256, conditioned=True)
        phase_model_check(dev, "jamba-1.5-large-398b", 128)  # 1 K3 and 1 K4 launch; 23.8 GB of weights
        phase_model_check(dev, "deepseek-v3-671b", 256, dtype="float32")  # 2 dense MLA layers; 14.8 GB
        release_card()
        # 3 dense layers, 1 MoE layer; 31.6 GB.  On the seed-0 weights the bf16 outputs sit 4.2-5.1e-2
        # from the CPU's on an H100: w_uq/w_uk drawn at fan-in over the heads make attention peaked
        phase_model_check(dev, "deepseek-v3-671b", 128, layers=4, conditioned=True)
        release_card()
        # MusicGen: MHA, 24 heads of 64 (K3 at kv groups of 1), LayerNorm and GELU, four codebooks.
        # InternVL2: 256 vision rows, then 256 tokens; the head masks 119 padding columns of 92,672.
        # Neither has qk_norm.  On the seed-0 weights an H100 read f32 6.99e-5 and 8.81e-5 of the
        # largest CPU value (logits), bf16 2.31e-2 / 5.67e-2 and 0.177 / 0.125 (prefill / decode
        # logits): wq/wk drawn at fan-in over the heads make attention peaked
        for arch, seq in (("musicgen-medium", 256), ("internvl2-2b", 512)):
            phase_model_check(dev, arch, seq, dtype="float32", conditioned=True)
            phase_model_check(dev, arch, seq, conditioned=True)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as d:
            t0 = time.monotonic()
            ds = SyntheticImageDataset.materialize(d, FRAMES, hw=FRAME, seed=0)
            emit({"phase": "dataset", "frames": FRAMES, "hw": list(FRAME), "seconds": time.monotonic() - t0})
            phase_main(ds, dev, summary)
            phase_example(ds, dev, summary)
            phase_shards(ds, pathlib.Path(d), dev, summary)
        phase_serve(dev, summary, "qwen3-0.6b", "flash_attention", "fa_tc_bf16")
        phase_serve(dev, summary, "mamba2-780m", "ssd_scan", "ssd_tc_bf16")
        phase_serve(dev, summary, "granite-moe-1b-a400m", "flash_attention", "fa_tc_bf16")
        release_card()
        phase_serve(dev, summary, "deepseek-v3-671b", "flash_attention", "fa_tc_bf16", layers=4)
        release_card()
        phase_serve(dev, summary, "musicgen-medium", "flash_attention", "fa_tc_bf16")  # through the step builders
        phase_serve(dev, summary, "internvl2-2b", "flash_attention", "fa_tc_bf16")
        release_card()
        phase_train_check(dev, "qwen3-0.6b")
        phase_train_check(dev, "mamba2-780m")
        phase_train_check(dev, "granite-moe-1b-a400m", conditioned=True)
        phase_train_check(dev, "deepseek-v3-671b", seq=DEEPSEEK_CHECK_SEQ, rows=1)  # 2 dense layers + MTP, 3.71 B
        # on the seed-0 weights an H100's f32 leaves read 1.20e-3 (MusicGen) and 6.85e-3 (InternVL2)
        phase_train_check(dev, "musicgen-medium", conditioned=True)
        phase_train_check(dev, "internvl2-2b", conditioned=True)
        release_card()
        # Qwen3's and Mamba2's steps were traced before (PERF.md §5); the time goes to DeepSeek's checks
        phase_train(dev, "qwen3-0.6b", TRAIN_STEPS, resume=True, trace=False)
        phase_train(dev, "mamba2-780m", 2, resume=False, trace=False)
        phase_train(dev, "granite-moe-1b-a400m", 2, resume=False)
    except Exception:
        traceback.print_exc()
        return 1
    emit({"kernels": list(summary.values())})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
