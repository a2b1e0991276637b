"""Drive the PyTorch port's image path on one CUDA card and check it.

    python3 chip_smoke.py

Builds the hand-written kernels from ``src/repro_torch/kernels/csrc``,
holds each against its plain PyTorch version at the main path's shapes
(with timings and the card's bound), then runs the port's image loader at
ImageNet training geometry (256x256 RGB frames, batch 128, random 224x224
crops and flips decoded on the card) and checks every delivered batch
against the same loader run on the CPU.  Each phase prints one JSON line.
The last three lines are the kernel summary, the card's name and power
limit as ``nvidia-smi`` gives them, and ``{"ok": true, "device": ...}``.

Exits non-zero, printing no result, when torch sees no CUDA card or when
any phase fails.
"""

from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time
import traceback

import torch

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
BATCH, FRAME, CROP = 128, (256, 256), (224, 224)
FRAMES = 1536  # 12 batches an epoch; 2 epochs cycle the 10-slab ring twice over
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
F32_OPS_PER_S = 67e12  # H100 SXM, outside the tensor cores
OPS_PER_ELEMENT = 3  # x*scale, -mean_c, *(1/std_c)
BF16_BAR, F32_BAR = "1 bf16 ulp", 2e-5
TIMED_RUNS = 30


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


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def time_ms(fn, flush: torch.Tensor) -> float:
    """Median device time of ``fn`` over TIMED_RUNS launches, each after an
    L2 flush (the decode reads a batch that was just copied in, cold)."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(TIMED_RUNS):
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(n_read: int, in_size: int, n_out: int, out_size: int, extra_bytes: int) -> dict:
    nbytes = n_read * in_size + n_out * out_size + extra_bytes
    ops = n_out * OPS_PER_ELEMENT
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "ops": ops}


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
    ptxas = [ln.strip() for ln in log.splitlines() if ("ptxas info" in ln and "Used" in ln) or "spill" in ln]
    emit({"phase": "build", "seconds": seconds, "dir": str(_build.BUILD_DIR.relative_to(ROOT)), "ptxas": ptxas})


def phase_kernels(dev: torch.device, summary: dict) -> None:
    from repro_torch.kernels import dequant_normalize as dn

    gen = torch.Generator(device="cpu").manual_seed(0)
    mean = torch.tensor(MEAN, device=dev)
    std = torch.tensor(STD, device=dev)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)  # > the 50 MB L2

    def frames(shape, dtype):
        if dtype == torch.uint8:
            return torch.randint(0, 256, shape, generator=gen, dtype=torch.uint8).to(dev)
        return torch.rand(shape, generator=gen).to(dev)

    cases = [
        ("main", (BATCH, *FRAME, 3), torch.uint8, CROP, torch.bfloat16, True),
        ("f32_in", (BATCH, *FRAME, 3), torch.float32, CROP, torch.bfloat16, False),
        ("f32_out", (BATCH, *FRAME, 3), torch.uint8, CROP, torch.float32, False),
        ("odd", (3, 13, 17, 3), torch.uint8, (9, 11), torch.bfloat16, False),
    ]
    for case, shape, in_dtype, (oh, ow), out_dtype, timed in cases:
        n, h, w, c = shape
        x = frames(shape, in_dtype)
        flip = torch.randint(0, 2, (n,), generator=gen, dtype=torch.int32)
        crop = torch.stack([torch.randint(0, h - oh + 1, (n,), generator=gen),
                            torch.randint(0, w - ow + 1, (n,), generator=gen)], 1).to(torch.int32)
        got = dn.dequant_normalize_augment(x, mean, std, flip, crop, out_hw=(oh, ow), out_dtype=out_dtype)
        want = dn.dequant_normalize_augment_plain(x, mean, std, flip, crop, out_hw=(oh, ow), out_dtype=out_dtype)
        sync(dev)
        row = {"phase": "kernels", "kernel": "dequant_normalize_augment", "case": case,
               "shape": list(shape), "in": str(in_dtype), "out_hw": [oh, ow], "out": str(out_dtype),
               **compare(got, want)}
        summary["dequant_normalize_augment"]["max_abs_err"] = max(
            summary["dequant_normalize_augment"]["max_abs_err"], row["max_abs_err"])
        if row["over_bar"]:
            emit(row)
            raise AssertionError(f"dequant_normalize_augment {case}: {row['over_bar']} elements over the bar")
        if timed:
            params = dn._augment_params(x, flip, crop, oh, ow).to(dev)
            dflip, dcrop = flip.to(dev), crop.to(dev)
            scale = dn.U8_SCALE
            row["ms"] = time_ms(lambda: dn._launch(x, mean, std, params, oh, ow, scale, out_dtype, "k1"), flush)
            row["wrapper_ms"] = time_ms(lambda: dn.dequant_normalize_augment(
                x, mean, std, flip, crop, out_hw=(oh, ow), out_dtype=out_dtype), flush)
            row["plain_ms"] = time_ms(lambda: dn.dequant_normalize_augment_plain(
                x, mean, std, dflip, dcrop, out_hw=(oh, ow), out_dtype=out_dtype), flush)
            row.update(bound(n * oh * ow * c, x.element_size(), n * c * oh * ow, got.element_size(),
                             params.numel() * 4 + 2 * c * 4))
            summary["dequant_normalize_augment"].update(
                {k: row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")})
        emit(row)

    x = frames((BATCH, *CROP, 3), torch.uint8)
    got = dn.dequant_normalize(x, mean, std)
    want = dn.dequant_normalize_plain(x, mean, std)
    sync(dev)
    row = {"phase": "kernels", "kernel": "dequant_normalize", "case": "main",
           "shape": list(x.shape), **compare(got, want)}
    if row["over_bar"]:
        emit(row)
        raise AssertionError(f"dequant_normalize: {row['over_bar']} elements over the bar")
    row["ms"] = time_ms(lambda: dn.dequant_normalize(x, mean, std), flush)
    row["plain_ms"] = time_ms(lambda: dn.dequant_normalize_plain(x, mean, std), flush)
    row.update(bound(x.numel(), 1, x.numel(), 2, 2 * 3 * 4))
    summary["dequant_normalize"].update(
        {k: row[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")})
    emit(row)


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
          "h2d_bytes": n_card * BATCH * FRAME[0] * FRAME[1] * 3, "reading": "images_per_s and h2d_bytes are not gates"})
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
    try:
        dev = torch.device("cuda", 0)
        smi = phase_device()
        phase_build()
        phase_kernels(dev, summary)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as d:
            t0 = time.monotonic()
            ds = SyntheticImageDataset.materialize(d, FRAMES, hw=FRAME, seed=0)
            emit({"phase": "dataset", "frames": FRAMES, "hw": list(FRAME), "seconds": time.monotonic() - t0})
            phase_main(ds, dev, summary)
            phase_example(ds, dev, summary)
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
