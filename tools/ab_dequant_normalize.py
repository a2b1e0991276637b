"""Time this checkout's decode kernel (K1/K2, ``dequant_normalize.cu``)
against the one-thread-per-pixel kernel of an earlier checkout, in one
process on one CUDA card.

    git archive <commit> src/repro_torch/kernels/csrc | tar -x -C build/other
    python3 tools/ab_dequant_normalize.py --other build/other

The earlier source is compiled with this checkout's ``nvcc`` flags and
called through its ``dn_launch`` of 15 arguments (draws clamped on the
host, one (N, 3) int32 array on the card).  Both kernels run at the image
path's shapes (K1: (128, 256, 256, 3) uint8 to a (224, 224) window, bf16;
K2: (128, 224, 224, 3)), must equal the plain version bit for bit, and are
timed in turns (other, this, this, other) as ``chip_smoke.time_ms`` times
a kernel: median of ``TIMED_RUNS`` launches, each after an L2 flush.
K1's wrapper is compared the same way: the earlier wrapper's host path
(draws clamped with tensor ops, ``pin_memory()``, a copy, the launch)
rebuilt around the earlier kernel, against this checkout's wrapper, both
given numpy draws as the loader gives them: host time a call with the card
idle, and device time with the host's work inside the timed window.
Prints one JSON line with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import statistics
import subprocess
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import dequant_normalize as dn  # noqa: E402


def other_kernel(checkout: pathlib.Path) -> ctypes.CDLL:
    csrc = checkout / "src/repro_torch/kernels/csrc"
    target = ROOT / "build" / "ab" / "dequant_normalize_other.so"
    target.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(target), str(csrc / "dequant_normalize.cu")],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(target))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.dn_launch.argtypes = [p, i, p, p, p, p, i, i, i, i, i, i, i, ctypes.c_float, p]
    lib.dn_launch.restype = i
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=pathlib.Path, required=True, help="root of the earlier checkout")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ab_dequant_normalize: torch sees no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = cs.phase_device()
    other = other_kernel(args.other)
    gen = torch.Generator().manual_seed(0)
    n, (h, w), (oh, ow) = cs.BATCH, cs.FRAME, cs.CROP
    x1 = torch.randint(0, 256, (n, h, w, 3), generator=gen, dtype=torch.uint8).to(dev)
    x2 = torch.randint(0, 256, (n, oh, ow, 3), generator=gen, dtype=torch.uint8).to(dev)
    mean, std = torch.tensor(cs.MEAN, device=dev), torch.tensor(cs.STD, device=dev)
    flip = torch.randint(0, 2, (n,), generator=gen, dtype=torch.int32)
    crop = torch.stack([torch.randint(0, h - oh + 1, (n,), generator=gen),
                        torch.randint(0, w - ow + 1, (n,), generator=gen)], 1).to(torch.int32)
    clamped = dn._augment_params(x1, flip, crop, oh, ow).to(dev)
    drawn = dn._card_draws(x1, flip.to(dev), crop.to(dev))
    out = torch.empty((n, 3, oh, ow), dtype=torch.bfloat16, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def old(x, params, hw):
        def run():
            _build.check(other, other.dn_launch(x.data_ptr(), 0, mean.data_ptr(), std.data_ptr(), params,
                                                out.data_ptr(), 0, n, *hw, 3, oh, ow, dn.U8_SCALE, stream),
                         "other kernel")
            return out
        return run

    def new(x, params):
        return lambda: dn._launch(x, mean, std, params, oh, ow, dn.U8_SCALE, torch.bfloat16, "this kernel")

    kernels = {"k1_other": old(x1, clamped.data_ptr(), (h, w)), "k1_this": new(x1, drawn),
               "k2_other": old(x2, None, (oh, ow)), "k2_this": new(x2, None)}
    wants = {"k1": dn.dequant_normalize_augment_plain(x1, mean, std, flip.to(dev), crop.to(dev), out_hw=(oh, ow)),
             "k2": dn.dequant_normalize_plain(x2, mean, std)}
    exact = {name: bool(torch.equal(fn(), wants[name[:2]])) for name, fn in kernels.items()}
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    turns = {f"{k}_{who}_{ab}": kernels[f"{k}_{who}"]
             for k in ("k1", "k2") for who, ab in (("other", "a"), ("this", "a"), ("this", "b"), ("other", "b"))}
    times = cs.time_interleaved_ms(turns, flush)

    np_flip, np_crop = flip.numpy(), crop.numpy()

    def old_wrapper():
        dn._check(x1, mean, std, torch.bfloat16)
        dn._out_hw(x1, (oh, ow))
        params = dn._augment_params(x1, np_flip, np_crop, oh, ow).pin_memory().to(dev, non_blocking=True)
        result = torch.empty((n, 3, oh, ow), dtype=torch.bfloat16, device=dev)
        with torch.cuda.device(dev):
            err = other.dn_launch(x1.data_ptr(), 0, mean.data_ptr(), std.data_ptr(), params.data_ptr(),
                                  result.data_ptr(), 0, n, h, w, 3, oh, ow, dn.U8_SCALE,
                                  torch.cuda.current_stream(dev).cuda_stream)
        _build.check(other, err, "other kernel")
        return result

    def new_wrapper():
        return dn.dequant_normalize_augment(x1, mean, std, np_flip, np_crop, out_hw=(oh, ow))

    wrappers = {"other": old_wrapper, "this": new_wrapper}
    exact.update({f"wrapper_{k}": bool(torch.equal(fn(), wants["k1"])) for k, fn in wrappers.items()})
    host = {f"{who}_{ab}": [] for ab in "ab" for who in wrappers}
    device = {key: [] for key in host}
    for _ in range(cs.TIMED_RUNS):
        for who, ab in (("other", "a"), ("this", "a"), ("this", "b"), ("other", "b")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            wrappers[who]()
            host[f"{who}_{ab}"].append((time.perf_counter() - t0) * 1e3)
            device[f"{who}_{ab}"].append(cs._timed_once(wrappers[who], flush, False))
    torch.cuda.synchronize()
    print(json.dumps({"card": card, "exact_vs_plain": exact, "ms": times,
                      "wrapper_host_ms": {k: statistics.median(v) for k, v in host.items()},
                      "wrapper_ms": {k: statistics.median(v) for k, v in device.items()},
                      "bound_ms": cs.dequant_bound(n * oh * ow * 3, 1, n * 3 * oh * ow, 2, 0, card)["bound_ms"]}))
    return 0 if all(exact.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
