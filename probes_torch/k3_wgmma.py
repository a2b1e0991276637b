"""K3's bf16 kernel (``fa_wgmma_bf16``) on its own: its build log, the
scale-aware bar (``chip_smoke.FA_ROW_REL``) on the kernel and on planted
faults, and the wrapper's host time beside another checkout's.

    python3 probes_torch/k3_wgmma.py                      # nvcc's whole log, then ptxas of every instance
    python3 probes_torch/k3_wgmma.py --faults             # the bars' readings: the kernel, then each fault
    python3 probes_torch/k3_wgmma.py --host ROOT [ROOT..] # the wrapper's host time in each checkout, in turn
    python3 probes_torch/k3_wgmma.py --host-ab ROOT       # fa_launch's host time here and in ROOT, interleaved
    python3 probes_torch/k3_wgmma.py --phases             # chip_smoke's phase_flash and long_k3 alone
    python3 probes_torch/k3_wgmma.py --times              # the kernel beside SDPA at five shapes

``--faults`` runs, in a process of its own each, this checkout's kernel
and each planted fault (a copy of ``src/`` in a temporary directory with
one edit to ``flash_attention.cu``, built there) at Qwen3-0.6B's
``prefill_32k`` attention (one row of its four: q (1,16,32768,128), k and v
(1,8,32768,128)), DeepSeek-V3's MLA at 32k (q, k, v (1,128,32768,192), v
zero-padded from 128; held on 32 heads) and Qwen3's serving shape
(8,16,512,128), each against the plain version, and prints FA_TOL's and
FA_ROW_REL's readings.  The faults, both in the producer's loads:

  stale_v_late  the last quarter of the key steps multiply the previous
                step's V tiles (a ring slot read a wrap early);
  zero_v_step   the second-to-last key step's V tiles load from past the
                last key (zeros): a stage dropped from P.V.

``--host`` times ``flash_attention``'s host time at Qwen3's serving shape
(``chip_smoke.host_ms``, card idle) with ``repro_torch`` imported from
``ROOT/src``, one process a checkout, in the order given.  ``--host-ab``
times the library's ``fa_launch`` alone (ctypes, card idle) at that shape
in one process, this checkout's against ``ROOT``'s (built from its own
sources), ten pairs in alternating order, 50 calls a reading; beside them
this checkout's with the output at a new address every call (512 buffers
in turn: each call encodes o's map anew).  ``--phases``
runs chip_smoke's K3 phases (every K3 case of ``phase_flash``, then
``long_k3`` at each ``LONG_K3`` shape) without the rest.  ``--times``
gives the medians of ``chip_smoke.time_ms`` (an L2 flush before each
launch) beside SDPA and the bound at Qwen3's, Yi-6B's, (8,64,512,128)'s
and MLA's serving shapes and Qwen3's ``prefill_32k`` (4,16,32768,128):
the shapes each design of the kernel was first timed at.  Needs a CUDA
card.  Prints one JSON line a reading.
"""

import json
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402

# the producer's load of a K or V tile: what each fault edits
LOAD = "(step * NST + j) * SK, kv_head);"
FAULTS = {
    "stale_v_late": "((step - (kind && 4 * step >= 3 * n_steps_all)) * NST + j) * SK, kv_head);",
    "zero_v_step": "(kind && step == n_steps_all - 2 ? skv : (step * NST + j) * SK), kv_head);",
}
GATE_CASES = [  # name, b, h, hkv, s, hd, q heads held to the plain version
    ("qwen3_prefill_32k_row0", 1, 16, 8, 32768, 128, 16),
    ("mla_prefill_32k", 1, 128, 128, 32768, 192, 32),
    ("qwen3_serving", 8, 16, 8, 512, 128, 16),
]


def use_src(src: str):
    """``repro_torch`` from ``src`` (chip_smoke put this checkout's first)."""
    sys.path.insert(0, src)
    from repro_torch.kernels import flash_attention as fa

    if not pathlib.Path(fa.__file__).resolve().is_relative_to(pathlib.Path(src).resolve()):
        raise RuntimeError(f"repro_torch came from {fa.__file__}, not {src}")
    return fa


def gate(src: str, label: str) -> None:
    fa = use_src(src)
    dev = torch.device("cuda", 0)
    for name, b, h, hkv, s, hd, heads in GATE_CASES:
        gen = torch.Generator(device=dev).manual_seed(10)
        q, k, v = (torch.randn(shape, generator=gen, device=dev, dtype=torch.bfloat16)
                   for shape in ((b, h, s, hd), (b, hkv, s, hd), (b, hkv, s, hd)))
        if hd == 192:
            v[..., cs.MLA_V_DIM:] = 0
        kw = {"causal": True, "block_q": 128, "block_k": 128}
        got = fa.flash_attention(q, k, v, **kw)[:, :heads]
        group = h // hkv
        want = fa.flash_attention_plain(q[:, :heads], k[:, :heads // group], v[:, :heads // group], **kw)
        cs.sync(dev)
        print(json.dumps({"kernel": label, "case": name, "q": [b, h, s, hd], "held_heads": heads,
                          **cs.within_tol(got, want), **cs.row_rel(got, want)}), flush=True)
        del q, k, v, got, want
        torch.cuda.empty_cache()


TIMED = [  # name, b, h, hkv, s, hd
    ("qwen3_serving", 8, 16, 8, 512, 128),
    ("yi_serving", 8, 32, 4, 512, 128),
    ("h64_kv8_serving", 8, 64, 8, 512, 128),
    ("mla_serving", 8, 128, 128, 512, 192),
    ("qwen3_prefill_32k", 4, 16, 8, 32768, 128),
]


def times(card: str) -> None:
    from repro_torch.kernels import flash_attention as fa

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(10)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    for name, b, h, hkv, s, hd in TIMED:
        q, k, v = (torch.randn(shape, generator=gen, device=dev, dtype=torch.bfloat16)
                   for shape in ((b, h, s, hd), (b, hkv, s, hd), (b, hkv, s, hd)))
        vd = cs.MLA_V_DIM if hd == 192 else hd
        v[..., vd:] = 0
        kw = {"causal": True, "block_q": 128, "block_k": 128}
        runs = cs.LONG_TIMED_RUNS if s > 4096 else cs.TIMED_RUNS
        v_lib = v[..., :vd].contiguous() if vd < hd else v
        ms = cs.time_ms(lambda: fa.flash_attention(q, k, v, **kw), flush, runs=runs)
        library_ms = cs.time_ms(cs.library_attention(q, k, v_lib, True), flush, runs=runs)
        nbytes = sum(t.numel() * t.element_size() for t in (q, k, v_lib)) + q[..., :vd].numel() * q.element_size()
        row = {"case": name, "q": [b, h, s, hd], "kv": [b, hkv, s, hd], "ms": ms, "library_ms": library_ms,
               **cs.bound(nbytes, 2 * (hd + vd) * cs.causal_pairs(s, s, True) * b * h, cs.BF16_TC_OPS_PER_S, card)}
        row["over_bound"], row["over_library"] = ms / row["bound_ms"], ms / library_ms
        print(json.dumps(row), flush=True)
        del q, k, v, v_lib


def faults() -> int:
    env = {**os.environ}
    runs = [("kernel", str(ROOT / "src"))]
    with tempfile.TemporaryDirectory(prefix="k3_faults_") as d:
        for fault, edit in FAULTS.items():
            src = pathlib.Path(d, fault, "src")
            shutil.copytree(ROOT / "src", src, ignore=shutil.ignore_patterns("__pycache__"))
            cu = src / "repro_torch" / "kernels" / "csrc" / "flash_attention.cu"
            text = cu.read_text()
            if text.count(LOAD) != 1:
                raise RuntimeError(f"{fault}: the producer's load is not in {cu.name} once")
            cu.write_text(text.replace(LOAD, edit))
            runs.append((fault, str(src)))
        rc = 0
        for label, src in runs:
            done = subprocess.run([sys.executable, __file__, "--gate", src, label], env=env, check=False)
            rc |= done.returncode
    return rc


def host(roots: list[str]) -> int:
    rc = 0
    for root in roots:
        src = str(pathlib.Path(root, "src"))
        rc |= subprocess.run([sys.executable, __file__, "--host-one", src], check=False).returncode
    return rc


def host_ab(root: str) -> None:
    import ctypes
    import importlib.util
    import statistics
    import time

    from repro_torch.kernels import flash_attention as fa

    build_py = pathlib.Path(root, "src", "repro_torch", "kernels", "_build.py")
    spec = importlib.util.spec_from_file_location("other_build", build_py)
    other = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(other)
    libs = {"other": other.library("flash_attention"), "here": fa._lib()}
    libs["other"].fa_launch.argtypes = libs["here"].fa_launch.argtypes
    libs["other"].fa_launch.restype = ctypes.c_int
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(10)
    q, k, v = (torch.randn(shape, generator=gen, device=dev, dtype=torch.bfloat16)
               for shape in ((8, 16, 512, 128), (8, 8, 512, 128), (8, 8, 512, 128)))
    outs = [torch.empty_like(q) for _ in range(512)]
    stream = torch.cuda.current_stream(dev).cuda_stream

    def reading(lib, fresh: bool) -> float:
        times = []
        for i in range(50):
            o = outs[i + 1 if fresh else 0]
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            err = lib.fa_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), None, None, 0,
                                8, 16, 8, 512, 512, 128, 128, 128**-0.5, 1, stream)
            times.append((time.perf_counter() - t0) * 1e3)
            if err:
                raise RuntimeError(f"fa_launch returned {err}")
        torch.cuda.synchronize(dev)
        return statistics.median(times)

    for lib in libs.values():  # warm: build, load, first launches
        reading(lib, False)
    for pair in range(10):
        order = ("other", "here") if pair % 2 == 0 else ("here", "other")
        row = {name: reading(libs[name], False) for name in order}
        row["here_new_address"] = reading(libs["here"], True)
        print(json.dumps({"pair": pair, "first": order[0], "fa_launch_host_ms": row}), flush=True)
        outs = outs[:1] + outs[51:] + outs[1:51]  # the next pair's new addresses are new to the cache too


def host_one(src: str) -> None:
    fa = use_src(src)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(10)
    q, k, v = (torch.randn(shape, generator=gen, device=dev, dtype=torch.bfloat16)
               for shape in ((8, 16, 512, 128), (8, 8, 512, 128), (8, 8, 512, 128)))
    kw = {"causal": True, "block_q": 128, "block_k": 128}
    readings = [cs.host_ms(lambda: fa.flash_attention(q, k, v, **kw), dev) for _ in range(3)]
    print(json.dumps({"src": src, "q": [8, 16, 512, 128], "wrapper_host_ms": readings}), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("k3_wgmma: no CUDA device", file=sys.stderr)
        return 2
    args = sys.argv[1:]
    if args[:1] == ["--gate"]:
        gate(args[1], args[2])
        return 0
    if args[:1] == ["--host-one"]:
        host_one(args[1])
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"card": card, "torch": torch.__version__, "cuda": torch.version.cuda}), flush=True)
    if args[:1] == ["--faults"]:
        return faults()
    if args[:1] == ["--host"]:
        return host(args[1:])
    if args[:1] == ["--host-ab"]:
        host_ab(args[1])
        return 0
    if args[:1] == ["--times"]:
        times(card)
        return 0
    if args[:1] == ["--phases"]:
        dev, summary = torch.device("cuda", 0), cs.kernel_summary()
        cs.phase_build()
        cs.phase_flash(dev, summary, card)
        for arch in cs.LONG_K3:
            cs.long_k3(dev, summary, card, arch)
        return 0
    from repro_torch.kernels import _build

    seconds, _ = _build.build_all()
    print(json.dumps({"build_seconds": seconds}), flush=True)
    print(_build._target(_build.CSRC / "flash_attention.cu").with_suffix(".log").read_text(), flush=True)
    print(json.dumps({"ptxas": _build.ptxas("flash_attention")}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
