"""K4's bf16 kernel (``ssd_wgmma_bf16``) on its own: its build log, its
checks at chip_smoke's cases, each pass's time, the scale-aware bars on
planted faults, and the wrapper's host time beside another checkout's.

    python3 probes_torch/k4_wgmma.py                      # nvcc's whole log, then ptxas of every instance
    python3 probes_torch/k4_wgmma.py --check              # every case of phase_ssd and the long ones, not timed
    python3 probes_torch/k4_wgmma.py --times              # each pass's time at the timed shapes
    python3 probes_torch/k4_wgmma.py --faults             # the bars' readings: the kernel, then each fault
    python3 probes_torch/k4_wgmma.py --phases [ROOT]      # chip_smoke's phase_ssd and long_k4 from ROOT's checkout
    python3 probes_torch/k4_wgmma.py --host ROOT [ROOT..] # the wrapper's host time in each checkout, in turn
    python3 probes_torch/k4_wgmma.py --ablate [NAME ..]   # each pass's time with one part of the work taken out

``--check`` runs each case of ``chip_smoke.phase_ssd`` and the long ones
(``long_500k``'s scan on both draws, Jamba's ``prefill_32k`` scan) against
the plain version and prints SSD_TOL's and the scale-aware bars' readings
(``chip_smoke.ssd_rel``) without stopping at a failure.  ``--times``
traces one call at Mamba2's serving shape (8,512,48,64), its batch-1 row,
``long_500k``'s (1,524288,48,64) and Jamba's (2,32768,256,64) with
``torch.profiler`` and prints each pass's device time (pass A is the
instance ``<NPAN,false>``, pass B ``<NPAN,true>``) beside
``chip_smoke.time_ms`` of the whole call.  ``--faults`` runs, in a process
of its own each, this checkout's kernel and each planted fault (a copy of
``src/`` in a temporary directory with one edit to the carry in
``ssd_scan.cu``, built there) at four shapes the kernel splits into
segments, on the sweep's draw and on the long-memory draw:

  carry_dropped    pass B starts every segment from h = 0;
  decay_twice      the carry multiplies each earlier segment's state by its
                   decay twice;
  previous_state   pass B starts segment s from the state segment s - 1
                   started from.

``--phases`` runs ``chip_smoke.phase_ssd`` and ``long_k4`` at each
``LONG_K4`` shape of the ``chip_smoke.py`` in ROOT (default this
checkout), as that checkout has them.  ``--host`` times ``ssd_scan``'s
host time at the serving shape (``chip_smoke.host_ms``, card idle) with
``repro_torch`` imported from ``ROOT/src``, one process a checkout, in
the order given.  ``--ablate`` times (as ``--times``, at Jamba's and
``long_500k``'s shapes) this checkout's kernel and copies of it, each
built in a temporary directory with one part of its work taken out
(``ABLATIONS``; their outputs are wrong): what each part costs.  Given
names, only those, each timed between two runs of the kernel (kernel,
copy, copy, kernel).  Needs a CUDA card.  Prints one JSON line a reading.
"""

import json
import os
import re
import pathlib
import shutil
import subprocess
import sys
import tempfile

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]

# the carry in pass B's prologue: what each fault edits
FOLD = "for (int j = 0; j < s; ++j) {"
STEP = "h[i] = __fadd_rn(__fmul_rn(h[i], e), v);"
FAULTS = {
    "carry_dropped": (FOLD, "for (int j = 0; j < 0; ++j) {"),
    "decay_twice": (STEP, "h[i] = __fadd_rn(__fmul_rn(h[i], e * e), v);"),
    "previous_state": (FOLD, "for (int j = 0; j < s - 1; ++j) {"),
}
GATE_CASES = [  # name, (b, l, h, p, g, n), chunk: each split into segments on an H100
    ("serving_row", (1, 512, 48, 64, 1, 128), 256),
    ("segments", (1, 25600, 48, 64, 1, 128), 256),
    ("ragged_segments", (2, 4000, 4, 64, 1, 128), 40),
    ("ragged_segments_n64", (2, 4000, 4, 64, 1, 64), 40),  # one state panel (NPAN 1)
]
# timing only: each takes one part of the kernel's work out (an edit of ssd_scan.cu)
ABLATIONS = {
    "no_state_update": [("    if (has_panel) {\n      for (int t = 0; t < tiles; ++t) {",
                         "    if (false) {\n      for (int t = 0; t < tiles; ++t) {")],
    "no_state_products": [
        ("            wgmma_rs<64>(upd, ap[kk][pc], desc_mn(b_panel, kk), t > 0 || kk > 0 || pc > 0);", "")],
    "no_xw_pieces": [("""ap[pc][r] = pack_bf16x2(v0, v1);
                         const float2 got = unpack_bf16x2(ap[pc][r]);
                         v0 -= got.x;
                         v1 -= got.y;""", "ap[pc][r] = xa[r] + pc;")],  # both passes
    "no_c_h": [
        ("        for (int kk = 0; kk < 4 * NPAN; ++kk) wgmma_ss<64>(yacc, desc_k(c_tile, kk), desc_k(h_s, kk), kk > 0);",
         "        for (int kk = 0; kk < 0; ++kk) {}"),
        ("          wgmma_ss<64>(yacc, desc_k(c_tile, kk), desc_k(h_s + NPAN * kPanel, kk), 1);", "          ;")],
    "no_scores": [
        ("          for (int kk = 0; kk < 4 * NPAN; ++kk) wgmma_ss<64>(sacc, desc_k(c_tile, kk), desc_k(b_tile, kk), kk > 0);",
         "          for (int kk = 0; kk < 0; ++kk) {}")],
    "no_scale": [("""              v0 = i0 >= col ? __fmul_rn(__fmul_rn(v0, exp_approx(cs0 - cs_j)), dt_j) : 0.f;
              v1 = i1 >= col ? __fmul_rn(__fmul_rn(v1, exp_approx(cs1 - cs_j)), dt_j) : 0.f;""",
                  "              v0 = v0 * dt_j + cs_j;\n              v1 = v1 * dt_j + cs_j;")],
    "no_s_x": [("""            wgmma_rs<64>(yacc, sh[kk], desc_mn(x_tile, kk), 1);
            wgmma_rs<64>(yacc, sl[kk], desc_mn(x_tile, kk), 1);""", "")],
}
TIMED = [  # name, (b, l, h, p, g, n), chunk
    ("serving", (8, 512, 48, 64, 1, 128), 256),
    ("serving_batch1", (1, 512, 48, 64, 1, 128), 256),
    ("long_500k", (1, 524288, 48, 64, 1, 128), 256),
    ("jamba_prefill_32k", (2, 32768, 256, 64, 8, 128), 256),
]


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def smoke(root: pathlib.Path, src: str | None = None):
    """``chip_smoke`` from ``root``, with ``repro_torch`` from ``src``
    (default ``root/src``; chip_smoke puts its own first, so ``src`` goes
    before it)."""
    sys.path.insert(0, str(root))
    import chip_smoke as cs

    src = pathlib.Path(src or root / "src").resolve()
    sys.path.insert(0, str(src))
    from repro_torch.kernels import ssd_scan as ks

    if not pathlib.Path(ks.__file__).resolve().is_relative_to(src):
        raise RuntimeError(f"repro_torch came from {ks.__file__}, not {src}")
    return cs, ks


def build_log() -> None:
    cs, _ = smoke(ROOT)
    from repro_torch.kernels import _build

    seconds, log = _build.build_all()
    print(log or "(built before)")
    emit({"build_seconds": seconds, "ptxas": _build.ptxas("ssd_scan"),
          "serialized_wgmma": "C7520" in _build._target(_build.CSRC / "ssd_scan.cu").with_suffix(".log").read_text()})


def reading(cs, ks, args, chunk: int) -> dict:
    y, h_final = ks.ssd_scan(*args, chunk=chunk)
    want_y, want_h = ks.ssd_scan_plain(*args, chunk=chunk)
    torch.cuda.synchronize()
    on_y, on_h = cs.within_tol(y, want_y, cs.SSD_TOL), cs.within_tol(h_final, want_h, cs.SSD_TOL)
    return {"y_over_ssd_tol": on_y["over_bar"], "h_over_ssd_tol": on_h["over_bar"],
            "max_abs_err": max(on_y["max_abs_err"], on_h["max_abs_err"]),
            **cs.ssd_rel(y, want_y, h_final, want_h, chunk)}


def check() -> None:
    cs, ks = smoke(ROOT)
    dev = torch.device("cuda", 0)
    cs.phase_build()
    gen = torch.Generator(device="cpu").manual_seed(4)
    cases = list(cs.SSD_CASES)
    cases += [("long_500k", (1, 524288, 48, 64, 1, 128), 256, torch.bfloat16, cs.ssd_inputs),
              ("long_500k_long_memory", (1, 524288, 48, 64, 1, 128), 256, torch.bfloat16, cs.ssd_inputs_long_memory),
              ("jamba_prefill_32k", (2, 32768, 256, 64, 8, 128), 256, torch.bfloat16, cs.ssd_inputs)]
    for name, shape, chunk, dtype, draw in cases:
        row = {"case": name, "b_l_h_p_g_n": list(shape), "chunk": chunk, "dtype": str(dtype), "draw": draw.__name__,
               **cs.k4_blocks(shape[0], shape[1], shape[2], chunk, dtype, dev)}
        on = gen if shape[1] <= 65536 else torch.Generator(device=dev).manual_seed(11)  # the long draws on the card
        try:
            row.update(reading(cs, ks, draw(on, *shape, dtype, dev), chunk))
        except Exception as e:  # noqa: BLE001 -- print every case's failure
            row["error"] = f"{type(e).__name__}: {e}"
        emit(row)
        cs.release_card()


def times() -> None:
    from torch.profiler import ProfilerActivity, profile

    cs, ks = smoke(ROOT)
    dev = torch.device("cuda", 0)
    cs.phase_build()
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(11)
    for name, shape, chunk in TIMED:
        args = cs.ssd_inputs(gen, *shape, torch.bfloat16, dev)
        runs = 5 if shape[1] > 4096 else 30
        ms = cs.time_ms(lambda: ks.ssd_scan(*args, chunk=chunk), flush, runs=runs)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            ks.ssd_scan(*args, chunk=chunk)
            torch.cuda.synchronize()
        passes = {e.key[:60]: e.self_device_time_total / 1e3 for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA and "ssd_wgmma_bf16" in e.key}
        b, l, h, p, g, n = shape
        nbytes = sum(t.numel() * t.element_size() for t in args) + args[0].numel() * 2 + b * h * p * n * 4  # + y, h_final
        emit({"case": name, "b_l_h_p_g_n": list(shape), "chunk": chunk, "ms": ms, "passes_ms": passes,
              **cs.k4_blocks(b, l, h, chunk, torch.bfloat16, dev),
              **cs.bound(nbytes, cs.ssd_ops(b, l, h, p, n, chunk), cs.BF16_TC_OPS_PER_S, torch.cuda.get_device_name(0))})
        del args
        cs.release_card()


def pass_times(cs, ks, shapes, label: str) -> None:
    """``time_ms`` of a call and each pass's device time from one traced call, at ``shapes``."""
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda", 0)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(11)
    for name, shape, chunk in shapes:
        args = cs.ssd_inputs(gen, *shape, torch.bfloat16, dev)
        ms = cs.time_ms(lambda: ks.ssd_scan(*args, chunk=chunk), flush, runs=5 if shape[1] > 4096 else 30)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            ks.ssd_scan(*args, chunk=chunk)
            torch.cuda.synchronize()
        passes = {("A" if ", false>" in e.key else "B"): e.self_device_time_total / 1e3 for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA and "ssd_wgmma_bf16" in e.key}
        emit({"kernel": label, "case": name, "b_l_h_p_g_n": list(shape), "ms": ms, "passes_ms": passes})
        del args
        cs.release_card()


def edit(text: str, old: str, new: str, what: str) -> str:
    """``text`` with the one place that reads ``old`` (each line's leading
    whitespace aside) replaced by ``new``."""
    pattern = r"[ \t]*" + r"\n[ \t]*".join(re.escape(line.strip()) for line in old.strip("\n").split("\n"))
    found = re.findall(pattern, text)
    if len(found) != 1:
        raise RuntimeError(f"{what}: the edit's anchor is in ssd_scan.cu {len(found)} times, not once")
    return re.sub(pattern, lambda _: new, text)


def ablate(names: list[str]) -> None:
    runs = [("kernel", str(ROOT / "src"))]
    with tempfile.TemporaryDirectory() as tmp:
        for label, edits in ABLATIONS.items():
            if names and label not in names:
                continue
            root = pathlib.Path(tmp, label)
            shutil.copytree(ROOT / "src", root / "src", ignore=shutil.ignore_patterns("__pycache__"))
            cu = root / "src" / "repro_torch" / "kernels" / "csrc" / "ssd_scan.cu"
            text = cu.read_text()
            for old, new in edits:
                text = edit(text, old, new, label)
            cu.write_text(text)
            runs.append((label, str(root / "src")))
        if names:  # kernel, copy, copy, kernel
            runs = [r for copy in runs[1:] for r in (runs[0], copy, copy)] + runs[:1]
        for label, src in runs:
            subprocess.run([sys.executable, __file__, "--ablate-one", src, label], check=True)


def gate(src: str, label: str) -> None:
    """The bars' readings of the kernel built from ``src`` at GATE_CASES."""
    cs, ks = smoke(ROOT, src)
    dev = torch.device("cuda", 0)
    for name, shape, chunk in GATE_CASES:
        for draw in (cs.ssd_inputs, cs.ssd_inputs_long_memory):
            args = draw(torch.Generator(device="cpu").manual_seed(5), *shape, torch.bfloat16, dev)
            emit({"kernel": label, "case": name, "draw": draw.__name__, "b_l_h_p_g_n": list(shape), "chunk": chunk,
                  **cs.k4_blocks(shape[0], shape[1], shape[2], chunk, torch.bfloat16, dev),
                  **reading(cs, ks, args, chunk)})


def faults() -> None:
    runs = [("kernel", str(ROOT / "src"))]
    with tempfile.TemporaryDirectory() as tmp:
        for fault, (old, new) in FAULTS.items():
            root = pathlib.Path(tmp, fault)
            shutil.copytree(ROOT / "src", root / "src", ignore=shutil.ignore_patterns("__pycache__"))
            cu = root / "src" / "repro_torch" / "kernels" / "csrc" / "ssd_scan.cu"
            cu.write_text(edit(cu.read_text(), old, new, fault))
            runs.append((fault, str(root / "src")))
        for label, src in runs:
            subprocess.run([sys.executable, __file__, "--gate", src, label], check=True)


def phases(root: pathlib.Path) -> None:
    cs, _ = smoke(root)
    dev = torch.device("cuda", 0)
    summary = cs.kernel_summary()
    smi = cs.phase_device()
    cs.phase_build()
    cs.phase_ssd(dev, summary, smi)
    for key in cs.LONG_K4:  # (arch, shape); an older chip_smoke.py keys it by the arch alone
        cs.long_k4(dev, summary, smi, *(key if isinstance(key, tuple) else (key,)))
        cs.release_card()


def host(root: pathlib.Path) -> None:
    cs, ks = smoke(root)
    dev = torch.device("cuda", 0)
    cs.phase_build()
    args = cs.ssd_inputs(torch.Generator(device=dev).manual_seed(11), 8, 512, 48, 64, 1, 128, torch.bfloat16, dev)
    ks.ssd_scan(*args, chunk=256)
    emit({"checkout": str(root), "wrapper_host_ms": cs.host_ms(lambda: ks.ssd_scan(*args, chunk=256), dev),
          "at": "(8,512,48,64), chunk 256, card idle"})


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("k4_wgmma: torch sees no CUDA device", file=sys.stderr)
        return 2
    if not argv:
        build_log()
    elif argv[0] == "--check":
        check()
    elif argv[0] == "--times":
        times()
    elif argv[0] == "--faults":
        faults()
    elif argv[0] == "--ablate":
        ablate(argv[1:])
    elif argv[0] == "--ablate-one":
        cs, ks = smoke(ROOT, argv[1])  # the first call builds the copy's kernels
        pass_times(cs, ks, [TIMED[3], TIMED[2], TIMED[0]], argv[2])
    elif argv[0] == "--gate":
        gate(argv[1], argv[2])
    elif argv[0] == "--phases":
        phases(pathlib.Path(argv[1]).resolve() if len(argv) > 1 else ROOT)
    elif argv[0] == "--host":
        for root in argv[1:]:
            subprocess.run([sys.executable, __file__, "--host-one", root], check=True)
    elif argv[0] == "--host-one":
        host(pathlib.Path(argv[1]).resolve())
    else:
        print(__doc__, file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    os.environ.setdefault("PYTHONUNBUFFERED", "1")
    sys.exit(main(sys.argv[1:]))
