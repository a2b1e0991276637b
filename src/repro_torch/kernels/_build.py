"""Build and bind the hand-written CUDA kernels in ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first use
by ``nvcc`` into its own shared library under ``build/kernels/`` at the root
of the checkout, then bound with ``ctypes``.  All sources are compiled
together, one ``nvcc`` process each, so the build costs the time of the
slowest file.  A library's file name carries a hash of its source and of
the ``csrc/`` headers it includes (``#include "name.cuh"``, followed
through headers), so an edited source or header is rebuilt and a stale
library is never loaded.

Every library also exports ``const char* error_string(int)`` so that a
launch function's ``cudaError_t`` can be raised with its message.  The
compiler's output is kept beside each library (``<name>-<hash>.log``);
``ptxas(name)`` reads each kernel's registers and spills from it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import threading
import time

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found is None:
        from torch.utils.cpp_extension import CUDA_HOME  # the toolkit torch would use

        candidate = pathlib.Path(CUDA_HOME or "", "bin", "nvcc")
        found = str(candidate) if CUDA_HOME and candidate.is_file() else None
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build csrc/*.cu")
    return found


_LOCAL_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _sources(src: pathlib.Path) -> list[pathlib.Path]:
    """``src`` and the headers beside it that it includes, directly or
    through another such header, each once, in the order first reached."""
    seen = [src]
    for path in seen:
        for name in _LOCAL_INCLUDE.findall(path.read_text()):
            header = path.parent / name
            if header.is_file() and header not in seen:
                seen.append(header)
    return seen


def _target(src: pathlib.Path) -> pathlib.Path:
    digest = hashlib.sha256()
    for path in _sources(src):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"{src.stem}-{digest.hexdigest()[:16]}.so"


def build_all() -> tuple[float, str]:
    """Compile every stale ``csrc/*.cu`` in parallel; returns the seconds
    spent and the compiler's output (``ptxas`` reports each kernel's
    registers, shared memory and spills).

    Raises ``RuntimeError`` with the compiler's output when a build fails."""
    with _lock:
        return _build_locked()


def _build_locked() -> tuple[float, str]:
    t0 = time.monotonic()
    todo = [(s, _target(s)) for s in sorted(CSRC.glob("*.cu"))]
    todo = [(s, t) for s, t in todo if not t.is_file()]
    if not todo:
        return 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for src, target in todo:
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((target, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    failures, logs = [], []
    for target, tmp, proc in procs:
        out, _ = proc.communicate()
        logs.append(f"{target.name}:\n{out}")
        target.with_suffix(".log").write_text(out)
        if proc.returncode != 0:
            failures.append(f"{target.name}: nvcc exited {proc.returncode}\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, target)
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return time.monotonic() - t0, "\n".join(logs)


def library(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (built on first use)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _build_locked()
            lib = ctypes.CDLL(str(_target(CSRC / f"{name}.cu")))
            lib.error_string.argtypes = [ctypes.c_int]
            lib.error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def _kernel_name(mangled: str) -> str:
    """``_ZN..2wg13fa_wgmma_bf16ILi128ELi128ELb0EE...`` →
    ``fa_wgmma_bf16<128,128,false>``: the last name of a nested mangled
    name and its integer and bool template arguments."""
    rest = mangled[3:] if mangled.startswith("_ZN") else mangled
    name = mangled
    while (m := re.match(r"\d+", rest)):
        n = int(m.group(0))
        name, rest = rest[m.end():m.end() + n], rest[m.end() + n:]
    args = re.match(r"I((?:L[ib]\d+E)+)E", rest)
    if args is None:
        return name
    values = [v if kind == "i" else ("false", "true")[int(v)] for kind, v in re.findall(r"L([ib])(\d+)E", args.group(1))]
    return name + "<" + ",".join(values) + ">"


def ptxas(name: str) -> dict[str, dict[str, int]]:
    """Registers and spill bytes of each kernel in ``csrc/<name>.cu``'s
    library, from ``ptxas -v``: ``{"kernel<template args>": {"registers",
    "spill_stores", "spill_loads"}}``; empty if it was not built here."""
    log = _target(CSRC / f"{name}.cu").with_suffix(".log")
    out: dict[str, dict[str, int]] = {}
    entry = None
    for line in log.read_text().splitlines() if log.is_file() else ():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = _kernel_name(m.group(1))
            out[entry] = {}
            continue
        if entry is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[entry].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[entry]["registers"] = int(m.group(1))
    return out


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch function returned a non-zero ``cudaError_t``."""
    if err != 0:
        msg = lib.error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
