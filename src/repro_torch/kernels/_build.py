"""Build and bind the hand-written CUDA kernels in ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first use
by ``nvcc`` into its own shared library under ``build/kernels/`` at the root
of the checkout, then bound with ``ctypes``.  All sources are compiled
together, one ``nvcc`` process each, so the build costs the time of the
slowest file.  A library's file name carries a hash of its source, so an
edited source is rebuilt and a stale library is never loaded.

Every library also exports ``const char* error_string(int)`` so that a
launch function's ``cudaError_t`` can be raised with its message.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
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


def _target(src: pathlib.Path) -> pathlib.Path:
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}-{digest}.so"


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


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch function returned a non-zero ``cudaError_t``."""
    if err != 0:
        msg = lib.error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
