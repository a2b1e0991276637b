"""Tolerances shared by the tests that hold ``repro_torch`` to ``repro``.

bf16 output may differ by one bf16 ulp (the two frameworks may round an
intermediate at another place); f32 output by 2e-5 absolute, the kernel
suite's f32 bar (``tests/test_kernels.py``).
"""

import numpy as np

F32_ATOL = 2e-5


def _bf16_order(a: np.ndarray) -> np.ndarray:
    """bf16 values (held exactly in f32) as integers in value order."""
    bits = (np.ascontiguousarray(a, np.float32).view(np.uint32) >> 16).astype(np.int64)
    mag = bits & 0x7FFF
    return np.where(bits & 0x8000, -mag, mag)


def assert_bf16_within_ulp(got, want, ulps: int = 1) -> None:
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    steps = np.abs(_bf16_order(got) - _bf16_order(want))
    assert steps.max(initial=0) <= ulps, f"{int(steps.max())} bf16 ulps apart"


def assert_f32_close(got, want) -> None:
    np.testing.assert_allclose(
        np.asarray(got, np.float32), np.asarray(want, np.float32), rtol=0, atol=F32_ATOL
    )
