"""The port's SSD scan against the JAX package's Pallas kernel and its
chunked reference.

The same x, dt, a, b and c, made from a seed with numpy, go through
``repro.kernels.ssd_scan.ssd_scan(..., interpret=True)`` and through
``repro_torch.kernels.ops.ssd_scan`` on CPU tensors, which runs
``ssd_scan_plain``: the Pallas body chunk by chunk, the same function the
CUDA kernel is held to on the card.  The shapes are the reference sweep's
(``tests/test_kernels.py``), and so is the tolerance: 3e-5 (f32) and 6e-2
(bf16), as both atol and rtol, on y and on the final state.

The bf16 CUDA kernel meets the tensor cores with bf16 operands only: the
f32 scores, state and x * w go in as sums of bf16 pieces.  Its arithmetic
is rehearsed here with the plain scan, each such operand replaced by the
f32 sum of its pieces, and held to the same bars, y 6e-2 and h_final 3e-5.
"""

import pathlib
import re

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssd_scan import ssd_scan as pallas_ssd  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ssd_scan as ks  # noqa: E402
from torch_parity import reference_stack  # noqa: E402,F401

TOL = {"float32": 3e-5, "bfloat16": 6e-2}
SWEEP = [  # b, l, h, p, g, n, chunk
    (1, 128, 2, 32, 1, 16, 32),
    (2, 256, 4, 64, 2, 32, 64),
    (1, 256, 4, 64, 4, 128, 128),  # mamba2-780m-like head
    (2, 512, 8, 64, 1, 64, 128),
]


SERVING_HEAD = (1, 512, 1, 64, 1, 128, 256)  # one head of Mamba2-780m's prefill: chunk 256
KERNEL_SOURCE = pathlib.Path(ks.__file__).parent / "csrc" / "ssd_scan.cu"


def _inputs(b, l, h, p, g, n, seed=0):
    """x ~ N(0, 1), dt = softplus(N(0, 1)), a = -exp(N(0, 1) / 2), b and c
    ~ N(0, 0.3^2): the reference sweep's distributions."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, h, p), dtype=np.float32)
    dt = np.logaddexp(rng.standard_normal((b, l, h), dtype=np.float32), np.float32(0))
    a = -np.exp(rng.standard_normal(h, dtype=np.float32) * np.float32(0.5))
    bm = rng.standard_normal((b, l, g, n), dtype=np.float32) * np.float32(0.3)
    cm = rng.standard_normal((b, l, g, n), dtype=np.float32) * np.float32(0.3)
    return x, dt, a, bm, cm


def _torch(arrays, dtype):
    x, dt, a, bm, cm = (torch.from_numpy(v) for v in arrays)
    tt = getattr(torch, dtype)
    return x.to(tt), dt, a, bm.to(tt), cm.to(tt)


def _jax(arrays, dtype):
    x, dt, a, bm, cm = arrays
    return jnp.asarray(x, dtype), jnp.asarray(dt), jnp.asarray(a), jnp.asarray(bm, dtype), jnp.asarray(cm, dtype)


def _close(got, want, dtype, what):
    got = np.asarray(got.float().numpy() if isinstance(got, torch.Tensor) else got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, atol=TOL[dtype], rtol=TOL[dtype], err_msg=what)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,l,h,p,g,n,chunk", SWEEP)
def test_plain_matches_the_pallas_kernel(b, l, h, p, g, n, chunk, dtype):
    arrays = _inputs(b, l, h, p, g, n)
    want_y, want_h = pallas_ssd(*_jax(arrays, dtype), chunk=chunk, interpret=True)
    launches = ks.ssd_scan.launches
    y, h_final = ops.ssd_scan(*_torch(arrays, dtype), chunk=chunk)
    assert ks.ssd_scan.launches == launches  # CPU tensors: the plain version, no launch
    assert y.dtype == getattr(torch, dtype) and h_final.dtype == torch.float32
    _close(y, want_y, dtype, "y")
    _close(h_final, want_h, dtype, "h_final")


@pytest.mark.parametrize("b,l,h,p,g,n,chunk", [SWEEP[1], SWEEP[3]])
def test_plain_matches_the_chunked_reference(reference_stack, b, l, h, p, g, n, chunk):  # noqa: F811
    from repro.models.ssm import ssd_chunked

    arrays = _inputs(b, l, h, p, g, n, seed=1)
    want_y, want_h = ssd_chunked(*_jax(arrays, "float32"), chunk=chunk)
    y, h_final = ops.ssd_scan(*_torch(arrays, "float32"), chunk=chunk)
    _close(y, want_y, "float32", "y")
    _close(h_final, want_h, "float32", "h_final")


def test_chunk_sums_its_prefix_in_double():
    """cs is the f32 rounding of the float64 running sum of the f32
    products dt * a, the sum the CUDA kernel takes."""
    rng = np.random.default_rng(2)
    da = (rng.standard_normal((3, 256, 5)) - 0.8).astype(np.float32)
    want = np.cumsum(da.astype(np.float64), axis=1).astype(np.float32)
    np.testing.assert_array_equal(ks.chunk_cumsum(torch.from_numpy(da), dim=1).numpy(), want)


def test_the_upper_triangle_never_reaches_the_output():
    """exp(cs_i - cs_j) above the diagonal overflows to inf for steep
    decays; it is selected away, so y and the state stay finite."""
    arrays = list(_inputs(1, 64, 2, 16, 1, 16))
    arrays[1] = np.full_like(arrays[1], 20.0)  # dt * a reaches -1000 within a chunk
    y, h_final = ops.ssd_scan(*_torch(arrays, "float32"), chunk=64)
    assert torch.isfinite(y).all() and torch.isfinite(h_final).all()


def test_raises_where_the_reference_asserts():
    x, dt, a, bm, cm = _torch(_inputs(1, 64, 4, 16, 1, 16), "float32")
    with pytest.raises(ValueError, match="multiple of groups"):
        ops.ssd_scan(x, dt, a, bm.expand(1, 64, 3, 16), cm.expand(1, 64, 3, 16), chunk=32)
    with pytest.raises(ValueError, match="multiple of chunk"):
        ops.ssd_scan(x, dt, a, bm, cm, chunk=48)
    with pytest.raises(TypeError, match="float32"):
        ops.ssd_scan(x, dt.double(), a, bm, cm, chunk=32)


def test_a_tensor_on_neither_the_cpu_nor_cuda_raises():
    x, dt, a, bm, cm = (t.to("meta") for t in _torch(_inputs(1, 32, 2, 16, 1, 16), "float32"))
    launches = ks.ssd_scan.launches
    with pytest.raises(ValueError, match="CPU or a CUDA device"):
        ops.ssd_scan(x, dt, a, bm, cm, chunk=16)
    assert ks.ssd_scan.launches == launches


@pytest.mark.parametrize(
    "dtype,p,n,route",
    [(torch.bfloat16, p, n, "tc_bf16") for p in (16, 32, 48, 64) for n in (16, 128)]
    + [(torch.float32, 64, 128, "cuda_f32"), (torch.float32, 16, 48, "cuda_f32")],
)
def test_the_dtype_picks_the_cuda_kernel(dtype, p, n, route):
    assert ks.kernel_route(dtype, p, n) == route


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("p,n,match", [(128, 128, "head_dim"), (80, 64, "head_dim"), (64, 144, "d_state"), (64, 40, "d_state")])
def test_the_cuda_route_raises_for_shapes_the_kernels_do_not_take(dtype, p, n, match):
    """The wrapper calls ``kernel_route`` before it launches on a CUDA
    tensor; on the CPU, where no kernel launches, it raises all the same."""
    with pytest.raises(ValueError, match=match):
        ks.kernel_route(dtype, p, n)


def test_the_cuda_route_raises_for_other_dtypes():
    with pytest.raises(TypeError):
        ks.kernel_route(torch.float16, 64, 128)


def _pieces(t, k):
    """The f32 sum of ``k`` bf16 pieces of ``t``: hi = bf16(t), then the
    bf16 of each remainder (round to nearest even, as ``__floats2bfloat162_rn``)."""
    out, rest = torch.zeros_like(t), t
    for _ in range(k):
        piece = rest.to(torch.bfloat16).float()
        out, rest = out + piece, rest - piece
    return out


def _split_scan(x, dt, a, b, c, chunk, xw_pieces):
    """``ssd_scan_plain`` with the scores S and the state h as hi + lo and
    x * w as ``xw_pieces`` pieces where they meet the tensor cores."""
    bsz, l, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    hg, nc = h // g, l // chunk
    xf = x.float().reshape(bsz, nc, chunk, g, hg, p)
    dtf = dt.reshape(bsz, nc, chunk, g, hg)
    bf, cf = (t.float().reshape(bsz, nc, chunk, g, n) for t in (b, c))
    idx = torch.arange(chunk)
    lower = (idx[:, None] >= idx[None, :])[None, :, :, None, None]
    state = torch.zeros((bsz, g, hg, p, n))
    ys = []
    for ci in range(nc):
        xc, dtc, bc, cc = xf[:, ci], dtf[:, ci], bf[:, ci], cf[:, ci]
        cs = ks.chunk_cumsum(dtc * a.reshape(g, hg), dim=1)
        el = torch.where(lower, torch.exp(cs[:, :, None] - cs[:, None, :]), 0.0)
        scores = _pieces(torch.einsum("bign,bjgn->bijg", cc, bc)[..., None] * el * dtc[:, None], 2)
        y = torch.einsum("bijgk,bjgkp->bigkp", scores, xc)
        y = y + torch.exp(cs)[..., None] * torch.einsum("bign,bgkpn->bigkp", cc, _pieces(state, 2))
        xw = _pieces(xc * (torch.exp(cs[:, -1:] - cs) * dtc)[..., None], xw_pieces)
        state = state * torch.exp(cs[:, -1])[..., None, None] + torch.einsum("bqgkp,bqgn->bgkpn", xw, bc)
        ys.append(y.reshape(bsz, chunk, h, p).to(x.dtype))
    return torch.cat(ys, dim=1), state.reshape(bsz, h, p, n)


@pytest.mark.parametrize("b,l,h,p,g,n,chunk", SWEEP + [SERVING_HEAD])
def test_the_bf16_kernels_split_products_hold_the_bars(b, l, h, p, g, n, chunk):
    """The bf16 kernel's pieces, rehearsed on the CPU: S and h as hi + lo,
    x * w as the kernel's ``kXwPieces``; y within 6e-2 and h_final within
    3e-5 of the plain version."""
    xw_pieces = int(re.search(r"constexpr int kXwPieces = (\d+);", KERNEL_SOURCE.read_text()).group(1))
    assert xw_pieces == 3
    args = _torch(_inputs(b, l, h, p, g, n), "bfloat16")
    want_y, want_h = ks.ssd_scan_plain(*args, chunk=chunk)
    y, h_final = _split_scan(*args, chunk, xw_pieces)
    _close(y, want_y.float().numpy(), "bfloat16", "y")
    np.testing.assert_allclose(h_final.numpy(), want_h.numpy(), atol=TOL["float32"], rtol=TOL["float32"], err_msg="h_final")
