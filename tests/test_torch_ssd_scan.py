"""The port's SSD scan against the JAX package's Pallas kernel and its
chunked reference.

The same x, dt, a, b and c, made from a seed with numpy, go through
``repro.kernels.ssd_scan.ssd_scan(..., interpret=True)`` and through
``repro_torch.kernels.ops.ssd_scan`` on CPU tensors, which runs
``ssd_scan_plain``: the Pallas body chunk by chunk, the same function the
CUDA kernel is held to on the card.  The shapes are the reference sweep's
(``tests/test_kernels.py``), and so is the tolerance: 3e-5 (f32) and 6e-2
(bf16), as both atol and rtol, on y and on the final state.  On a
long-memory draw (heads whose state lasts; y and the state then scale with
dt, far under those atols) both are also held to a scale-aware bar: max
|got - want| over max |want| of y in each (batch, head, chunk) and of the
state in each (batch, head), ``REL``.

The bf16 CUDA kernel meets the tensor cores with bf16 operands only: the
f32 scores, state and x * w go in as sums of bf16 pieces; and where batch x
heads blocks would not fill the card it splits each sequence's chunks into
segments (``segment_plan``), scans each segment but the last from a zero
state, and walks each from the state the ones before it carry.  Both are
rehearsed here with the plain scan and held to the same bars, y 6e-2 and
h_final 3e-5.
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
# Long-memory draws, plain against Pallas (interpret mode): y read at most 4.4e-7 (f32) and 2.3e-3 (bf16:
# both sides round y to bf16, and a value can round the other way) of its chunk's largest value, the
# state 3.5e-7 of its largest
REL = {"float32": 1e-5, "bfloat16": 2.0**-7}
STATE_REL = 1e-5
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


def _inputs_long_memory(b, l, h, p, g, n, seed=0):
    """Heads that keep their state: per head dt |a| log-uniform on [1e-6,
    1e-1] and a = -U[1, 16] (Mamba2's A init), dt = that over |a| times
    U[0.5, 1.5] a step; x ~ N(0, 1), b and c ~ N(0, 0.3^2)."""
    rng = np.random.default_rng(seed)
    rate = 10.0 ** rng.uniform(-6, -1, h)
    a = -rng.uniform(1, 16, h)
    dt = rate / -a * rng.uniform(0.5, 1.5, (b, l, h))
    x = rng.standard_normal((b, l, h, p))
    bm = rng.standard_normal((b, l, g, n)) * 0.3
    cm = rng.standard_normal((b, l, g, n)) * 0.3
    return tuple(v.astype(np.float32) for v in (x, dt, a, bm, cm))


DRAWS = {"sweep": _inputs, "long_memory": _inputs_long_memory}


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


def _rel(got, want, chunk=None):
    """max |got - want| over max |want| of each (batch, head, chunk) of y
    (B, L, H, P), or of each (batch, head) of a state (B, H, P, N); the largest."""
    got = np.asarray(got.float().numpy() if isinstance(got, torch.Tensor) else got, np.float32)
    want = np.asarray(want, np.float32)
    if chunk is None:
        axes = (2, 3)
    else:
        b, l, h, p = got.shape
        got, want, axes = got.reshape(b, l // chunk, chunk, h, p), want.reshape(b, l // chunk, chunk, h, p), (2, 4)
    return float((np.abs(got - want).max(axis=axes) / np.maximum(np.abs(want).max(axis=axes), 1e-30)).max())


@pytest.mark.parametrize("draw", sorted(DRAWS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,l,h,p,g,n,chunk", SWEEP)
def test_plain_matches_the_pallas_kernel(b, l, h, p, g, n, chunk, dtype, draw):
    arrays = DRAWS[draw](b, l, h, p, g, n)
    want_y, want_h = pallas_ssd(*_jax(arrays, dtype), chunk=chunk, interpret=True)
    launches = ks.ssd_scan.launches
    y, h_final = ops.ssd_scan(*_torch(arrays, dtype), chunk=chunk)
    assert ks.ssd_scan.launches == launches  # CPU tensors: the plain version, no launch
    assert y.dtype == getattr(torch, dtype) and h_final.dtype == torch.float32
    _close(y, want_y, dtype, "y")
    _close(h_final, want_h, dtype, "h_final")
    if draw == "long_memory":  # where the carried state is most of y and of the final state
        assert _rel(y, np.asarray(want_y, np.float32), chunk) <= REL[dtype]
        assert _rel(h_final, want_h) <= STATE_REL


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
    [(torch.bfloat16, p, n, "wgmma_bf16") for p in (16, 32, 48, 64) for n in (16, 128)]
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


def _walk(x, dt, a, b, c, chunk, h0, xw_pieces=None):
    """``ssd_scan_plain``'s chunk walk from the state ``h0`` (B, G, H/G, P,
    N); with ``xw_pieces``, the scores S and the state h as hi + lo and x *
    w as ``xw_pieces`` pieces where they meet the tensor cores.  Returns y,
    the state after the last chunk and its log-decay: the chunks' f32
    cs_last summed in float64."""
    bsz, l, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    hg, nc = h // g, l // chunk
    split = (lambda v, k: _pieces(v, k)) if xw_pieces else (lambda v, k: v)
    xf = x.float().reshape(bsz, nc, chunk, g, hg, p)
    dtf = dt.reshape(bsz, nc, chunk, g, hg)
    bf, cf = (t.float().reshape(bsz, nc, chunk, g, n) for t in (b, c))
    idx = torch.arange(chunk)
    lower = (idx[:, None] >= idx[None, :])[None, :, :, None, None]
    state, decay = h0, torch.zeros((bsz, g, hg), dtype=torch.float64)
    ys = []
    for ci in range(nc):
        xc, dtc, bc, cc = xf[:, ci], dtf[:, ci], bf[:, ci], cf[:, ci]
        cs = ks.chunk_cumsum(dtc * a.reshape(g, hg), dim=1)
        el = torch.where(lower, torch.exp(cs[:, :, None] - cs[:, None, :]), 0.0)
        scores = split(torch.einsum("bign,bjgn->bijg", cc, bc)[..., None] * el * dtc[:, None], 2)
        y = torch.einsum("bijgk,bjgkp->bigkp", scores, xc)
        y = y + torch.exp(cs)[..., None] * torch.einsum("bign,bgkpn->bigkp", cc, split(state, 2))
        xw = split(xc * (torch.exp(cs[:, -1:] - cs) * dtc)[..., None], xw_pieces)
        state = state * torch.exp(cs[:, -1])[..., None, None] + torch.einsum("bqgkp,bqgn->bgkpn", xw, bc)
        decay = decay + cs[:, -1].double()
        ys.append(y.reshape(bsz, chunk, h, p).to(x.dtype))
    return torch.cat(ys, dim=1), state, decay


def _segmented(x, dt, a, b, c, chunk, segments, xw_pieces=None):
    """The bf16 kernel's split of the chunks into ``segments``: each segment
    but the last scanned from a zero state to its local state h_loc and
    log-decay D (the first pass), the carry h_in(s) = exp(D(s-1)) h_in(s-1)
    + h_loc(s-1) in f32, and each segment walked from its h_in (the
    second).  Returns y and the last segment's final state."""
    bsz, l, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    zero = torch.zeros((bsz, g, h // g, p, n))
    bounds = ks.segment_bounds(l // chunk, segments)
    part = [tuple(t[:, k0 * chunk:k1 * chunk] for t in (x, dt, b, c)) for k0, k1 in bounds]
    h_in, ys = zero, []
    for s, (xs, dts, bs, cs_) in enumerate(part):
        y, state, _ = _walk(xs, dts, a, bs, cs_, chunk, h_in, xw_pieces)
        ys.append(y)
        if s < segments - 1:  # what the first pass gives, and the carry
            _, h_loc, decay = _walk(xs, dts, a, bs, cs_, chunk, zero, xw_pieces)
            h_in = h_in * torch.exp(decay).float()[..., None, None] + h_loc
    return torch.cat(ys, dim=1), state.reshape(bsz, h, p, n)


@pytest.mark.parametrize("b,l,h,p,g,n,chunk", SWEEP + [SERVING_HEAD])
def test_the_bf16_kernels_split_products_hold_the_bars(b, l, h, p, g, n, chunk):
    """The bf16 kernel's pieces, rehearsed on the CPU: S and h as hi + lo,
    x * w as the kernel's ``kXwPieces``, the chunks in the segments
    ``segment_plan`` gives the shape on an H100; y within 6e-2 and h_final
    within 3e-5 of the plain version."""
    xw_pieces = int(re.search(r"constexpr int kXwPieces = (\d+);", KERNEL_SOURCE.read_text()).group(1))
    assert xw_pieces == 3
    args = _torch(_inputs(b, l, h, p, g, n), "bfloat16")
    want_y, want_h = ks.ssd_scan_plain(*args, chunk=chunk)
    y, h_final = _segmented(*args, chunk, ks.segment_plan(b, h, l // chunk), xw_pieces)
    _close(y, want_y.float().numpy(), "bfloat16", "y")
    np.testing.assert_allclose(h_final.numpy(), want_h.numpy(), atol=TOL["float32"], rtol=TOL["float32"], err_msg="h_final")


@pytest.mark.parametrize("segments", [1, 2, 3, 8])
def test_segments_carry_the_state(segments):
    """The split into segments (a first pass of local states from zero,
    the carry, the walk from each h_in), in f32 on a long-memory draw, at
    the plain version's bar: y and h_final within 3e-5 and within 1e-5 of
    each chunk's (each state's) largest value.  8 chunks: 3 segments do not
    divide them, 8 is one chunk a segment."""
    b, l, h, p, g, n, chunk = 2, 512, 4, 32, 2, 32, 64
    args = _torch(_inputs_long_memory(b, l, h, p, g, n, seed=3), "float32")
    want_y, want_h = ks.ssd_scan_plain(*args, chunk=chunk)
    y, h_final = _segmented(*args, chunk, segments)
    _close(y, want_y.numpy(), "float32", "y")
    _close(h_final, want_h.numpy(), "float32", "h_final")
    assert _rel(y, want_y.numpy(), chunk) <= REL["float32"]
    assert _rel(h_final, want_h.numpy()) <= STATE_REL


def test_segments_the_carry_is_visible_on_long_memory():
    """The long-memory draw is what makes the carry matter: dropping it
    moves y by over half of some chunk's largest value, which SSD_TOL's
    atol alone would not see there."""
    b, l, h, p, g, n, chunk = 1, 512, 4, 32, 1, 32, 64
    args = _torch(_inputs_long_memory(b, l, h, p, g, n, seed=3), "float32")
    want_y, _ = ks.ssd_scan_plain(*args, chunk=chunk)
    x, dt, a, bm, cm = args
    zero = torch.zeros((b, g, h // g, p, n))
    half = (l // chunk // 2) * chunk
    tail, _, _ = _walk(x[:, half:], dt[:, half:], a, bm[:, half:], cm[:, half:], chunk, zero)  # the carry dropped
    assert _rel(tail, want_y[:, half:].numpy(), chunk) > 0.5


@pytest.mark.parametrize("bsz,heads,chunks,want", [
    (8, 48, 2, 1),  # Mamba2-780m serving (8 x 512, chunk 256): 384 blocks fill the card
    (2, 256, 128, 1),  # Jamba-1.5-large's prefill_32k scan: 512 blocks
    (1, 48, 2048, 11),  # Mamba2-780m's long_500k: 528 blocks, four whole waves
    (1, 48, 2, 2),  # a serving row alone: a chunk a segment
    (1, 48, 100, 8),  # long_memory_segments in chip_smoke: 8 does not divide 100
    (2, 4, 100, 15),  # long_memory_ragged and long_memory_n64 in chip_smoke (chunk 40)
    (1, 1, 1, 1),  # one chunk: nothing to split
])
def test_segment_plan(bsz, heads, chunks, want):
    assert ks.segment_plan(bsz, heads, chunks) == want


@pytest.mark.parametrize("bsz,heads", [(1, 1), (1, 3), (1, 48), (2, 4), (1, 131), (2, 100)])
@pytest.mark.parametrize("chunks", [1, 2, 5, 37, 2048])
def test_segment_plan_keeps_every_segment_a_chunk(bsz, heads, chunks):
    """1 <= S <= chunks, every segment at least one chunk, the bounds cover
    the chunks in order; S is 1 where bsz x heads fills two waves."""
    s = ks.segment_plan(bsz, heads, chunks)
    assert 1 <= s <= chunks
    bounds = ks.segment_bounds(chunks, s)
    assert bounds[0][0] == 0 and bounds[-1][1] == chunks
    assert all(k1 > k0 for k0, k1 in bounds) and all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    assert ks.segment_plan(bsz, heads * 264, chunks) == 1
