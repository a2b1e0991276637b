"""The port's flash attention against the JAX package's Pallas kernel.

The same q, k and v, made from a seed with numpy, go through
``repro.kernels.flash_attention.flash_attention(..., interpret=True)`` and
through ``repro_torch.kernels.ops.flash_attention`` on CPU tensors, which
runs ``flash_attention_plain``: the Pallas body's key-tile loop, the same
function the CUDA kernel is held to on the card.  Tolerance: the kernel
suite's ``TOL`` (``tests/test_kernels.py``), f32 2e-5 and bf16 2e-2, as
both atol and rtol.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import flash_attention as pallas_flash  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from torch_parity import odd_positions, reference_stack  # noqa: E402,F401

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _qkv(b, h, hkv, sq, skv, hd, seed=0):
    rng = np.random.default_rng(seed)
    return [
        rng.standard_normal(shape, dtype=np.float32)
        for shape in ((b, h, sq, hd), (b, hkv, skv, hd), (b, hkv, skv, hd))
    ]


def _both(arrays, dtype, **kw):
    want = pallas_flash(*(jnp.asarray(a, dtype=dtype) for a in arrays), interpret=True, **kw)
    got = ops.flash_attention(*(torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays), **kw)
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == arrays[0].shape
    return got.float().numpy(), np.asarray(want, np.float32)


@pytest.mark.parametrize(
    "b,h,hkv,sq,skv,hd",
    [
        (2, 4, 4, 256, 256, 64),  # MHA
        (2, 8, 2, 256, 256, 64),  # GQA 4:1
        (1, 4, 1, 128, 384, 128),  # sq < skv: q right-aligned to kv
        (1, 2, 2, 384, 384, 128),  # non-power-of-two block count
    ],
)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_matches_pallas(b, h, hkv, sq, skv, hd, dtype, causal):
    got, want = _both(_qkv(b, h, hkv, sq, skv, hd), dtype, causal=causal)
    np.testing.assert_allclose(got, want, atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("bq,bk", [(128, 128), (384, 128), (128, 384), (384, 384), (32, 64), (96, 192)])
def test_plain_matches_pallas_across_block_shapes(bq, bk):
    arrays = _qkv(1, 2, 2, 384, 384, 64, seed=1)
    got, want = _both(arrays, "float32", causal=True, block_q=bq, block_k=bk)
    np.testing.assert_allclose(got, want, atol=TOL["float32"], rtol=TOL["float32"], err_msg=f"({bq},{bk})")


def test_the_key_tile_sets_where_p_is_rounded():
    """In bf16, p is rounded to v's dtype per key tile against the tile's
    running max, so two tile sizes give (slightly) different results; the
    plain version follows the Pallas body in both."""
    arrays = _qkv(1, 2, 1, 256, 256, 64, seed=2)
    a, want_a = _both(arrays, "bfloat16", causal=True, block_q=64, block_k=64)
    b, want_b = _both(arrays, "bfloat16", causal=True, block_q=256, block_k=256)
    assert not np.array_equal(want_a, want_b)
    np.testing.assert_allclose(a, want_a, atol=TOL["bfloat16"], rtol=TOL["bfloat16"])
    np.testing.assert_allclose(b, want_b, atol=TOL["bfloat16"], rtol=TOL["bfloat16"])


def _t(*shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype)


@pytest.mark.parametrize(
    "q,k,kw,match",
    [
        (_t(1, 3, 8, 32), _t(1, 2, 8, 32), {}, "multiple of kv heads"),  # h % hkv
        (_t(1, 2, 16, 32), _t(1, 2, 8, 32), {"block_q": 8, "block_k": 8}, "sq <= skv"),  # causal, sq > skv
        (_t(1, 2, 24, 32), _t(1, 2, 24, 32), {"block_q": 16, "block_k": 8}, "multiples"),  # sq % block_q
        (_t(1, 2, 24, 32), _t(1, 2, 24, 32), {"block_q": 8, "block_k": 16}, "multiples"),  # skv % block_k
        (_t(1, 2, 8, 32), _t(1, 2, 8, 16), {"block_q": 8, "block_k": 8}, "k and v"),  # head dims differ
    ],
)
def test_wrapper_raises_where_the_reference_asserts(q, k, kw, match):
    with pytest.raises(ValueError, match=match):
        ops.flash_attention(q, k, k, **kw)


def test_non_causal_accepts_sq_above_skv():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 2, 16, 8, 32))
    out = ops.flash_attention(q, k, v, causal=False, block_q=8, block_k=8)
    assert out.shape == q.shape and torch.isfinite(out).all()


def test_mixed_or_unsupported_dtypes_raise():
    q = _t(1, 2, 8, 32)
    with pytest.raises(TypeError):
        ops.flash_attention(q, q.bfloat16(), q, block_q=8, block_k=8)
    with pytest.raises(TypeError):
        ops.flash_attention(q.half(), q.half(), q.half(), block_q=8, block_k=8)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    before = fa.flash_attention.launches
    q = torch.from_numpy(_qkv(1, 2, 2, 16, 16, 32)[0])
    ops.flash_attention(q, q, q, block_q=8, block_k=8)
    assert fa.flash_attention.launches == before


@pytest.mark.parametrize(
    "dtype,hd,block_k,route",
    [
        (torch.bfloat16, 128, 128, "wgmma_bf16"),  # the serving shape
        (torch.bfloat16, 64, 64, "wgmma_bf16"),
        (torch.bfloat16, 32, 128, "wgmma_bf16"),
        (torch.float32, 256, 128, "cuda_f32"),
        (torch.float32, 64, 96, "cuda_f32"),  # the f32 kernel takes any block_k
    ],
)
def test_the_dtype_picks_the_cuda_kernel(dtype, hd, block_k, route):
    assert fa.kernel_route(dtype, hd, block_k) == route


@pytest.mark.parametrize(
    "hd,block_k,match",
    [
        (256, 64, "head_dim"),  # hd 256 stays on the f32 kernel
        (16, 128, "head_dim"),
        (80, 64, "head_dim"),
        (128, 32, "block_k"),
        (128, 256, "block_k"),
        (64, 96, "block_k"),
    ],
)
def test_the_cuda_route_raises_for_what_the_bf16_kernel_does_not_take(hd, block_k, match):
    """The wrapper calls ``kernel_route`` before it launches on a CUDA tensor;
    on the CPU, where no kernel launches, it raises all the same."""
    with pytest.raises(ValueError, match=match):
        fa.kernel_route(torch.bfloat16, hd, block_k)


@pytest.mark.parametrize("hd,block_k,match", [(256, 128, "head_dim"), (48, 64, "head_dim"), (128, 96, "block_k"),
                                               (192, 32, "block_k")])
def test_the_bf16_plan_raises_where_the_route_does(monkeypatch, hd, block_k, match):
    """``wgmma_plan`` reads the kernel's own plan from its library, and
    refuses what the kernel does not take before it builds anything."""
    monkeypatch.setattr(fa, "_lib", lambda: pytest.fail("the library was asked for"))
    with pytest.raises(ValueError, match=match):
        fa.wgmma_plan(hd, block_k)


def test_the_cuda_route_raises_for_other_dtypes():
    with pytest.raises(ValueError, match="head_dim"):
        fa.kernel_route(torch.float32, 48, 64)
    with pytest.raises(TypeError):
        fa.kernel_route(torch.float16, 64, 64)


def test_a_tensor_on_neither_cpu_nor_cuda_raises():
    q = torch.empty((1, 2, 8, 32), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ops.flash_attention(q, q, q, block_q=8, block_k=8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_the_position_mask_matches_the_reference_prefill_mask(reference_stack, dtype):  # noqa: F811
    """With q_pos and kv_pos the plain version masks as the reference's
    ``_plain_attention`` does in its prefill (every segment id 0): rows that
    restart, repeat and reverse their positions, GQA 2:1, over 3 key tiles."""
    from repro.models.attention import _plain_attention

    b, h, hkv, s, hd = 3, 4, 2, 192, 32
    q, k, v = _qkv(b, h, hkv, s, s, hd, seed=2)
    pos = odd_positions(s)
    seg = np.zeros_like(pos)
    as_ref = [jnp.asarray(a, dtype=dtype) for a in (q, k, v)]
    want = _plain_attention(  # (B,Sq,K,G,hd) and (B,Skv,K,hd)
        as_ref[0].reshape(b, hkv, h // hkv, s, hd).transpose(0, 3, 1, 2, 4), as_ref[1].transpose(0, 2, 1, 3),
        as_ref[2].transpose(0, 2, 1, 3), jnp.asarray(pos), jnp.asarray(pos), jnp.asarray(seg), jnp.asarray(seg),
        hd**-0.5,
    )
    want = np.asarray(want, np.float32).transpose(0, 2, 3, 1, 4).reshape(b, h, s, hd)
    t = torch.from_numpy(pos)
    got = ops.flash_attention(*(torch.from_numpy(a).to(getattr(torch, dtype)) for a in (q, k, v)),
                              block_q=64, block_k=64, q_pos=t, kv_pos=t)
    np.testing.assert_allclose(got.float().numpy(), want, atol=TOL[dtype], rtol=TOL[dtype])
    by_index = ops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), block_q=64, block_k=64)
    assert not torch.allclose(by_index, got.float(), atol=1e-2)


def test_increasing_positions_give_the_index_mask_bit_for_bit():
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 4, 2, 128, 128, 32, seed=3))
    pos = torch.arange(128, dtype=torch.int32).expand(2, 128).contiguous()
    by_pos = ops.flash_attention(q, k, v, block_q=64, block_k=64, q_pos=pos, kv_pos=pos)
    assert torch.equal(by_pos, ops.flash_attention(q, k, v, block_q=64, block_k=64))


def test_position_arguments_are_checked():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 2, 64, 64, 32))
    pos = torch.arange(64, dtype=torch.int32)[None]
    with pytest.raises(ValueError, match="together"):
        ops.flash_attention(q, k, v, block_q=64, block_k=64, q_pos=pos)
    with pytest.raises(ValueError, match="causal must be True"):
        ops.flash_attention(q, k, v, causal=False, block_q=64, block_k=64, q_pos=pos, kv_pos=pos)
    with pytest.raises(ValueError, match="int32"):
        ops.flash_attention(q, k, v, block_q=64, block_k=64, q_pos=pos.long(), kv_pos=pos.long())
    with pytest.raises(ValueError, match="kv_pos must be int32"):
        ops.flash_attention(q, k, v, block_q=64, block_k=64, q_pos=pos, kv_pos=pos[:, :32])


@pytest.mark.parametrize("dtype,hd,want", [
    (torch.bfloat16, 16, 32), (torch.bfloat16, 24, 32), (torch.bfloat16, 64, 64), (torch.bfloat16, 160, 192),
    (torch.bfloat16, 256, 256), (torch.float32, 16, 32), (torch.float32, 200, 256), (torch.float32, 512, 512),
])
def test_kernel_head_dim_is_the_smallest_the_kernel_takes(dtype, hd, want):
    assert fa.kernel_head_dim(dtype, hd) == want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [16, 24])
def test_a_head_dim_the_kernel_does_not_take_is_zero_padded(monkeypatch, dtype, hd):
    """The smoke configs' head dims (16; MLA's 24) reach the kernel padded
    to 32 with zeros, a head dim its CUDA route takes, at the scale of the
    real head dim: the prefill's attention equals the unpadded attention,
    which the plain version takes at any head dim, and the Pallas kernel's
    at the real head dim."""
    from repro_torch.models import attention

    seen = []

    def spy(q, k, v, **kw):
        seen.append((q.shape[-1], fa.kernel_route(q.dtype, q.shape[-1], kw["block_k"])))
        return fa.flash_attention(q, k, v, **kw)

    monkeypatch.setattr(attention.ops, "flash_attention", spy)
    b, s, kh, g = 2, 40, 2, 2
    arrays = _qkv(b, kh * g, kh, s, s, hd, seed=hd)
    td = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(a).to(td) for a in arrays)
    got = attention._causal_flash(q.reshape(b, kh, g, s, hd).permute(0, 3, 1, 2, 4), k.transpose(1, 2),
                                  v.transpose(1, 2))
    assert seen == [(32, "wgmma_bf16" if dtype == "bfloat16" else "cuda_f32")]
    monkeypatch.undo()
    assert tuple(got.shape) == (b, s, kh * g, hd) and got.dtype == td
    padded = -s % 64
    want = ops.flash_attention(*(torch.nn.functional.pad(t, (0, 0, 0, padded)) for t in (q, k, v)),
                               block_q=64, block_k=64)[:, :, :s]
    np.testing.assert_allclose(got.transpose(1, 2).float().numpy(), want.float().numpy(), rtol=0,
                               atol=2e-6 if dtype == "float32" else 0)
    ref = np.asarray(pallas_flash(*(jnp.asarray(np.pad(a, ((0, 0), (0, 0), (0, padded), (0, 0))), dtype=dtype)
                                    for a in arrays), interpret=True, block_q=64, block_k=64), np.float32)
    np.testing.assert_allclose(got.transpose(1, 2).float().numpy(), ref[:, :, :s], atol=TOL[dtype], rtol=TOL[dtype])
