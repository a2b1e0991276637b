"""The port's DeepSeek-V3 slice held to the reference: MLA attention, the
flash kernel's plain version at MLA's head dim 192, the MTP loss and the
latent cache.

MLA functions: the same parameters (drawn with numpy at the reference's
scales, norms moved off 1) and inputs go through ``repro.models.attention``
and the port's, on the deepseek smoke config (d_model 64, 4 heads, q rank
32, kv rank 16, nope 16 + rope 8, v 16).  Bars: f32 2e-5 absolute; bf16
one bf16 ulp for the projections that take no softmax (``_mla_q``,
``_mla_kv_latent``) and 2e-2 of the largest value past it, where the port's
prefill rounds p per key tile in the kernel's plain version and the
reference in a full softmax.  The model, server and training tests run the
whole deepseek smoke model (``test_torch_models``, ``test_torch_server``,
``test_torch_train``).
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import flash_attention as pallas_flash  # noqa: E402
from repro_torch import configs as port_configs  # noqa: E402
from repro_torch.ckpt import load_checkpoint, save_checkpoint  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.models import Model, attention, params_from_reference  # noqa: E402
from repro_torch.models.params import tree_map_defs  # noqa: E402
from repro_torch.optim import OptConfig, init_opt_state  # noqa: E402
from repro_torch.tree import tree_items  # noqa: E402
from torch_parity import assert_bf16_within_ulp, prefill_at_positions, reference_stack  # noqa: E402,F401

ARCH = "deepseek-v3-671b"
B, S, CAP = 2, 24, 28
BF16_REL = 2e-2
FA_TOL = {"float32": 2e-5, "bfloat16": 2e-2}  # tests/test_kernels.py TOL, atol and rtol
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _cfg(dtype):
    return dataclasses.replace(port_configs.get_smoke_config(ARCH), dtype=dtype)


def _mla_params(cfg, seed=0) -> dict:
    """One MLA layer's parameters as numpy f32 arrays: N(0, 1/fan_in) with
    fan-in over dim -2 (``wo`` over its first two), norms 1 + N(0, 0.1)."""
    rng = np.random.default_rng(seed)

    def one(d):
        if d.init == "ones":
            return (1 + 0.1 * rng.standard_normal(d.shape)).astype(np.float32)
        fan_in = np.prod([d.shape[i] for i in d.fan_in_dims]) if d.fan_in_dims else d.shape[-2]
        return (rng.standard_normal(d.shape) / np.sqrt(fan_in)).astype(np.float32)

    return tree_map_defs(one, attention.mla_defs(cfg))


def _inputs(cfg, seed=1):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)


def _as_ref(a, dtype):
    """The reference's array: params keep f32 for the norms, as in its defs."""
    return jnp.asarray(a, dtype=jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)


def _both_params(cfg, dtype):
    p_np = _mla_params(cfg)
    defs = attention.mla_defs(cfg)
    ref_p = {k: jnp.asarray(a, jnp.float32) if defs[k].dtype == torch.float32 else _as_ref(a, dtype)
             for k, a in p_np.items()}
    port_p = {k: torch.from_numpy(np.array(v, np.float32)).to(defs[k].dtype) for k, v in ref_p.items()}
    return ref_p, port_p


def _np(t) -> np.ndarray:
    return np.asarray(t.float().numpy() if isinstance(t, torch.Tensor) else t, np.float32)


def _close(got, want, dtype, what, exact_bf16=False):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=0, err_msg=what)
    elif exact_bf16:
        assert_bf16_within_ulp(got, want)
    else:
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err <= BF16_REL, f"{what}: max |diff| is {err:.3g} of the largest value"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_projections_match_the_reference(reference_stack, dtype):  # noqa: F811
    from repro.models import attention as ref_attention

    cfg = _cfg(dtype)
    ref_p, p = _both_params(cfg, dtype)
    x = _inputs(cfg)
    pos = np.broadcast_to(3 + np.arange(S, dtype=np.int32), (B, S))
    xr, xt = _as_ref(x, dtype), torch.from_numpy(x).to(_TORCH[dtype])
    pr, pt = jnp.asarray(pos), torch.from_numpy(pos.copy())
    for name, got, want in zip(("q_nope", "q_rope"), attention._mla_q(cfg, p, xt, pt),
                               ref_attention._mla_q(cfg, ref_p, xr, pr)):
        _close(got, want, dtype, name, exact_bf16=True)
    for name, got, want in zip(("ckv", "k_rope"), attention._mla_kv_latent(cfg, p, xt, pt),
                               ref_attention._mla_kv_latent(cfg, ref_p, xr, pr)):
        _close(got, want, dtype, name, exact_bf16=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_train_matches_the_reference_with_packed_segments(reference_stack, dtype):  # noqa: F811
    """Two documents in row 0, positions restarting at the second; the
    output and, in f32, the gradients of x and of every parameter."""
    from repro.models import attention as ref_attention

    cfg = _cfg(dtype)
    ref_p, p = _both_params(cfg, dtype)
    x = _inputs(cfg)
    seg = np.zeros((B, S), np.int32)
    seg[0, 10:] = 1
    pos = np.stack([np.r_[np.arange(10), np.arange(S - 10)], np.arange(S)]).astype(np.int32)
    want = ref_attention.mla_train(cfg, ref_p, _as_ref(x, dtype), jnp.asarray(pos), jnp.asarray(seg))
    xt = torch.from_numpy(x).to(_TORCH[dtype]).requires_grad_()
    leaves = {k: v.requires_grad_() for k, v in p.items()}
    got = attention.mla_train(cfg, leaves, xt, torch.from_numpy(pos), torch.from_numpy(seg))
    _close(got.detach(), want, dtype, "mla_train")
    if dtype != "float32":
        return
    dy = np.random.default_rng(2).standard_normal(got.shape).astype(np.float32)
    ref_grads = jax.grad(
        lambda pp, xx: jnp.sum(ref_attention.mla_train(cfg, pp, xx, jnp.asarray(pos), jnp.asarray(seg)) * dy),
        argnums=(0, 1))(ref_p, jnp.asarray(x))
    grads = torch.autograd.grad((got * torch.from_numpy(dy)).sum(), [xt, *leaves.values()])
    for name, g in zip(["x", *leaves], grads):
        w = np.asarray(ref_grads[1] if name == "x" else ref_grads[0][name])
        assert np.abs(g.numpy() - w).max() <= 1e-4 * np.abs(w).max(), name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_prefill_and_decode_match_the_reference(reference_stack, dtype):  # noqa: F811
    """Prefill of S tokens (the port's through the kernel's plain version,
    v zero-padded) writes ckv and k_rope into slots 0..S-1 of a cache of
    capacity CAP; four absorbed decode steps write slots S..S+3."""
    from repro.models import attention as ref_attention

    cfg = _cfg(dtype)
    ref_p, p = _both_params(cfg, dtype)
    m = cfg.mla
    x = _inputs(cfg)
    steps = np.random.default_rng(3).standard_normal((CAP - S, B, 1, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    dt = _TORCH[dtype]
    cache = {"ckv": torch.zeros((B, CAP, m.kv_lora_rank), dtype=dt),
             "k_rope": torch.zeros((B, CAP, m.qk_rope_head_dim), dtype=dt)}
    launches = fa.flash_attention.launches
    got = attention.mla_prefill(cfg, p, torch.from_numpy(x).to(dt), torch.from_numpy(pos.copy()), cache)
    assert fa.flash_attention.launches == launches  # CPU tensors: the plain version
    want, ref_cache = ref_attention.mla_prefill(cfg, ref_p, _as_ref(x, dtype), jnp.asarray(pos), jnp.zeros((B, S), jnp.int32))
    _close(got, want, dtype, "prefill y")
    for name in ("ckv", "k_rope"):
        _close(cache[name][:, :S], ref_cache[name], dtype, f"prefill {name}", exact_bf16=True)
        assert not cache[name][:, S:].any()
    ref_cache = {k: jnp.pad(v, [(0, 0), (0, CAP - S), (0, 0)]) for k, v in ref_cache.items()}
    for t in range(CAP - S):
        got = attention.mla_decode(cfg, p, torch.from_numpy(steps[t]).to(dt), cache, S + t)
        want, ref_cache = ref_attention.mla_decode(cfg, ref_p, _as_ref(steps[t], dtype), ref_cache, jnp.int32(S + t))
        _close(got, want, dtype, f"decode step {t} y")
    for name in ("ckv", "k_rope"):
        _close(cache[name], ref_cache[name], dtype, f"final {name}", exact_bf16=True)


def _qkv192(seed, b=1, h=4, s=128, nope_rope=192, vd=128):
    rng = np.random.default_rng(seed)
    q, k = (rng.standard_normal((b, h, s, nope_rope)).astype(np.float32) for _ in range(2))
    v = rng.standard_normal((b, h, s, vd)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_the_plain_kernel_at_head_dim_192_matches_pallas(dtype):
    """MLA's prefill shape in small: 4 heads, kv groups of 1, q and k of
    192 dims, v of 128 padded with zeros to 192.  The plain version against
    the Pallas kernel in interpret mode on the padded v; its first 128
    output dims against attention on the unpadded v, the rest zero."""
    q, k, v = _qkv192(0)
    vp = np.pad(v, [(0, 0), (0, 0), (0, 0), (0, 64)])
    kw = {"causal": True, "block_q": 64, "block_k": 64}
    want = pallas_flash(*(jnp.asarray(a, dtype=dtype) for a in (q, k, vp)), interpret=True, **kw)
    t = [torch.from_numpy(a).to(_TORCH[dtype]) for a in (q, k, vp)]
    got = fa.flash_attention(*t, **kw)
    tol = FA_TOL[dtype]
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), atol=tol, rtol=tol)
    assert not got[..., 128:].any()
    if dtype == "float32":
        pos = torch.arange(q.shape[2])[None]
        seg = torch.zeros_like(pos)
        unpadded = attention._plain_attention(
            *(torch.from_numpy(a).transpose(1, 2) for a in (q[:, :, :, None], k, v)), pos, pos, seg, seg, 192**-0.5)
        np.testing.assert_allclose(_np(got[..., :128]), _np(unpadded[:, :, :, 0].transpose(1, 2)), atol=2e-5, rtol=0)


@pytest.mark.parametrize("dtype,block_k,route", [
    (torch.bfloat16, 128, "tc_bf16"),  # MLA's serving prefill (512 tokens: tiles of 128)
    (torch.bfloat16, 64, "tc_bf16"),
    (torch.float32, 128, "cuda_f32"),
])
def test_the_cuda_route_takes_head_dim_192(dtype, block_k, route):
    assert fa.kernel_route(dtype, 192, block_k) == route


def test_the_mla_cache_holds_the_latents():
    cfg = port_configs.get_smoke_config(ARCH)
    m = cfg.mla
    model = Model(cfg)
    (plan, n), = cfg.segments()
    want = [{"blocks": [{"ckv": ((n, 3, 40, m.kv_lora_rank), torch.bfloat16),
                         "k_rope": ((n, 3, 40, m.qk_rope_head_dim), torch.bfloat16)}] * len(plan)}]
    assert model.cache_spec(3, 40) == want
    cache = model.new_cache(3, 40, "cpu")
    assert {k: (tuple(t.shape), t.dtype) for k, t in cache[0]["blocks"][0].items()} == want[0]["blocks"][0]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_loss_reports_the_mtp_loss_of_the_reference(reference_stack, dtype):  # noqa: F811
    """loss = loss_lm + aux + 0.3 loss_mtp, each metric against the
    reference's on the same weights and packed batch; and the MTP loss moves
    with the labels at t+2 (a label masked there leaves it as it was only
    where the roll does not reach it)."""
    ref = reference_stack
    ref_cfg = dataclasses.replace(ref.get_smoke_config(ARCH), dtype=dtype)
    cfg = _cfg(dtype)
    ref_model, model = ref.Model(ref_cfg), Model(cfg)
    params_np = jax.tree.map(np.asarray, ref_model.init(jax.random.PRNGKey(0)))
    assert model.param_count() == ref_model.param_count()
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -1
    labels[1, 5] = -1
    batch = {"tokens": tokens, "labels": labels}
    _, want = ref_model.train_loss(jax.tree.map(jnp.asarray, params_np), {k: jnp.asarray(v) for k, v in batch.items()})
    params = params_from_reference(params_np, device="cpu")
    loss, got = model.train_loss(params, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert set(got) == set(want) == {"loss", "loss_lm", "aux", "loss_mtp"}
    bar = 2e-5 if dtype == "float32" else BF16_REL * abs(float(want["loss"]))
    for k in want:
        assert abs(float(got[k]) - float(want[k])) <= max(bar, 1e-6 if k == "aux" else 0), (k, got[k], want[k])
    expect = got["loss_lm"] + got["aux"] + 0.3 * got["loss_mtp"]
    assert abs(float(loss) - float(expect)) <= 1e-5
    if dtype == "float32":
        moved = labels.copy()
        moved[0, 3] = (moved[0, 3] + 1) % cfg.vocab_size  # the t+2 target of position 2
        _, m2 = model.train_loss(params, {"tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(moved)})
        assert float(m2["loss_mtp"]) != float(got["loss_mtp"])
        assert float(m2["loss_lm"]) != float(got["loss_lm"])


def test_a_deepseek_checkpoint_crosses_both_ways(reference_stack, tmp_path):  # noqa: F811
    """The smoke model's parameters (the ``mtp`` subtree among them) and
    its adamw_bf16 state: the reference's checkpoint loads in the port, and
    the port's in the reference, bit for bit."""
    ref = reference_stack
    ref_cfg = ref.get_smoke_config(ARCH)
    params_np = jax.tree.map(np.asarray, ref.Model(ref_cfg).init(jax.random.PRNGKey(2)))
    opt_cfg = ref.OptConfig(kind=ref_cfg.optimizer)
    state_np = jax.tree.map(np.asarray, ref.init_opt_state(opt_cfg, jax.tree.map(jnp.asarray, params_np)))
    assert "mtp" in params_np and ref_cfg.optimizer == "adamw_bf16"

    def bits(tree):
        out = {}
        for k, v in tree_items(tree):
            if isinstance(v, torch.Tensor):
                v = v.view(torch.int16).numpy() if v.dtype == torch.bfloat16 else v.numpy()
            out[k] = np.ascontiguousarray(v).view(np.uint8).tobytes()
        return out

    ref.save_checkpoint(tmp_path / "ref", 5, params_np, state_np)
    params_t = Model(port_configs.get_smoke_config(ARCH)).init(0, "cpu")
    state_t = init_opt_state(OptConfig(kind=ref_cfg.optimizer), params_t)
    out = load_checkpoint(tmp_path / "ref", params_t, state_t)
    assert out["step"] == 5
    assert bits(out["params"]) == bits(params_np) and bits(out["opt_state"]) == bits(state_np)

    save_checkpoint(tmp_path / "port", 6, out["params"], out["opt_state"])
    back = ref.load_checkpoint(tmp_path / "port", params_np, state_np)
    assert back["step"] == 6
    assert bits(jax.tree.map(np.asarray, back["params"])) == bits(params_np)
    assert bits(jax.tree.map(np.asarray, back["opt_state"])) == bits(state_np)


def test_mla_prefill_raises_on_positions_that_do_not_strictly_increase(reference_stack, monkeypatch):  # noqa: F811
    """MLA's prefill masks by position too: at positions that restart,
    repeat or reverse, DeepSeek's smoke model (MLA with a dense layer, then
    MoE layers replaying the reference's expert choices) gives the
    reference's logits and latent cache in f32."""
    got, want = prefill_at_positions(reference_stack, monkeypatch, ARCH)
    _close(got[0], want[0], "float32", "prefill logits")
    for seg, want_seg in zip(got[1], want[1]):
        for blk, want_blk in zip(seg["blocks"], want_seg["blocks"]):
            assert blk.keys() == want_blk.keys() == {"ckv", "k_rope"}
            for name in blk:
                _close(blk[name], want_blk[name], "float32", f"prefill cache {name}")
