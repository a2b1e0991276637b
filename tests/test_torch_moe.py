"""The port's Mixture-of-Experts layer held to the reference's.

The same seeded inputs (numpy, then bit-identical tensors on both sides)
go through ``repro.models.moe.apply_moe`` and ``repro_torch.models.moe``:
granite-smoke (4 experts, top 2), jamba-smoke (4 experts, top 2, d_expert
128), granite-smoke with 2 shared experts, granite-smoke at capacity
factor 0.5, where every sequence overflows some expert and the reference
drops pairs, deepseek-smoke (8 experts, top 2, a shared expert) and
granite-smoke at top 8 of 16 experts, DeepSeek-V3's k (the combine sums
the k gated outputs one choice at a time).  Routes (each token's top-k experts, in order), y and the aux
loss are compared, and the gradients of y and aux against ``jax.grad``.

Bars.  f32: y within 2e-5 absolute, aux within 1e-6 of its value (a few f32
roundings of its means).  bf16:
y within 2e-2 of its largest |value|.  Not 1 bf16 ulp: the expert
products round to bf16 (h, then y_buf) and the two frameworks sum them in
other orders, so an element near zero after the down projection's
cancellation is many ulps apart (up to 38) while the tensor agrees to
1.1e-3 of its largest value or better (measured on the CPU: 0 to 1.1e-3
over the four configs).  Routes are
computed in f32 from the same bits on both sides: they must be equal.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro_torch import configs as port_configs  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from torch_parity import reference_stack  # noqa: E402,F401

import route_check  # noqa: E402  (tools/, put on the path by torch_parity)

F32_Y, F32_AUX, F32_GRAD, BF16_REL = 2e-5, 1e-6, 1e-4, 2e-2
B, S = 2, 24
VARIANTS = {
    "granite": ("granite-moe-1b-a400m", {}),
    "jamba": ("jamba-1.5-large-398b", {}),
    "shared": ("granite-moe-1b-a400m", {"n_shared_experts": 2}),
    "overflow": ("granite-moe-1b-a400m", {"capacity_factor": 0.5}),
    "deepseek": ("deepseek-v3-671b", {}),
    "top8": ("granite-moe-1b-a400m", {"n_experts": 16, "experts_per_token": 8}),
}


def _configs(ref, variant, dtype):
    arch, over = VARIANTS[variant]
    out = []
    for get in (ref.get_smoke_config, port_configs.get_smoke_config):
        cfg = get(arch)
        out.append(dataclasses.replace(cfg, dtype=dtype, moe=dataclasses.replace(cfg.moe, **over)))
    return out


def _inputs(cfg, dtype, seed=0):
    """x (B,S,D) and the layer's parameters as numpy, drawn from ``seed``;
    bf16 values are rounded once, so both sides get the same bits."""
    from repro_torch.models.params import tree_map_defs

    rng = np.random.default_rng(seed)

    def draw(d):
        a = (rng.standard_normal(d.shape) / np.sqrt(d.shape[-2])).astype(np.float32)
        return a if d.dtype == torch.float32 else _round(a, dtype)

    params = tree_map_defs(draw, moe.moe_defs(cfg))
    x = _round(rng.standard_normal((B, S, cfg.d_model)).astype(np.float32), dtype)
    return x, params


def _round(a: np.ndarray, dtype: str) -> np.ndarray:
    if dtype == "float32":
        return a
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def _to_torch(a: np.ndarray, like_bf16: bool) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(torch.bfloat16) if like_bf16 else t


def _both(cfg, x, params, dtype):
    """(jax x, jax params, torch x, torch params) on the same values."""
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jparams = {k: (jax.tree.map(lambda a: jnp.asarray(a, jdt), v) if k != "router" else jnp.asarray(v))
               for k, v in params.items()}
    tparams = {k: (jax.tree.map(lambda a: _to_torch(a, dtype == "bfloat16"), v) if k != "router"
                   else torch.from_numpy(v)) for k, v in params.items()}
    return jnp.asarray(x, jdt), jparams, _to_torch(x, dtype == "bfloat16"), tparams


def _ref_route(cfg, p, x):
    """The reference's routing lines (``repro/models/moe.py:65-68``): each
    token's top-k experts."""
    logits = jnp.einsum("bsd,de->bse", x.astype(jnp.float32), p["router"])
    return np.asarray(jax.lax.top_k(jax.nn.softmax(logits, axis=-1), cfg.moe.experts_per_token)[1])


@pytest.mark.parametrize("seq", [1, 7, 24, 512, 4096, 32768])
@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "jamba-1.5-large-398b"])
def test_capacity_per_seq_matches_the_reference(reference_stack, arch, seq):  # noqa: F811
    from repro import configs as ref_configs
    from repro.models import moe as ref_moe

    for get in ("get_config", "get_smoke_config"):
        cfg, ref_cfg = getattr(port_configs, get)(arch), getattr(ref_configs, get)(arch)
        assert moe.capacity_per_seq(cfg, seq) == ref_moe.capacity_per_seq(ref_cfg, seq)
    assert moe.capacity_per_seq(port_configs.get_config("granite-moe-1b-a400m"), 512) == 160
    assert moe.capacity_per_seq(port_configs.get_config("granite-moe-1b-a400m"), 32768) == 10240  # prefill_32k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_apply_moe_matches_the_reference(reference_stack, variant, dtype):  # noqa: F811
    from repro.models import moe as ref_moe

    ref_cfg, cfg = _configs(reference_stack, variant, dtype)
    x_np, p_np = _inputs(cfg, dtype)
    jx, jp, tx, tp = _both(cfg, x_np, p_np, dtype)

    want_y, want_aux = ref_moe.apply_moe(ref_cfg, jp, jx)
    _, _, idx = moe.route(cfg, tp, tx)
    y, aux = moe.apply_moe(cfg, tp, tx)

    np.testing.assert_array_equal(idx.numpy(), _ref_route(ref_cfg, jp, jx))
    assert y.dtype == tx.dtype and y.shape == tx.shape
    got, want = y.float().numpy(), np.asarray(want_y, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=F32_Y, rtol=0)
    else:
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err <= BF16_REL, f"y: max |diff| is {err:.3g} of the largest value"
    assert abs(float(aux) - float(want_aux)) <= F32_AUX * abs(float(want_aux)), (float(aux), float(want_aux))
    assert float(aux) > 0

    cap = moe.capacity_per_seq(cfg, S)
    per_expert = torch.stack([(idx[i] == e).sum() for i in range(B) for e in range(cfg.moe.n_experts)])
    if variant == "overflow":  # pairs are dropped (granite's own 1.25 drops a few too)
        assert int((per_expert - cap).clamp(min=0).sum()) > B * S // 4


def test_apply_moe_matches_a_loop_over_tokens():
    """The semantics spelled out, token by token, at capacity factor 0.5:
    in each sequence the (token, choice) pairs go to their experts in token
    order, an expert keeps its first ``cap`` and drops the rest, and a
    token's y is the gate-weighted sum of its kept choices' SwiGLU outputs."""
    cfg = port_configs.get_smoke_config("granite-moe-1b-a400m")
    cfg = dataclasses.replace(cfg, dtype="float32", moe=dataclasses.replace(cfg.moe, capacity_factor=0.5))
    x_np, p_np = _inputs(cfg, "float32", seed=1)
    x, p = torch.from_numpy(x_np), {k: torch.from_numpy(v) for k, v in p_np.items()}
    y, _ = moe.apply_moe(cfg, p, x)
    _, gate, idx = moe.route(cfg, p, x)

    cap, want, dropped = moe.capacity_per_seq(cfg, S), torch.zeros_like(x), 0
    for b in range(B):
        taken = [0] * cfg.moe.n_experts
        for t in range(S):
            for j in range(cfg.moe.experts_per_token):
                e = int(idx[b, t, j])
                taken[e] += 1
                if taken[e] > cap:
                    dropped += 1
                    continue
                h = torch.nn.functional.silu(x[b, t] @ p["w_gate"][e]) * (x[b, t] @ p["w_up"][e])
                want[b, t] += gate[b, t, j] * (h @ p["w_down"][e])
    assert dropped > 0
    torch.testing.assert_close(y, want, atol=F32_Y, rtol=0)


def test_route_check_keeps_what_apply_moe_keeps_and_replays():
    """``tools/route_check.py``, which the card checks rest on: its
    ``kept_experts`` is apply_moe's keep rule (the token loop's above, at
    capacity factor 0.5), a replay of a run's own choices leaves y as it
    was bit for bit, and a replay of other experts moves it."""
    cfg = port_configs.get_smoke_config("granite-moe-1b-a400m")
    cfg = dataclasses.replace(cfg, dtype="float32", moe=dataclasses.replace(cfg.moe, capacity_factor=0.5))
    x_np, p_np = _inputs(cfg, "float32", seed=1)
    x, p = torch.from_numpy(x_np), {k: torch.from_numpy(v) for k, v in p_np.items()}
    k, e, cap = cfg.moe.experts_per_token, cfg.moe.n_experts, moe.capacity_per_seq(cfg, S)
    with route_check.RouteRecorder() as own:
        y, _ = moe.apply_moe(cfg, p, x)
    idx = own.idx[0]

    want = np.zeros((B, S, e), bool)
    for b in range(B):
        taken = [0] * e
        for t in range(S):
            for j in range(k):
                taken[idx[b, t, j]] += 1
                want[b, t, idx[b, t, j]] = taken[idx[b, t, j]] <= cap
    kept = route_check.kept_experts(own.probs[0], k, cap)
    assert kept.sum() < B * S * k  # pairs were dropped
    np.testing.assert_array_equal(kept, want)

    with route_check.RouteRecorder(replay=own.idx) as again:
        y_again, _ = moe.apply_moe(cfg, p, x)
    torch.testing.assert_close(y_again, y, rtol=0, atol=0)
    assert route_check.differences(cfg, own.probs[0], again.probs[0]) == []
    with route_check.RouteRecorder(replay=[(idx + 1) % e]):
        y_other, _ = moe.apply_moe(cfg, p, x)
    assert not torch.allclose(y_other, y, atol=1e-3)


def test_gradients_match_jax_grad(reference_stack):  # noqa: F811
    """f32: d(sum(y * dy) + aux) by x and every parameter, shared experts and
    drops included, within 1e-4 of each gradient's largest |value|; and the
    aux loss's own gradient by the router."""
    _gradients_match_jax_grad(reference_stack, "shared")


def test_gradients_match_jax_grad_at_top_8(reference_stack):  # noqa: F811
    """The same at top 8 of 16 experts: the gradient flows into each of the
    k choices through the combine's running sum."""
    _gradients_match_jax_grad(reference_stack, "top8")


def _gradients_match_jax_grad(reference_stack, variant):  # noqa: F811
    from repro.models import moe as ref_moe

    ref_cfg, cfg = _configs(reference_stack, variant, "float32")
    ref_cfg = dataclasses.replace(ref_cfg, moe=dataclasses.replace(ref_cfg.moe, capacity_factor=0.75))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=0.75))
    x_np, p_np = _inputs(cfg, "float32", seed=2)
    dy = np.random.default_rng(3).standard_normal(x_np.shape).astype(np.float32)
    jx, jp, tx, tp = _both(cfg, x_np, p_np, "float32")

    def ref_loss(x, p):
        y, aux = ref_moe.apply_moe(ref_cfg, p, x)
        return jnp.sum(y * dy) + aux

    want_gx, want_gp = jax.grad(ref_loss, argnums=(0, 1))(jx, jp)
    want_aux_grad = jax.grad(lambda p: ref_moe.apply_moe(ref_cfg, p, jx)[1])(jp)["router"]

    leaves = {"x": tx.requires_grad_()}
    for k, v in tp.items():
        if isinstance(v, dict):
            leaves.update({f"shared.{kk}": vv.requires_grad_() for kk, vv in v.items()})
        else:
            leaves[k] = v.requires_grad_()
    y, aux = moe.apply_moe(cfg, tp, tx)
    grads = dict(zip(leaves, torch.autograd.grad((y * torch.from_numpy(dy)).sum() + aux, list(leaves.values()))))
    (aux_grad,) = torch.autograd.grad(moe.apply_moe(cfg, tp, tx)[1], [tp["router"]])

    want = {"x": want_gx, **{k: v for k, v in want_gp.items() if k != "shared"},
            **{f"shared.{k}": v for k, v in want_gp.get("shared", {}).items()}, "aux_router": want_aux_grad}
    got = {**grads, "aux_router": aux_grad}
    assert got.keys() == want.keys()
    for k in want:
        g, w = got[k].numpy(), np.asarray(want[k])
        rel = np.abs(g - w).max() / np.abs(w).max()
        assert np.abs(w).max() > 0 and rel <= F32_GRAD, (k, rel)


def test_first_k_dense_and_shared_experts_in_the_model(reference_stack):  # noqa: F811
    """granite-smoke with ``first_k_dense=1`` (layer 0 a dense FFN of d_ff
    64, layer 1 MoE) and one shared expert: the layer plan, the parameter
    tree, prefill and decode logits and the train loss and aux, f32."""
    from repro_torch.models import Model, params_from_reference

    over = {"d_ff": 64, "dtype": "float32"}
    moe_over = {"first_k_dense": 1, "n_shared_experts": 1}
    ref_cfg, cfg = (dataclasses.replace(c, moe=dataclasses.replace(c.moe, **moe_over), **over) for c in (
        reference_stack.get_smoke_config("granite-moe-1b-a400m"),
        port_configs.get_smoke_config("granite-moe-1b-a400m")))
    assert cfg.layer_plan() == [("attn", False), ("attn", True)]
    ref_model, model = reference_stack.Model(ref_cfg), Model(cfg)
    ref_params = ref_model.init(jax.random.PRNGKey(0))
    params = params_from_reference(jax.tree.map(np.asarray, ref_params), device="cpu")
    blocks = [blk for seg in params["segments"] for blk in seg["blocks"]]
    assert sorted(blocks[0]["ffn"]) == ["w_down", "w_gate", "w_up"]
    assert sorted(blocks[1]["ffn"]) == ["router", "shared", "w_down", "w_gate", "w_up"]

    rng = np.random.default_rng(5)
    tokens = rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32)
    nxt = rng.integers(0, cfg.vocab_size, (B, 1), dtype=np.int32)
    want, want_cache = ref_model.prefill(ref_params, {"tokens": jnp.asarray(tokens)})
    got, cache = model.prefill(params, {"tokens": torch.from_numpy(tokens)}, seq_cap=S + 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
    want_cache = [{"blocks": [{n: jnp.pad(x, [(0, 0), (0, 0), (0, 1), (0, 0), (0, 0)]) for n, x in blk.items()}
                              for blk in seg["blocks"]]} for seg in want_cache]
    want, _ = ref_model.decode_step(ref_params, want_cache, jnp.asarray(nxt), jnp.int32(S))
    got, _ = model.decode_step(params, cache, torch.from_numpy(nxt), S)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)

    batch = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}
    _, want_m = ref_model.train_loss(ref_params, {k: jnp.asarray(v) for k, v in batch.items()})
    _, got_m = model.train_loss(params, {k: torch.from_numpy(v) for k, v in batch.items()})
    for k in ("loss", "loss_lm", "aux"):
        assert abs(float(got_m[k]) - float(want_m[k])) <= 1e-5 * abs(float(want_m[k])), (k, got_m[k], want_m[k])
    assert float(got_m["aux"]) > 0
    assert float(got_m["loss"]) == pytest.approx(float(got_m["loss_lm"]) + float(got_m["aux"]), rel=1e-6)
