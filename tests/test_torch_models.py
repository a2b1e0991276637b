"""The port's serving path held to the reference model, end to end.

The reference ``Model`` is initialized on a smoke config (qwen3, a dense
GQA decoder; mamba2, an attention-free SSD stack; granite-moe, a GQA
decoder whose every FFN is a Mixture-of-Experts; jamba, one super-block of
attention and 7 SSD layers with MoE on every other; deepseek, MLA with a
dense layer then MoE layers with a shared expert; olmo, yi and qwen1.5,
dense decoders with non-parametric layer norm or QKV bias) from
``PRNGKey(0)``; its parameters cross to the port with
``params_from_reference``; the same seeded tokens then go through both
``prefill`` (the port's attention, MLA's too, in ``flash_attention`` and
its SSD scan in ``ssd_scan``, the reference's in its plain jnp softmax and
``ssd_chunked``) and four ``decode_step``s fed the same forced tokens.
Logits and caches (k/v of attention blocks, MLA's ``ckv`` and ``k_rope``,
the ``ssm`` state and ``conv`` window of SSD blocks) are compared after
each.

Bars: f32, atol = rtol = 1e-4.  bf16, 2e-2 of the largest reference value
(measured on the CPU: logits up to 8.0e-3 and caches up to 6.9e-3 of it);
the two stacks round bf16 at other places (flash's blockwise p against a
full softmax, the order of f32 sums), so element-wise ulp bars do not
apply.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro_torch import configs as port_configs  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ssd_scan as ks  # noqa: E402
from repro_torch.models import Model, params_from_reference, tree_to_numpy  # noqa: E402
from repro_torch.models.params import ParamDef, init_params, param_count  # noqa: E402
from repro_torch.tree import tree_items  # noqa: E402
from torch_parity import (  # noqa: E402,F401
    SWAP_GAP, condition_attention, prefill_at_positions, reference_routes, reference_stack,
)

import route_check  # noqa: E402  (tools/, put on the path by torch_parity)

ARCH = "qwen3-0.6b"
ARCHS = ["qwen3-0.6b", "mamba2-780m", "granite-moe-1b-a400m", "jamba-1.5-large-398b", "deepseek-v3-671b",
         "olmo-1b", "yi-6b", "qwen1.5-110b"]
# bf16 on condition_attention's weights (its docstring says why): the
# GQA decoders without qk_norm, and MLA
CONDITIONED = ("granite-moe-1b-a400m", "olmo-1b", "yi-6b", "qwen1.5-110b", "deepseek-v3-671b")
# S = 3 key tiles of 8: the online softmax crosses tiles; for mamba2 the
# reference picks chunk 8 (its 16 does not divide 24): the scan crosses chunks
B, S, STEPS = 2, 24, 4
BF16_REL = 2e-2
# jamba-smoke in bf16: its 7 SSD layers amplify the one-ulp differences of
# its attention layer's output (the port's flash rounding of p against the
# reference's full softmax).  Measured on the CPU over PRNGKeys 0-3: the
# port 2.4-3.5e-2 of the largest value from the reference, the reference's
# own bf16 run 4.5-22% from its f32 run (mamba2-smoke's stack, with no
# attention before it, stays within 2e-2 of the reference)
HYBRID_BF16_REL = 5e-2
_TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _f32(a) -> np.ndarray:
    return np.asarray(a.float().numpy() if isinstance(a, torch.Tensor) else a, np.float32)


def _close(got, want, dtype, what, bf16_rel=BF16_REL):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4, err_msg=what)
    else:
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err <= bf16_rel, f"{what}: max |diff| is {err:.3g} of the largest value"


def _configs(ref, dtype, arch=ARCH):
    ref_cfg = dataclasses.replace(ref.get_smoke_config(arch), dtype=dtype)
    cfg = dataclasses.replace(port_configs.get_smoke_config(arch), dtype=dtype)
    return ref_cfg, cfg


GROWN = ("k", "v", "ckv", "k_rope")  # attention's k/v, MLA's latents


def _grow(name, x):
    if name in GROWN:  # (n, B, S, ...): capacity S + STEPS
        return jnp.pad(x, [(0, 0), (0, 0), (0, STEPS)] + [(0, 0)] * (x.ndim - 3))
    return x  # the SSD state does not grow


def _launches() -> tuple[int, int]:
    return fa.flash_attention.launches, ks.ssd_scan.launches


def _serve(model_prefill, model_decode, tokens, forced, snapshot=lambda cache: cache):
    """The prefill logits and cache (a ``snapshot`` of it), each decode
    step's logits, the final cache."""
    logits, cache = model_prefill(tokens)
    steps, prefill_cache = [], snapshot(cache)
    for t in range(STEPS):
        step_logits, cache = model_decode(cache, forced[t], S + t)
        steps.append(step_logits)
    return logits, prefill_cache, steps, cache


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_the_reference(reference_stack, monkeypatch, arch, dtype):  # noqa: F811
    """MoE configs: the reference runs first, recording each layer's
    expert choices, and the port replays them (``route_check``), so that
    a near-tie that rounding breaks the other way in one run cannot move
    other tokens' outputs; the port's own choices are compared with the
    reference's: in f32 they must be equal, in bf16 they may differ only
    where the reference's k-th and (k+1)-th probabilities lie within
    SWAP_GAP.  In bf16 granite-moe runs on ``condition_attention``'s
    weights, and jamba is held to HYBRID_BF16_REL (each says why)."""
    ref = reference_stack
    ref_cfg, cfg = _configs(ref, dtype, arch)
    ref_model = ref.Model(ref_cfg)
    ref_params = ref_model.init(jax.random.PRNGKey(0))
    if dtype == "bfloat16" and arch in CONDITIONED:
        ref_params = jax.tree.map(jnp.asarray, condition_attention(cfg, jax.tree.map(np.asarray, ref_params)))
    rel = HYBRID_BF16_REL if arch == "jamba-1.5-large-398b" else BF16_REL
    model = Model(cfg)
    params = params_from_reference(jax.tree.map(np.asarray, ref_params), device="cpu")
    assert model.param_count() == ref_model.param_count()

    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32)
    forced = rng.integers(0, cfg.vocab_size, (STEPS, B, 1), dtype=np.int32)

    def ref_run(m, p):
        def prefill(tok):
            logits, cache = m.prefill(p, {"tokens": jnp.asarray(tok)})
            # the reference server's _grow_cache: k/v padded to capacity
            return logits, [{"blocks": [{name: _grow(name, x) for name, x in blk.items()} for blk in seg["blocks"]]}
                            for seg in cache]
        return _serve(prefill, lambda c, tok, pos: m.decode_step(p, c, jnp.asarray(tok), jnp.int32(pos)),
                      tokens, forced)

    with reference_routes(monkeypatch) as want_routes:
        want = ref_run(ref_model, ref_params)
    launches = _launches()
    with route_check.RouteRecorder(replay=want_routes.idx if cfg.moe else None) as got_routes:
        got = _serve(lambda tok: model.prefill(params, {"tokens": torch.from_numpy(tok)}, seq_cap=S + STEPS),
                     lambda c, tok, pos: model.decode_step(params, c, torch.from_numpy(tok), pos),
                     tokens, forced, lambda c: jax.tree.map(torch.clone, c))  # decode writes in place
    assert _launches() == launches  # CPU tensors: the plain versions

    if cfg.moe is not None:
        diffs = route_check.compare(cfg, want_routes.probs, got_routes.probs)
        assert len(got_routes.probs) == (1 + STEPS) * sum(m for _, m in cfg.layer_plan())
        if dtype == "float32":
            assert diffs == [], route_check.summary(diffs, 0)
        assert all(d.gap <= SWAP_GAP for d in diffs if d.kind == "swap"), route_check.summary(diffs, 0)

    _close(got[0], want[0], dtype, "prefill logits", rel)
    for when, item in (("prefill", 1), ("after decode", 3)):
        for seg, want_seg in zip(got[item], want[item]):
            for blk, want_blk in zip(seg["blocks"], want_seg["blocks"]):
                assert blk.keys() == want_blk.keys()
                for name in blk:
                    g, w = blk[name], want_blk[name]
                    assert g.dtype == _TORCH_DTYPE[str(w.dtype)]
                    if when == "prefill" and name in GROWN:  # capacity S + STEPS, the prompt in 0..S-1
                        assert not g[:, :, S:].any()
                    _close(g, w, dtype, f"{when} cache {name}", rel)
    for t in range(STEPS):
        _close(got[2][t], want[2][t], dtype, f"decode step {t} logits", rel)


def test_params_cross_with_their_dtypes_and_nesting(reference_stack):  # noqa: F811
    ref_cfg, cfg = _configs(reference_stack, "bfloat16")
    ref_params = reference_stack.Model(ref_cfg).init(jax.random.PRNGKey(1))
    params = params_from_reference(jax.tree.map(np.asarray, ref_params), device="cpu")
    block = params["segments"][0]["blocks"][0]
    assert params["head"] == {}
    assert block["mixer"]["wq"].dtype == torch.bfloat16
    assert block["mixer"]["q_norm"].dtype == torch.float32
    assert tuple(block["mixer"]["wq"].shape) == (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.resolved_head_dim)
    want = np.asarray(ref_params["embed"]["tok"], np.float32)
    np.testing.assert_array_equal(params["embed"]["tok"].float().numpy(), want)


def test_ssd_params_cross_with_their_dtypes_and_nesting(reference_stack):  # noqa: F811
    ref_cfg, cfg = _configs(reference_stack, "bfloat16", "mamba2-780m")
    ref_params = reference_stack.Model(ref_cfg).init(jax.random.PRNGKey(1))
    params = params_from_reference(jax.tree.map(np.asarray, ref_params), device="cpu")
    assert params["head"] == {}  # tied embeddings
    assert len(params["segments"]) == 1 and len(params["segments"][0]["blocks"]) == 1
    block = params["segments"][0]["blocks"][0]
    assert sorted(block) == ["mixer", "norm1"]  # d_ff = 0: no FFN
    mixer = block["mixer"]
    want_mixer = ref_params["segments"][0]["blocks"][0]["mixer"]
    assert sorted(mixer) == sorted(want_mixer)
    for name in ("A_log", "dt_bias", "D", "norm"):
        assert mixer[name].dtype == torch.float32, name
    for name in ("in_proj", "conv_w", "conv_b", "out_proj"):
        assert mixer[name].dtype == torch.bfloat16, name
    for name, want in want_mixer.items():
        assert tuple(mixer[name].shape) == want.shape, name
        np.testing.assert_array_equal(mixer[name].float().numpy(), np.asarray(want, np.float32), err_msg=name)
    s = cfg.ssd
    di = s.d_inner(cfg.d_model)
    assert tuple(mixer["in_proj"].shape) == (
        cfg.num_layers, cfg.d_model, 2 * di + 2 * s.n_groups * s.d_state + s.n_heads(cfg.d_model)
    )


def test_init_params_draws_the_reference_scales():
    defs = {
        "w": ParamDef((64, 256), ("embed", "ffn"), torch.float32),
        "o": ParamDef((4, 32, 64), ("heads", None, "embed"), torch.float32, fan_in_dims=(0, 1)),
        "e": ParamDef((1, 512, 64), (None, "vocab_in", "embed"), torch.bfloat16, "embed_normal"),
        "s": ParamDef((64,), (None,), torch.float32, "ones"),
    }
    p = init_params(defs, seed=3, device="cpu")
    assert param_count(defs) == 64 * 256 + 4 * 32 * 64 + 512 * 64 + 64
    assert abs(p["w"].std().item() - 64**-0.5) < 0.1 * 64**-0.5  # fan-in: dim -2
    assert abs(p["o"].std().item() - 128**-0.5) < 0.1 * 128**-0.5  # fan-in: dims 0 and 1
    assert abs(p["e"].float().std().item() - 1.0) < 0.1 and p["e"].dtype == torch.bfloat16
    assert torch.equal(p["s"], torch.ones(64))
    again = init_params(defs, seed=3, device="cpu")
    assert all(torch.equal(p[k], again[k]) for k in defs)


@pytest.mark.parametrize("arch", [ARCH, "musicgen-medium", "internvl2-2b"])
def test_params_from_reference_round_trip(reference_stack, arch):  # noqa: F811
    """Every leaf crosses to the port and back unchanged, in its dtype and
    shape: MusicGen's (4, padded_vocab, d_model) codebook table and its
    (d_model, 4 * padded_vocab) head, InternVL2's ``vis_proj``."""
    ref_cfg, cfg = _configs(reference_stack, "bfloat16", arch)
    ref_params = jax.tree.map(np.asarray, reference_stack.Model(ref_cfg).init(jax.random.PRNGKey(1)))
    params = params_from_reference(ref_params, device="cpu")
    want = {jax.tree_util.keystr(p): a for p, a in jax.tree_util.tree_flatten_with_path(ref_params)[0]}
    got = dict(tree_items(params))
    assert got.keys() == want.keys()
    back = dict(tree_items(tree_to_numpy(params)))
    for k, a in want.items():
        assert got[k].dtype == _TORCH_DTYPE[str(a.dtype)] and tuple(got[k].shape) == a.shape, k
        np.testing.assert_array_equal(back[k], np.asarray(a, np.float32), err_msg=k)
    assert tuple(got["['embed']['tok']"].shape) == (cfg.n_codebooks, cfg.padded_vocab, cfg.d_model)
    assert ("['vis_proj']['w']" in got) == bool(cfg.vis_prefix_len)
    if cfg.vis_prefix_len:
        assert tuple(got["['vis_proj']['w']"].shape) == (cfg.d_model, cfg.d_model)


def test_cache_spec_matches_the_allocated_cache():
    cfg = port_configs.get_smoke_config(ARCH)
    model = Model(cfg)
    spec = model.cache_spec(3, 40)
    cache = model.new_cache(3, 40, "cpu")
    shape = (cfg.num_layers, 3, 40, cfg.num_kv_heads, cfg.resolved_head_dim)
    assert spec == [{"blocks": [{"k": (shape, torch.bfloat16), "v": (shape, torch.bfloat16)}]}]
    assert [tuple(t.shape) for t in cache[0]["blocks"][0].values()] == [shape, shape]


def test_ssd_cache_spec_holds_state_not_tokens():
    cfg = port_configs.get_smoke_config("mamba2-780m")
    model = Model(cfg)
    s = cfg.ssd
    conv_dim = s.d_inner(cfg.d_model) + 2 * s.n_groups * s.d_state
    want = [{"blocks": [{
        "ssm": ((cfg.num_layers, 3, s.n_heads(cfg.d_model), s.head_dim, s.d_state), torch.float32),
        "conv": ((cfg.num_layers, 3, s.d_conv - 1, conv_dim), torch.bfloat16),
    }]}]
    assert model.cache_spec(3, 40) == model.cache_spec(3, 4000) == want
    cache = model.new_cache(3, 40, "cpu")
    assert {k: (tuple(t.shape), t.dtype) for k, t in cache[0]["blocks"][0].items()} == want[0]["blocks"][0]


def _f32_pair(ref, arch=ARCH):
    """The reference model and the port's on the same f32 weights."""
    ref_cfg, cfg = _configs(ref, "float32", arch)
    ref_model = ref.Model(ref_cfg)
    ref_params = ref_model.init(jax.random.PRNGKey(0))
    return ref_model, ref_params, Model(cfg), params_from_reference(jax.tree.map(np.asarray, ref_params), device="cpu")


@pytest.mark.parametrize("s", [12, 13, 20])
def test_prefill_takes_any_prompt_length(reference_stack, s):  # noqa: F811
    """Lengths that are not a multiple of the kernel's tile: q, k and v are
    padded to 64 for the kernel and the output is cut back."""
    ref_model, ref_params, model, params = _f32_pair(reference_stack)
    rng = np.random.default_rng(s)
    tokens = rng.integers(0, model.cfg.vocab_size, (B, s), dtype=np.int32)
    forced = rng.integers(0, model.cfg.vocab_size, (B, 1), dtype=np.int32)

    want_logits, want_cache = ref_model.prefill(ref_params, {"tokens": jnp.asarray(tokens)})
    logits, cache = model.prefill(params, {"tokens": torch.from_numpy(tokens)}, seq_cap=s + 1)
    _close(logits, want_logits, "float32", f"prefill logits at S={s}")
    want_cache = [
        {"blocks": [{name: jnp.pad(x, [(0, 0), (0, 0), (0, 1), (0, 0), (0, 0)]) for name, x in blk.items()}
                    for blk in seg["blocks"]]}
        for seg in want_cache
    ]
    want_logits, _ = ref_model.decode_step(ref_params, want_cache, jnp.asarray(forced), jnp.int32(s))
    logits, _ = model.decode_step(params, cache, torch.from_numpy(forced), s)
    _close(logits, want_logits, "float32", f"decode logits after S={s}")


@pytest.mark.parametrize("start,step", [(7, 1), (0, 2)])
def test_prefill_rotates_by_the_given_positions(reference_stack, start, step):  # noqa: F811
    """positions ``start + step * arange``: a shift leaves RoPE's relative
    angles as they were, a stride changes them, and both match the reference."""
    ref_model, ref_params, model, params = _f32_pair(reference_stack)
    s = 12
    tokens = np.random.default_rng(7).integers(0, model.cfg.vocab_size, (B, s), dtype=np.int32)
    positions = np.broadcast_to(start + step * np.arange(s, dtype=np.int32), (B, s))
    want, _ = ref_model.prefill(ref_params, {"tokens": jnp.asarray(tokens), "positions": jnp.asarray(positions)})
    got, _ = model.prefill(params, {"tokens": torch.from_numpy(tokens), "positions": torch.from_numpy(positions.copy())})
    _close(got, want, "float32", f"prefill logits at positions {start} + {step} * arange")
    if step > 1:
        default, _ = model.prefill(params, {"tokens": torch.from_numpy(tokens)})
        assert not torch.allclose(got, default, atol=1e-3)  # the positions reach RoPE


def test_the_prefill_step_passes_positions_to_the_model():
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.steps import build_prefill_step

    cfg = dataclasses.replace(port_configs.get_smoke_config(ARCH), dtype="float32")
    step = build_prefill_step(cfg, ShapeConfig("serve", 12, B, "prefill"), "cpu")
    params = step.model.init(0, "cpu")
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, (B, 12), dtype=np.int32)
    positions = np.broadcast_to(2 * np.arange(12, dtype=np.int32), (B, 12)).copy()
    got, _ = step.fn(params, {"tokens": tokens, "positions": positions})
    want, _ = step.model.prefill(params, {"tokens": torch.from_numpy(tokens), "positions": torch.from_numpy(positions)})
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    default, _ = step.fn(params, {"tokens": tokens})
    assert not torch.allclose(got, default, atol=1e-3)


def test_positions_that_do_not_strictly_increase_raise(reference_stack, monkeypatch):  # noqa: F811
    """Positions that restart, repeat or reverse are served as the reference
    serves them: the kernel masks by position, and the prefill's logits and
    k/v cache match the reference's in f32.  Positions of another shape
    than the tokens' still raise, and an SSD stack, which reads no
    positions, takes any."""
    got, want = prefill_at_positions(reference_stack, monkeypatch, ARCH)
    _close(got[0], want[0], "float32", "prefill logits")
    for seg, want_seg in zip(got[1], want[1]):
        for blk, want_blk in zip(seg["blocks"], want_seg["blocks"]):
            assert blk.keys() == want_blk.keys() == {"k", "v"}
            for name in blk:
                _close(blk[name], want_blk[name], "float32", f"prefill cache {name}")
    model = Model(port_configs.get_smoke_config(ARCH))
    params = model.init(0, "cpu")
    tokens = torch.zeros((1, 24), dtype=torch.int64) + 3
    restart = torch.cat([torch.arange(12), torch.arange(12)])[None]  # two packed documents
    with pytest.raises(ValueError, match=r"\(B, S\)"):
        model.prefill(params, {"tokens": tokens, "positions": torch.arange(12)[None]})
    ssd = Model(port_configs.get_smoke_config("mamba2-780m"))  # no attention: positions are not read
    logits, _ = ssd.prefill(ssd.init(0, "cpu"), {"tokens": tokens, "positions": restart})
    assert torch.isfinite(logits).all()
