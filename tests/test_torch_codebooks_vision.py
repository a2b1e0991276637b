"""MusicGen's multi-codebook head and InternVL2's vision prefix: the port
held to the reference.

The reference ``Model`` is initialized on ``musicgen-smoke`` (MHA with
LayerNorm and GELU; tokens (B, S, 4), their four embeddings summed, logits
(..., 4, padded_vocab)) and ``internvl2-smoke`` (a GQA decoder whose first
8 positions take ``vis_embed @ vis_proj``) from ``PRNGKey(0)``; its
parameters cross to the port, and the same seeded numpy inputs go through
both: ``apply_embed``, ``prefill`` and forced decode steps, greedy ids from
the port's step builders, ``train_loss`` and its gradients, and one
``build_train_step`` step.  The reference's ``BatchServer`` serves neither
model (its byte prompts carry one codebook and no image), so the port's
raises for both.

Bars, the repo's own: f32 1e-4 (atol and rtol for outputs, of the largest
|value| for a gradient leaf; ``test_torch_models``, ``test_torch_train``),
the loss and parameters after a step 2e-5 (``F32_ATOL``); the codebook sum,
elementwise, one bf16 ulp; bf16 model outputs 2e-2 of the largest value on
``condition_attention``'s weights (neither model has qk_norm), a bf16
gradient leaf within 2e-2 or 1.5x the reference's own bf16 rounding of it.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro_torch import configs as port_configs  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.launch.steps import build_decode_step, build_prefill_step, build_train_step  # noqa: E402
from repro_torch.models import Model, layers, params_from_reference, tree_to_numpy  # noqa: E402
from repro_torch.optim import init_opt_state  # noqa: E402
from repro_torch.runtime import BatchServer  # noqa: E402
from repro_torch.tree import tree_items  # noqa: E402
from torch_parity import (  # noqa: E402,F401
    F32_ATOL,
    assert_bf16_within_ulp,
    condition_attention,
    reference_stack,
)

ARCHS = ["musicgen-medium", "internvl2-2b"]
B, S, STEPS = 2, 24, 3  # internvl2-smoke: 8 vision positions, then 16 tokens
F32_BAR, BF16_REL, OWN_ROUNDING = 1e-4, 2e-2, 1.5


def _f32(a) -> np.ndarray:
    return np.asarray(a.detach().float().numpy() if isinstance(a, torch.Tensor) else a, np.float32)


def _rel(got, want) -> float:
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _close(got, want, dtype, what):
    if dtype == "float32":
        np.testing.assert_allclose(_f32(got), _f32(want), atol=F32_BAR, rtol=F32_BAR, err_msg=what)
    else:
        assert _rel(got, want) <= BF16_REL, f"{what}: {_rel(got, want):.3g} of the largest value"


def _setup(ref, arch, dtype, conditioned=None):
    """Both configs, the reference model and its numpy parameters (scaled by
    ``condition_attention`` in bf16), the port's model and its parameters."""
    ref_cfg = dataclasses.replace(ref.get_smoke_config(arch), dtype=dtype)
    cfg = dataclasses.replace(port_configs.get_smoke_config(arch), dtype=dtype)
    ref_model = ref.Model(ref_cfg)
    params_np = jax.tree.map(np.asarray, ref_model.init(jax.random.PRNGKey(0)))
    if conditioned if conditioned is not None else dtype == "bfloat16":
        params_np = condition_attention(cfg, params_np)
    model = Model(cfg)
    assert model.param_count() == ref_model.param_count()
    return ref_model, params_np, model, params_from_reference(params_np, device="cpu")


def _inputs(cfg, seed: int, train: bool = False, rows: int = B) -> dict:
    """Seeded numpy inputs: tokens (B, S, ncb) or (B, S), ``vis_embed``
    (bf16 values in f32) where the config has a vision prefix; with
    ``train``, labels of the tokens' shape, some masked, and the vision
    prefix's masked as ``tests/test_arch_smoke.py`` does."""
    rng = np.random.default_rng(seed)
    shape = (rows, S, cfg.n_codebooks) if cfg.n_codebooks > 1 else (rows, S)
    out = {"tokens": rng.integers(0, cfg.vocab_size, shape, dtype=np.int32)}
    if cfg.vis_prefix_len:
        vis = rng.standard_normal((rows, cfg.vis_prefix_len, cfg.d_model)).astype(np.float32)
        out["vis_embed"] = torch.from_numpy(vis).bfloat16().float().numpy()
    if train:
        labels = rng.integers(0, cfg.vocab_size, shape, dtype=np.int32)
        labels[rng.random(shape) < 0.1] = -1
        labels[:, :cfg.vis_prefix_len] = -1
        out["labels"] = labels
    return out


def _forced(cfg, seed: int) -> np.ndarray:
    shape = (STEPS, B, 1, cfg.n_codebooks) if cfg.n_codebooks > 1 else (STEPS, B, 1)
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape, dtype=np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_embed_sums_the_four_codebooks(reference_stack, dtype):  # noqa: F811
    from repro.models import layers as ref_layers

    ref_cfg = dataclasses.replace(reference_stack.get_smoke_config("musicgen-medium"), dtype=dtype)
    cfg = dataclasses.replace(port_configs.get_smoke_config("musicgen-medium"), dtype=dtype)
    table = np.random.default_rng(1).standard_normal((4, cfg.padded_vocab, cfg.d_model)).astype(np.float32)
    p_np = {"tok": jnp.asarray(table).astype(jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)}
    tokens = _inputs(cfg, 2)["tokens"]
    want = ref_layers.apply_embed(ref_cfg, p_np, jnp.asarray(tokens))
    got = layers.apply_embed(cfg, params_from_reference(jax.tree.map(np.asarray, p_np), device="cpu"),
                             torch.from_numpy(tokens))
    assert got.dtype == (torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    if dtype == "float32":
        np.testing.assert_allclose(_f32(got), np.asarray(want), atol=F32_ATOL, rtol=0)
    else:
        assert_bf16_within_ulp(_f32(got), np.asarray(want, np.float32))


def _grow(cache, steps):
    """The reference's prefill cache with k/v padded to capacity S + steps,
    as the reference server's ``_grow_cache`` does."""
    return [{"blocks": [{name: jnp.pad(x, [(0, 0), (0, 0), (0, steps)] + [(0, 0)] * (x.ndim - 3))
                         for name, x in blk.items()} for blk in seg["blocks"]]} for seg in cache]


def _ref_inputs(batch: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _port_inputs(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_the_reference(reference_stack, arch, dtype):  # noqa: F811
    ref_model, params_np, model, params = _setup(reference_stack, arch, dtype)
    cfg = model.cfg
    batch, forced = _inputs(cfg, 3), _forced(cfg, 4)
    ref_params = jax.tree.map(jnp.asarray, params_np)

    want_logits, want_cache = ref_model.prefill(ref_params, _ref_inputs(batch))
    launches = fa.flash_attention.launches
    logits, cache = model.prefill(params, _port_inputs(batch), seq_cap=S + STEPS)
    assert fa.flash_attention.launches == launches  # CPU tensors: the plain version
    shape = (B, cfg.n_codebooks, cfg.padded_vocab) if cfg.n_codebooks > 1 else (B, cfg.padded_vocab)
    v = cfg.vocab_size  # musicgen-smoke's 64 pad to 128: the masked columns are compared apart
    assert tuple(logits.shape) == shape
    assert (logits[..., v:] == -(2.0**30)).all() and (np.asarray(want_logits)[..., v:] == -(2.0**30)).all()
    _close(logits[..., :v], want_logits[..., :v], dtype, "prefill logits")
    want_cache = _grow(want_cache, STEPS)
    for seg, want_seg in zip(cache, want_cache):
        for blk, want_blk in zip(seg["blocks"], want_seg["blocks"]):
            assert blk.keys() == want_blk.keys() == {"k", "v"}
            for name in blk:
                assert not blk[name][:, :, S:].any()
                _close(blk[name], want_blk[name], dtype, f"prefill cache {name}")
    for t in range(STEPS):
        want_logits, want_cache = ref_model.decode_step(ref_params, want_cache, jnp.asarray(forced[t]),
                                                        jnp.int32(S + t))
        logits, cache = model.decode_step(params, cache, torch.from_numpy(forced[t]), S + t)
        assert tuple(logits.shape) == shape and (logits[..., v:] == -(2.0**30)).all()
        _close(logits[..., :v], want_logits[..., :v], dtype, f"decode step {t} logits")
    for seg, want_seg in zip(cache, want_cache):
        for blk, want_blk in zip(seg["blocks"], want_seg["blocks"]):
            for name in blk:
                _close(blk[name], want_blk[name], dtype, f"cache {name} after decode")


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_ids_from_the_step_builders_match_the_reference(reference_stack, arch):  # noqa: F811
    """The port's ``build_prefill_step`` and ``build_decode_step`` in the
    greedy loop of ``BatchServer._generate_batch`` (argmax over the last
    dim; MusicGen's next tokens ``cur[:, None, :]``) against the same loop
    over the reference's ``Model``, f32."""
    ref_model, params_np, model, params = _setup(reference_stack, arch, "float32")
    cfg = model.cfg
    batch = _inputs(cfg, 5)
    ref_params = jax.tree.map(jnp.asarray, params_np)

    def step_tokens(cur):
        return cur[:, None, :] if cfg.n_codebooks > 1 else cur[:, None]

    logits, cache = ref_model.prefill(ref_params, _ref_inputs(batch))
    cache = _grow(cache, STEPS)
    cur, want = jnp.argmax(logits, axis=-1).astype(jnp.int32), []
    for t in range(STEPS):
        want.append(np.asarray(cur))
        logits, cache = ref_model.decode_step(ref_params, cache, step_tokens(cur), jnp.int32(S + t))
        cur = jnp.argmax(logits, axis=-1).astype(jnp.int32)

    prefill = build_prefill_step(cfg, ShapeConfig("serve", S, B, "prefill"), "cpu").fn
    decode = build_decode_step(cfg, ShapeConfig("serve_d", S + STEPS, B, "decode"), "cpu").fn
    logits, cache = prefill(params, batch, seq_cap=S + STEPS)  # numpy in, vis_embed forwarded
    cur, got = logits.argmax(dim=-1), []
    for t in range(STEPS):
        got.append(cur.numpy())
        logits, cache = decode(params, cache, step_tokens(cur), S + t)
        cur = logits.argmax(dim=-1)
    np.testing.assert_array_equal(np.stack(got), np.stack(want))
    assert len(np.unique(np.stack(got))) > 1


def _ref_grads(ref_model, params_np, batch):
    (loss, metrics), grads = jax.value_and_grad(ref_model.train_loss, has_aux=True)(
        jax.tree.map(jnp.asarray, params_np), _ref_inputs(batch))
    flat = jax.tree_util.tree_flatten_with_path(grads)[0]
    return ({k: float(v) for k, v in metrics.items()},
            {jax.tree_util.keystr(p): np.asarray(g, np.float32) for p, g in flat})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_gradients_match_the_reference(reference_stack, arch, dtype):  # noqa: F811
    ref = reference_stack
    ref_model, params_np, model, params = _setup(ref, arch, dtype)
    batch = _inputs(model.cfg, 6, train=True)
    want_m, want = _ref_grads(ref_model, params_np, batch)
    named = list(tree_items(params))
    leaves = [t.requires_grad_() for _, t in named]
    loss, metrics = model.train_loss(params, _port_inputs(batch))
    grads = torch.autograd.grad(loss, leaves)
    got = {k: g.float().numpy() for (k, _), g in zip(named, grads)}
    assert got.keys() == want.keys()
    assert ("['vis_proj']['w']" in got) == (arch == "internvl2-2b")
    assert ("['final_norm']['bias']" in got) == (arch == "musicgen-medium")  # LayerNorm's f32 bias
    assert float(metrics["aux"]) == want_m["aux"] == 0
    for k in ("loss", "loss_lm"):
        bar = F32_ATOL if dtype == "float32" else BF16_REL * abs(want_m[k])
        assert abs(float(metrics[k]) - want_m[k]) <= bar, (k, float(metrics[k]), want_m[k])
    if dtype == "float32":
        for k in want:
            assert _rel(got[k], want[k]) <= F32_BAR, (k, _rel(got[k], want[k]))
        return
    f32_model = ref.Model(dataclasses.replace(ref_model.cfg, dtype="float32"))
    _, want_f32 = _ref_grads(f32_model, jax.tree.map(lambda a: np.asarray(a, np.float32), params_np), batch)
    for k in want:
        bar = max(BF16_REL, OWN_ROUNDING * _rel(want[k], want_f32[k]))
        assert _rel(got[k], want[k]) <= bar, (k, _rel(got[k], want[k]), bar)


@pytest.mark.parametrize("arch", ARCHS)
def test_an_adamw_step_matches_the_reference(reference_stack, arch):  # noqa: F811
    """One step of 4 rows in 2 microbatches, f32: ``build_train_step`` cuts
    ``vis_embed`` and the (B, S, 4) labels by rows as it cuts the tokens."""
    ref = reference_stack
    ref_model, params_np, model, params = _setup(ref, arch, "float32")
    cfg = model.cfg
    shape = ShapeConfig("t", S, 4, "train")
    ref_bundle = ref.build_train_step(ref_model.cfg, None, shape, grad_accum=2, donate=False)
    bundle = build_train_step(cfg, shape, grad_accum=2, device="cpu")
    batch = _inputs(cfg, 7, train=True, rows=4)
    ref_params = jax.tree.map(jnp.asarray, params_np)
    ref_params, _, want_m = ref_bundle.jitted(ref_params, ref.init_opt_state(ref_bundle.opt_cfg, ref_params),
                                              _ref_inputs(batch))
    params, opt, got_m = bundle.fn(params, init_opt_state(bundle.opt_cfg, params), batch)
    assert got_m.keys() == want_m.keys()
    for k in want_m:
        assert abs(float(got_m[k]) - float(want_m[k])) <= F32_ATOL * max(1.0, abs(float(want_m[k]))), k
    want = dict(tree_items(jax.tree.map(np.asarray, ref_params)))
    for k, a in tree_items(tree_to_numpy(params)):
        np.testing.assert_allclose(a, want[k], atol=F32_ATOL, rtol=0, err_msg=k)
    assert int(opt["step"]) == 1


def test_token_by_token_decode_reproduces_the_prefill():
    """MusicGen, f32: decode steps over the prompt's (B, 1, 4) tokens from
    an empty cache give the prefill's last logits, as
    ``tests/test_arch_smoke.py::test_decode_matches_prefill`` holds the
    reference's (there at 2e-3; here at the f32 model bar)."""
    cfg = dataclasses.replace(port_configs.get_smoke_config("musicgen-medium"), dtype="float32")
    model = Model(cfg)
    params = model.init(0, "cpu")
    tokens = torch.from_numpy(_inputs(cfg, 8)["tokens"])
    want, _ = model.prefill(params, {"tokens": tokens})
    cache = model.new_cache(B, S, "cpu")
    for t in range(S):
        got, cache = model.decode_step(params, cache, tokens[:, t:t + 1], t)
    torch.testing.assert_close(got[..., :cfg.vocab_size], want[..., :cfg.vocab_size], atol=F32_BAR, rtol=F32_BAR)


@pytest.mark.parametrize("case", ["tokens_without_codebooks", "no_vis_embed", "prompt_shorter_than_prefix"])
def test_inputs_the_models_cannot_take_raise(case):
    arch = "musicgen-medium" if case == "tokens_without_codebooks" else "internvl2-2b"
    model = Model(port_configs.get_smoke_config(arch))
    params = model.init(0, "cpu")
    batch = {k: torch.from_numpy(v) for k, v in _inputs(model.cfg, 9, train=True).items()}
    if case == "tokens_without_codebooks":
        batch = {k: v[..., 0] for k, v in batch.items()}
        match = r"\(B, S, 4\)"
    elif case == "no_vis_embed":
        del batch["vis_embed"]
        match = "vis_embed"
    else:
        batch = {"tokens": batch["tokens"][:, :5], "labels": batch["labels"][:, :5],
                 "vis_embed": batch["vis_embed"]}
        match = "vision prefix"
    with pytest.raises(ValueError, match=match):
        model.prefill(params, batch)
    with pytest.raises(ValueError, match=match):
        model.train_loss(params, batch)


@pytest.mark.parametrize("arch,ref_error", [("musicgen-medium", ValueError), ("internvl2-2b", KeyError)])
def test_batch_server_raises_where_the_reference_server_fails(reference_stack, arch, ref_error):  # noqa: F811
    """The reference's server feeds (B, S) byte ids and no ``vis_embed``:
    MusicGen's codebook sum fails on them, InternVL2's splice finds no key."""
    ref = reference_stack
    ref_cfg = dataclasses.replace(ref.get_smoke_config(arch), dtype="float32")
    cfg = dataclasses.replace(port_configs.get_smoke_config(arch), dtype="float32")
    prompts = ["hello world", "data loading is"]
    kw = {"batch_size": 2, "prompt_len": 16, "max_new": 2}
    with pytest.raises(ref_error):
        ref.BatchServer(ref_cfg, ref.Model(ref_cfg).init(jax.random.PRNGKey(0)), **kw).generate(prompts)
    with pytest.raises(NotImplementedError, match="byte prompts"):
        BatchServer(cfg, Model(cfg).init(0, "cpu"), device="cpu", **kw)
