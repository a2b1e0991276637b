"""DeepSeek-V3's MLA, Yi-6B, OLMo-1B and Qwen1.5-110B at the reference's
long serving shapes, cut to the CPU's size.

The reference's ``prefill_32k`` and ``decode_32k`` (``configs/base.py``)
take every config's attention past ``_sdpa``'s 2,048-key threshold, where
the reference leaves its plain softmax for ``_chunked_attention``'s online
softmax over 1,024-key blocks.  Here they run at smoke width in f32, 2
rows of 4,096 tokens, the steps built by the port's ``build_step`` from
those shapes:

  - deepseek-v3-smoke (one dense MLA layer, then three with 8 experts top
    2 and a shared expert): the port's prefill (the non-absorbed form, its
    4 heads of 16 + 8 dims in the kernel's plain version, v padded) against
    the reference's, the logits and every layer's latents ``ckv`` and
    ``k_rope`` within 2e-5 of the largest reference value; then 8 greedy
    absorbed decode steps (``mla_decode``) into a latent cache of 4,160
    slots against the reference's decode (1e-4).  The MoE layers replay
    the reference's expert choices (``route_check``), and the port's own
    choices may differ from them only at a near-tie (SWAP_GAP_F32);
  - the same model and weights with a capacity that drops no pair: each
    absorbed decode step against the port's own prefill of the prompt and
    the ids fed so far (2e-5).  MoE capacity is per sequence
    (``capacity_per_seq``): at the config's own factor a prefill of 4,097
    tokens may keep a pair that the prefill of 4,096 dropped, which is the
    reference's semantics and not a fault of either path;
  - yi-smoke (4 heads over 2 kv heads), olmo-smoke (MHA) and qwen1.5-smoke
    (4 heads over 2 kv heads, QKV biases drawn): the prefill's logits and
    every layer's k and v within 2e-5.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro_torch.kernels import flash_attention as fa  # noqa: E402
from torch_parity import (  # noqa: E402,F401
    long_steps, reference_routes, reference_stack, rel_err, smoke_pair,
)

import route_check  # noqa: E402  (tools/, put on the path by torch_parity)

B, S, STEPS = 2, 4096, 8  # past the reference's 2,048-key threshold
CAP = S + 64  # decode_32k's cache: 64 slots past the prompt
PREFILL_REL = 2e-5  # f32: of the largest reference value
DECODE_REL = 1e-4
SWAP_GAP_F32 = 1e-5  # f32: a route may differ only where the reference's k-th and (k+1)-th probabilities are closer
DEEPSEEK = "deepseek-v3-671b"


def _grow(cache):
    """The reference's cache with its slots grown from S to CAP, as its
    server's ``_grow_cache`` pads them."""
    return [{"blocks": [{n: jnp.pad(x, [(0, 0), (0, 0), (0, CAP - S)] + [(0, 0)] * (x.ndim - 3))
                         for n, x in blk.items()} for blk in seg["blocks"]]}
            for seg in cache]


def _assert_routes(cfg, want: list, got: list, calls: int) -> None:
    """The port's own expert choices against the reference's: both ran
    ``calls`` passes over the MoE layers; a choice may differ only at a
    near-tie."""
    assert len(got) == calls * sum(is_moe for _, is_moe in cfg.layer_plan())
    diffs = route_check.compare(cfg, want, got)
    assert all(d.kind == "swap" and d.gap <= SWAP_GAP_F32 for d in diffs), route_check.summary(diffs, 0)


def _assert_cache(got, want, names: tuple) -> None:
    """Every layer's ``names`` entries: the prompt's slots within
    PREFILL_REL of the largest reference value, the slots past it (where
    the capacity exceeds the prompt) untouched."""
    for seg, want_seg in zip(got, want):
        for blk, want_blk in zip(seg["blocks"], want_seg["blocks"]):
            assert blk.keys() == want_blk.keys() == set(names)
            for name in names:
                assert not blk[name][:, :, S:].any(), name
                assert (err := rel_err(blk[name][:, :, :S], want_blk[name])) <= PREFILL_REL, f"cache {name} {err:.3g}"


def _deepseek(ref, monkeypatch, steps: int):
    """deepseek-v3-smoke through ``decode_32k``'s steps, the reference's run
    first: its prefill of 2 x 4,096 tokens and ``steps`` greedy decode
    steps, recording its expert choices; then the port's, replaying them.
    Returns, for each side, the prefill's (logits, cache), each step's
    logits and the ids fed."""
    ref_model, ref_params, cfg, params = smoke_pair(ref, DEEPSEEK)
    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, (B, S), dtype=np.int32)
    with reference_routes(monkeypatch) as want_routes:
        logits, cache = ref_model.prefill(ref_params, {"tokens": jnp.asarray(tokens)})
        want = {"prefill": jax.tree.map(np.asarray, (logits, cache)), "steps": [], "ids": []}
        cache = _grow(cache)
        for t in range(steps):
            ids = jnp.argmax(logits, axis=-1)[:, None].astype(jnp.int32)
            logits, cache = ref_model.decode_step(ref_params, cache, ids, jnp.int32(S + t))
            want["ids"].append(np.asarray(ids))
            want["steps"].append(np.asarray(logits))
    prefill, decode = long_steps(cfg, "decode_32k", CAP, B)
    launches = fa.flash_attention.launches
    with route_check.RouteRecorder(replay=want_routes.idx) as got_routes:
        logits, cache = prefill(params, {"tokens": tokens}, seq_cap=CAP)
        got = {"prefill": (logits, jax.tree.map(torch.clone, cache)), "steps": [], "ids": []}
        for t in range(steps):
            ids = logits.argmax(dim=-1)[:, None].to(torch.int32)
            logits, cache = decode(params, cache, ids, S + t)
            got["ids"].append(ids.numpy())
            got["steps"].append(logits)
    assert fa.flash_attention.launches == launches  # CPU tensors: the plain version
    _assert_routes(cfg, want_routes.probs, got_routes.probs, 1 + steps)
    return got, want


def test_deepseek_mla_prefill_past_the_chunked_attention_threshold(reference_stack, monkeypatch):  # noqa: F811
    """2 x 4,096 tokens through the ``decode_32k`` step's prefill: logits
    and every layer's ``ckv`` and ``k_rope`` within 2e-5 of the largest
    reference value; the latent cache's slots past the prompt untouched."""
    got, want = _deepseek(reference_stack, monkeypatch, 0)
    (logits, cache), (want_logits, want_cache) = got["prefill"], want["prefill"]
    assert (err := rel_err(logits, want_logits)) <= PREFILL_REL, f"prefill logits {err:.3g}"
    _assert_cache(cache, want_cache, ("ckv", "k_rope"))


def test_deepseek_absorbed_decode_over_a_long_latent_cache(reference_stack, monkeypatch):  # noqa: F811
    """8 greedy absorbed decode steps after the 4,096-token prompt, in a
    latent cache of 4,160 slots: the same ids as the reference's, and each
    step's logits within 1e-4 of the largest value of the reference's
    decode on its cache grown to 4,160."""
    got, want = _deepseek(reference_stack, monkeypatch, STEPS)
    for t in range(STEPS):
        np.testing.assert_array_equal(got["ids"][t], want["ids"][t], err_msg=f"step {t} ids")
        assert (err := rel_err(got["steps"][t], want["steps"][t])) <= DECODE_REL, f"decode step {t} {err:.3g}"


def test_deepseek_absorbed_decode_repeats_the_longer_prefill(reference_stack):  # noqa: F811
    """deepseek-v3-smoke at a capacity factor of experts / top-k, where
    ``capacity_per_seq`` reaches the sequence's length and no pair is
    dropped: 8 greedy absorbed decode steps after the 4,096-token prompt,
    the first and the last against the port's own prefill of the prompt
    and the ids fed so far (4,097 tokens, padded to 4,160 for the kernel,
    and 4,104), whose last logits they must repeat within 2e-5."""
    _, _, cfg, params = smoke_pair(reference_stack, DEEPSEEK)
    moe = cfg.moe
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        moe, capacity_factor=moe.n_experts / moe.experts_per_token))
    prefill, decode = long_steps(cfg, "decode_32k", CAP, B)
    fed = np.random.default_rng(2).integers(0, cfg.vocab_size, (B, S), dtype=np.int32)
    logits, cache = prefill(params, {"tokens": fed}, seq_cap=CAP)
    for t in range(STEPS):
        ids = logits.argmax(dim=-1)[:, None].to(torch.int32)
        logits, cache = decode(params, cache, ids, S + t)
        fed = np.concatenate([fed, ids.numpy()], axis=1)
        if t in (0, STEPS - 1):
            again, _ = prefill(params, {"tokens": fed}, seq_cap=CAP)
            assert (err := rel_err(logits, again)) <= PREFILL_REL, f"decode step {t} against prefill {err:.3g}"


@pytest.mark.parametrize("arch", ["yi-6b", "olmo-1b", "qwen1.5-110b"])
def test_dense_prefill_past_the_chunked_attention_threshold(reference_stack, arch):  # noqa: F811
    """2 x 4,096 tokens through the ``prefill_32k`` step: logits and every
    layer's k and v within 2e-5 of the largest reference value.  Qwen1.5's
    QKV biases, which the reference initialises to zeros, are drawn
    (``draw_zero_leaves``, the same values in both packages)."""
    drawn = 5 if arch == "qwen1.5-110b" else None
    ref_model, ref_params, cfg, params = smoke_pair(reference_stack, arch, drawn=drawn)
    if drawn is not None:
        assert cfg.qkv_bias and params["segments"][0]["blocks"][0]["mixer"]["bq"].any()
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, (B, S), dtype=np.int32)
    prefill, _ = long_steps(cfg, "prefill_32k", S, B)
    launches = fa.flash_attention.launches
    logits, cache = prefill(params, {"tokens": tokens})
    assert fa.flash_attention.launches == launches
    want_logits, want_cache = ref_model.prefill(ref_params, {"tokens": jnp.asarray(tokens)})
    assert (err := rel_err(logits, want_logits)) <= PREFILL_REL, f"prefill logits {err:.3g}"
    _assert_cache(cache, want_cache, ("k", "v"))
