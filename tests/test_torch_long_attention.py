"""DeepSeek-V3's MLA, Granite-MoE, MusicGen, InternVL2, Yi-6B, OLMo-1B and
Qwen1.5-110B at the reference's long serving shapes, cut to the CPU's size.

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
  - granite-moe-smoke (4 heads over 2 kv heads, 4 experts top 2 in every
    layer) the same way: its prefill's logits and every layer's k and v
    (2e-5), 8 greedy decode steps (1e-4), both on the reference's expert
    choices, and at the capacity that drops no pair its decode steps
    against its own longer prefill (2e-5);
  - yi-smoke (4 heads over 2 kv heads), olmo-smoke (MHA), qwen1.5-smoke
    (4 heads over 2 kv heads, QKV biases drawn), musicgen-smoke (MHA; tokens
    (B, S, 4), their four embeddings summed, logits (B, 4, padded_vocab))
    and internvl2-smoke (4 heads over 2 kv heads; its first 8 positions
    take ``vis_embed @ vis_proj``, drawn with numpy, the same in both
    packages; on ``condition_attention``'s weights): the prefill's logits and every layer's k and v within 2e-5;
    and musicgen-smoke and internvl2-smoke through 8 greedy decode steps
    (MusicGen's four ids a row fed back as (B, 1, 4)) against the
    reference's decode (1e-4).

Logits are compared over the real vocabulary: the head's padding columns
(musicgen-smoke's 64 of 128) hold -2**30 in both packages, which would
make any bar over the largest value pass.  On the CPU no kernel launches.
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
DEEPSEEK, GRANITE = "deepseek-v3-671b", "granite-moe-1b-a400m"
# internvl2-smoke (no qk_norm) runs on condition_attention's weights: on its seed-0 weights moving every
# weight by one f32 ulp moves the port's own prefill logits by 2.3-3.7e-5 of the largest at 2 x 4,096
# tokens, as far as the port sits from the reference there (3.1e-5), over PREFILL_REL; on these 4.6-4.9e-7
# and 5.0e-7 (tests/torch_parity_conditioning.py)
CONDITIONED = ("internvl2-2b",)


def _prompt(cfg, seed: int) -> dict:
    """Seeded numpy prompts of B x S, the same values for both packages:
    tokens (B, S), or (B, S, n_codebooks) codebook ids; a vision-prefix
    config also takes ``vis_embed`` (B, vis_prefix_len, d_model), N(0, 1)."""
    rng = np.random.default_rng(seed)
    shape = (B, S, cfg.n_codebooks) if cfg.n_codebooks > 1 else (B, S)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, shape, dtype=np.int32)}
    if cfg.vis_prefix_len:
        batch["vis_embed"] = rng.standard_normal((B, cfg.vis_prefix_len, cfg.d_model)).astype(np.float32)
    return batch


def _vocab(cfg, logits):
    """The logits' real vocabulary columns; the head's padding columns
    past them must hold -2**30."""
    assert (np.asarray(logits[..., cfg.vocab_size:]) == -(2.0**30)).all()
    return logits[..., :cfg.vocab_size]


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


def _greedy(ref, monkeypatch, arch: str, steps: int):
    """``arch``'s smoke config through ``decode_32k``'s steps, the
    reference's run first: its prefill of the seeded 2 x 4,096-token prompts
    (``_prompt``) and ``steps`` greedy decode steps (a multi-codebook
    config feeds its ids back as (B, 1, n_codebooks)), recording its expert
    choices; then the port's, replaying them.  Returns the port's config
    and, for each side, the prefill's (logits, cache), each step's logits
    and the ids fed."""
    ref_model, ref_params, cfg, params = smoke_pair(ref, arch, conditioned=arch in CONDITIONED)
    batch = _prompt(cfg, 2)
    with reference_routes(monkeypatch) as want_routes:
        logits, cache = ref_model.prefill(ref_params, {k: jnp.asarray(v) for k, v in batch.items()})
        want = {"prefill": jax.tree.map(np.asarray, (logits, cache)), "steps": [], "ids": []}
        cache = _grow(cache)
        for t in range(steps):
            ids = jnp.argmax(logits, axis=-1)[:, None].astype(jnp.int32)
            logits, cache = ref_model.decode_step(ref_params, cache, ids, jnp.int32(S + t))
            want["ids"].append(np.asarray(ids))
            want["steps"].append(np.asarray(logits))
    prefill, decode = long_steps(cfg, "decode_32k", CAP, B)
    launches = fa.flash_attention.launches
    with route_check.RouteRecorder(replay=want_routes.idx if cfg.moe else None) as got_routes:
        logits, cache = prefill(params, batch, seq_cap=CAP)
        got = {"prefill": (logits, jax.tree.map(torch.clone, cache)), "steps": [], "ids": []}
        for t in range(steps):
            ids = logits.argmax(dim=-1)[:, None].to(torch.int32)
            logits, cache = decode(params, cache, ids, S + t)
            got["ids"].append(ids.numpy())
            got["steps"].append(logits)
    assert fa.flash_attention.launches == launches  # CPU tensors: the plain version
    if cfg.moe:
        _assert_routes(cfg, want_routes.probs, got_routes.probs, 1 + steps)
    return cfg, got, want


def _assert_decode(cfg, got: dict, want: dict) -> None:
    """Each greedy step fed the reference's ids, and its logits within
    DECODE_REL of the largest value of the reference's."""
    for t, (logits, want_logits) in enumerate(zip(got["steps"], want["steps"], strict=True)):
        np.testing.assert_array_equal(got["ids"][t], want["ids"][t], err_msg=f"step {t} ids")
        err = rel_err(_vocab(cfg, logits), _vocab(cfg, want_logits))
        assert err <= DECODE_REL, f"decode step {t} {err:.3g}"


def test_deepseek_mla_prefill_past_the_chunked_attention_threshold(reference_stack, monkeypatch):  # noqa: F811
    """2 x 4,096 tokens through the ``decode_32k`` step's prefill: logits
    and every layer's ``ckv`` and ``k_rope`` within 2e-5 of the largest
    reference value; the latent cache's slots past the prompt untouched."""
    cfg, got, want = _greedy(reference_stack, monkeypatch, DEEPSEEK, 0)
    (logits, cache), (want_logits, want_cache) = got["prefill"], want["prefill"]
    assert (err := rel_err(_vocab(cfg, logits), _vocab(cfg, want_logits))) <= PREFILL_REL, f"prefill logits {err:.3g}"
    _assert_cache(cache, want_cache, ("ckv", "k_rope"))


def test_deepseek_absorbed_decode_over_a_long_latent_cache(reference_stack, monkeypatch):  # noqa: F811
    """8 greedy absorbed decode steps after the 4,096-token prompt, in a
    latent cache of 4,160 slots: the same ids as the reference's, and each
    step's logits within 1e-4 of the largest value of the reference's
    decode on its cache grown to 4,160."""
    _assert_decode(*_greedy(reference_stack, monkeypatch, DEEPSEEK, STEPS))


def _decode_repeats_the_longer_prefill(ref, arch: str) -> None:
    """``arch``'s smoke config at a capacity factor of experts / top-k,
    where ``capacity_per_seq`` reaches the sequence's length and no pair is
    dropped: 8 greedy decode steps after the 4,096-token prompt, the first
    and the last against the port's own prefill of the prompt and the ids
    fed so far (4,097 tokens, padded to 4,160 for the kernel, and 4,104),
    whose last logits they must repeat within 2e-5."""
    _, _, cfg, params = smoke_pair(ref, arch)
    moe = cfg.moe
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        moe, capacity_factor=moe.n_experts / moe.experts_per_token))
    prefill, decode = long_steps(cfg, "decode_32k", CAP, B)
    fed = _prompt(cfg, 2)["tokens"]
    logits, cache = prefill(params, {"tokens": fed}, seq_cap=CAP)
    for t in range(STEPS):
        ids = logits.argmax(dim=-1)[:, None].to(torch.int32)
        logits, cache = decode(params, cache, ids, S + t)
        fed = np.concatenate([fed, ids.numpy()], axis=1)
        if t in (0, STEPS - 1):
            again, _ = prefill(params, {"tokens": fed}, seq_cap=CAP)
            assert (err := rel_err(logits, again)) <= PREFILL_REL, f"decode step {t} against prefill {err:.3g}"


def test_deepseek_absorbed_decode_repeats_the_longer_prefill(reference_stack):  # noqa: F811
    """DeepSeek's absorbed decode at the capacity that drops no pair
    (``_decode_repeats_the_longer_prefill``)."""
    _decode_repeats_the_longer_prefill(reference_stack, DEEPSEEK)


def test_granite_prefill_past_the_chunked_attention_threshold(reference_stack, monkeypatch):  # noqa: F811
    """granite-moe-smoke, 2 x 4,096 tokens through the ``decode_32k``
    step's prefill on the reference's expert choices: logits and every
    layer's k and v within 2e-5 of the largest reference value; the port's
    own choices equal the reference's but at a near-tie."""
    cfg, got, want = _greedy(reference_stack, monkeypatch, GRANITE, 0)
    (logits, cache), (want_logits, want_cache) = got["prefill"], want["prefill"]
    assert (err := rel_err(_vocab(cfg, logits), _vocab(cfg, want_logits))) <= PREFILL_REL, f"prefill logits {err:.3g}"
    _assert_cache(cache, want_cache, ("k", "v"))


def test_granite_decode_repeats_the_longer_prefill(reference_stack):  # noqa: F811
    """Granite-MoE's decode at the capacity that drops no pair
    (``_decode_repeats_the_longer_prefill``): the step Granite's
    ``decode_32k`` check on the card holds to the prefill of one token more."""
    _decode_repeats_the_longer_prefill(reference_stack, GRANITE)


@pytest.mark.parametrize("arch", ["musicgen-medium", "internvl2-2b", GRANITE])
def test_decode_past_the_chunked_attention_threshold(reference_stack, monkeypatch, arch):  # noqa: F811
    """8 greedy decode steps after the 2 x 4,096-token prompts, into a
    cache of 4,160 slots: the same ids as the reference's (MusicGen's four
    a row) and each step's logits within 1e-4 of the largest value of the
    reference's decode on its cache grown to 4,160 (Granite on the
    reference's expert choices)."""
    _assert_decode(*_greedy(reference_stack, monkeypatch, arch, STEPS))


@pytest.mark.parametrize("arch", ["yi-6b", "olmo-1b", "qwen1.5-110b", "musicgen-medium", "internvl2-2b"])
def test_dense_prefill_past_the_chunked_attention_threshold(reference_stack, arch):  # noqa: F811
    """2 x 4,096 tokens through the ``prefill_32k`` step: logits and every
    layer's k and v within 2e-5 of the largest reference value.  Qwen1.5's
    QKV biases, which the reference initialises to zeros, are drawn
    (``draw_zero_leaves``, the same values in both packages); MusicGen
    takes codebook ids (B, S, 4), InternVL2 ``vis_embed`` over its first
    positions (on ``condition_attention``'s weights: ``CONDITIONED``)."""
    drawn = 5 if arch == "qwen1.5-110b" else None
    ref_model, ref_params, cfg, params = smoke_pair(reference_stack, arch, drawn=drawn,
                                                    conditioned=arch in CONDITIONED)
    if drawn is not None:
        assert cfg.qkv_bias and params["segments"][0]["blocks"][0]["mixer"]["bq"].any()
    batch = _prompt(cfg, 3)
    prefill, _ = long_steps(cfg, "prefill_32k", S, B)
    launches = fa.flash_attention.launches
    logits, cache = prefill(params, batch)
    assert fa.flash_attention.launches == launches
    want_logits, want_cache = ref_model.prefill(ref_params, {k: jnp.asarray(v) for k, v in batch.items()})
    assert (err := rel_err(_vocab(cfg, logits), _vocab(cfg, want_logits))) <= PREFILL_REL, f"prefill logits {err:.3g}"
    _assert_cache(cache, want_cache, ("k", "v"))
