"""Jamba's hybrid stack at the reference's long serving shapes, cut to the
CPU's size.

jamba-smoke is one super-block: an attention layer (4 heads over 2 kv
heads) with a dense FFN, then 7 SSD layers (chunk 16), every other one with
4 experts top 2.  Its prefill runs both kernels' plain versions, and its
cache holds both the attention layer's k/v and the SSD layers' state and
conv window.  Here it runs in f32, 2 rows of 4,096 tokens, past the
reference's 2,048-key threshold (its ``_chunked_attention``), the steps
built by the port's ``build_step`` from ``prefill_32k`` and ``decode_32k``:

  - the prefill against the reference's: logits, k/v, ``ssm`` and ``conv``
    within 2e-5 of the largest reference value, the reference's expert
    choices replayed (``route_check``) and the port's own equal to them;
  - 8 greedy decode steps into a cache of 4,160 slots against the
    reference's decode (1e-4), and the cache after them;
  - at a capacity factor of experts / top-k, where ``capacity_per_seq``
    reaches the sequence's length and no pair is dropped, decode steps 1
    and 8 against the port's own prefill of the prompt and the ids fed so
    far (4,097 tokens, which the SSD layers scan in chunks of 1, the chunk
    the reference picks there; and 4,104, chunks of 8): logits and every
    layer's state within 2e-5.  At the config's own factor a longer
    prefill may keep a pair the shorter one dropped, which is the
    reference's semantics (``test_torch_long_attention.py`` says the same
    of DeepSeek-V3).
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ssd_scan as ks  # noqa: E402
from repro_torch.models.ssm import scan_chunk  # noqa: E402
from torch_parity import (  # noqa: E402,F401
    long_steps, reference_routes, reference_stack, rel_err, smoke_pair,
)

import route_check  # noqa: E402  (tools/, put on the path by torch_parity)

B, S, STEPS = 2, 4096, 8  # past the reference's 2,048-key threshold
CAP = S + 64  # decode_32k's cache: 64 slots past the prompt
PREFILL_REL = 2e-5  # f32: of the largest reference value
DECODE_REL = 1e-4
JAMBA = "jamba-1.5-large-398b"
TOKENS = ("k", "v")  # the attention layer's cache entries, (n, B, slots, kv, hd)


def _grow(cache):
    """The reference's cache with its k/v slots grown from S to CAP, as its
    server's ``_grow_cache`` pads them; the SSD state does not grow."""
    return [{"blocks": [{n: jnp.pad(x, [(0, 0), (0, 0), (0, CAP - S)] + [(0, 0)] * (x.ndim - 3))
                         if n in TOKENS else x for n, x in blk.items()} for blk in seg["blocks"]]}
            for seg in cache]


def _cache_errors(got, want) -> dict:
    """Each cache entry's largest difference over its largest |want| value,
    the worst layer's; k/v over the slots ``want`` holds."""
    worst: dict[str, float] = {}
    for seg, want_seg in zip(got, want):
        for blk, want_blk in zip(seg["blocks"], want_seg["blocks"]):
            assert blk.keys() == want_blk.keys()
            for name, w in want_blk.items():
                g = blk[name][:, :, :w.shape[2]] if name in TOKENS else blk[name]
                for layer in range(w.shape[0]):
                    worst[name] = max(worst.get(name, 0.0), rel_err(g[layer], np.asarray(w[layer])))
    return worst


def _jamba(ref, monkeypatch, steps: int):
    """jamba-smoke through ``decode_32k``'s steps, the reference's run
    first: its prefill of 2 x 4,096 tokens and ``steps`` greedy decode
    steps, recording its expert choices; then the port's, replaying them
    (the port's own choices must equal them).  Returns, for each side, the
    prefill's (logits, cache), each step's logits, the ids fed and the
    final cache."""
    ref_model, ref_params, cfg, params = smoke_pair(ref, JAMBA)
    tokens = np.random.default_rng(4).integers(0, cfg.vocab_size, (B, S), dtype=np.int32)
    with reference_routes(monkeypatch) as want_routes:
        logits, cache = ref_model.prefill(ref_params, {"tokens": jnp.asarray(tokens)})
        want = {"prefill": jax.tree.map(np.asarray, (logits, cache)), "steps": [], "ids": []}
        cache = _grow(cache)
        for t in range(steps):
            ids = jnp.argmax(logits, axis=-1)[:, None].astype(jnp.int32)
            logits, cache = ref_model.decode_step(ref_params, cache, ids, jnp.int32(S + t))
            want["ids"].append(np.asarray(ids))
            want["steps"].append(np.asarray(logits))
        want["cache"] = jax.tree.map(np.asarray, cache)
    prefill, decode = long_steps(cfg, "decode_32k", CAP, B)
    launches = fa.flash_attention.launches, ks.ssd_scan.launches
    with route_check.RouteRecorder(replay=want_routes.idx) as got_routes:
        logits, cache = prefill(params, {"tokens": tokens}, seq_cap=CAP)
        got = {"prefill": (logits, jax.tree.map(torch.clone, cache)), "steps": [], "ids": []}
        for t in range(steps):
            ids = logits.argmax(dim=-1)[:, None].to(torch.int32)
            logits, cache = decode(params, cache, ids, S + t)
            got["ids"].append(ids.numpy())
            got["steps"].append(logits)
        got["cache"] = cache
    assert (fa.flash_attention.launches, ks.ssd_scan.launches) == launches  # CPU tensors: the plain versions
    moe_layers = sum(is_moe for _, is_moe in cfg.layer_plan())
    assert len(got_routes.probs) == (1 + steps) * moe_layers
    assert route_check.compare(cfg, want_routes.probs, got_routes.probs) == []
    return got, want


def test_jamba_prefill_past_the_chunked_attention_threshold(reference_stack, monkeypatch):  # noqa: F811
    """2 x 4,096 tokens through the ``decode_32k`` step's prefill (256
    chunks of 16 in each SSD layer): logits, the attention layer's k and v
    and each SSD layer's ``ssm`` and ``conv`` within 2e-5 of the largest
    reference value; the k/v slots past the prompt untouched."""
    got, want = _jamba(reference_stack, monkeypatch, 0)
    (logits, cache), (want_logits, want_cache) = got["prefill"], want["prefill"]
    assert (err := rel_err(logits, want_logits)) <= PREFILL_REL, f"prefill logits {err:.3g}"
    errs = _cache_errors(cache, want_cache)
    assert errs.keys() == {"k", "v", "ssm", "conv"}
    assert max(errs.values()) <= PREFILL_REL, errs
    attn = cache[0]["blocks"][0]
    assert not attn["k"][:, :, S:].any() and not attn["v"][:, :, S:].any()


def test_jamba_decode_after_a_long_prompt(reference_stack, monkeypatch):  # noqa: F811
    """8 greedy decode steps after the 4,096-token prompt, in a cache of
    4,160 slots: the same ids as the reference's, each step's logits within
    1e-4 of the largest value of the reference's decode on its cache grown
    to 4,160, and every cache entry after the last step so too."""
    got, want = _jamba(reference_stack, monkeypatch, STEPS)
    for t in range(STEPS):
        np.testing.assert_array_equal(got["ids"][t], want["ids"][t], err_msg=f"step {t} ids")
        assert (err := rel_err(got["steps"][t], want["steps"][t])) <= DECODE_REL, f"decode step {t} {err:.3g}"
    errs = _cache_errors(got["cache"], want["cache"])
    assert max(errs.values()) <= DECODE_REL, errs


def test_jamba_decode_repeats_the_longer_prefill(reference_stack):  # noqa: F811
    """jamba-smoke at a capacity factor of experts / top-k: 8 greedy decode
    steps after the 4,096-token prompt, the first and the last against the
    port's own prefill of the prompt and the ids fed so far (4,097 tokens,
    padded to 4,160 for attention, scanned in chunks of 1; and 4,104 in
    chunks of 8), whose last logits and whose cache (k/v over the slots
    filled, ``ssm``, ``conv``) they must repeat within 2e-5."""
    _, _, cfg, params = smoke_pair(reference_stack, JAMBA)
    moe = cfg.moe
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        moe, capacity_factor=moe.n_experts / moe.experts_per_token))
    assert (scan_chunk(cfg, S + 1), scan_chunk(cfg, S + STEPS)) == (1, 8)
    prefill, decode = long_steps(cfg, "decode_32k", CAP, B)
    fed = np.random.default_rng(4).integers(0, cfg.vocab_size, (B, S), dtype=np.int32)
    logits, cache = prefill(params, {"tokens": fed}, seq_cap=CAP)
    for t in range(STEPS):
        ids = logits.argmax(dim=-1)[:, None].to(torch.int32)
        logits, cache = decode(params, cache, ids, S + t)
        fed = np.concatenate([fed, ids.numpy()], axis=1)
        if t in (0, STEPS - 1):
            again, again_cache = prefill(params, {"tokens": fed}, seq_cap=CAP)
            assert (err := rel_err(logits, again)) <= PREFILL_REL, f"decode step {t} against prefill {err:.3g}"
            errs = _cache_errors(cache, jax.tree.map(torch.Tensor.numpy, again_cache))
            assert max(errs.values()) <= PREFILL_REL, f"decode step {t} against prefill: {errs}"
