"""The port at the reference's long shapes, cut to the CPU's size.

The reference's ``SHAPES`` (``configs/base.py``) hold two long serving
shapes that the serving tests never reach: ``prefill_32k``/``decode_32k``
(prompts past ``_sdpa``'s 2,048-key threshold, where the reference leaves
its plain softmax for ``_chunked_attention``'s online softmax over 1,024-key
blocks) and ``long_500k`` (an SSD state carried over thousands of chunks).
Here they run at smoke width in f32 with their sequence lengths cut, the
steps built by the port's ``build_step`` from those shapes:

  - qwen3-smoke, 2 rows of 4,096 tokens: the port's prefill (the kernel's
    plain version, 32 key tiles of 128) against the reference's prefill
    (its chunked attention, 4 x 4 blocks of 1,024), logits and the k/v
    cache within 2e-5 of the largest reference value; then 8 greedy decode
    steps into a cache of 4,160 slots against the reference's decode
    (1e-4), and each against the port's own prefill of the prompt and the
    tokens decoded so far (a prompt of 4,097 is padded to 4,160 for the
    kernel);
  - mamba2-smoke (chunk 16), one row of 2,048 tokens (128 chunks): the
    port's prefill against the reference's, logits and every layer's state
    and conv window; and the port's prefill of 2,048 against its prefill of
    2,040 (chunk 8, the chunk the reference picks there) followed by 8
    decode steps.

At these lengths RoPE's angle ``position * freq`` shows an ulp of its
frequency: the port's frequencies must be the reference's compiled ones
bit for bit (``test_rope_freqs_round_as_the_reference``).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro_torch import configs as port_configs  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ssd_scan as ks  # noqa: E402
from repro_torch.models.layers import rope_freqs  # noqa: E402
from repro_torch.models.ssm import scan_chunk  # noqa: E402
from torch_parity import long_steps, reference_stack, rel_err, smoke_pair  # noqa: E402,F401

B, S, STEPS = 2, 4096, 8  # qwen3: past the reference's 2,048-key threshold
CAP = S + 64  # decode_32k's cache: 64 slots past the prompt
L, TAIL = 2048, 8  # mamba2: 128 chunks of 16; the tail's 2,040 scan in chunks of 8
PREFILL_REL = 2e-5  # f32: of the largest reference value
DECODE_REL = 1e-4


ROPE_ARCHS = [a for a in port_configs.all_archs() if port_configs.get_config(a).family != "ssm"]


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ROPE_ARCHS)
def test_rope_freqs_round_as_the_reference(reference_stack, arch, smoke):  # noqa: F811
    """The frequencies of every config's rotary dims (MLA's rope dims) and
    theta, equal to those the reference's step computes under ``jax.jit``.
    Torch's f32 power left about a third of them an ulp off, which at
    position 4,095 put qwen3-smoke's k 2.5e-5 of its largest value from the
    reference's."""
    from repro.models.layers import rope_freqs as ref_rope_freqs

    cfg = (port_configs.get_smoke_config if smoke else port_configs.get_config)(arch)
    dim = cfg.mla.qk_rope_head_dim if cfg.mla is not None else cfg.resolved_head_dim
    want = np.asarray(jax.jit(ref_rope_freqs, static_argnums=(0, 1))(dim, cfg.rope_theta))
    got = rope_freqs(dim, cfg.rope_theta).numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def _qwen3_prefill(ref):
    ref_model, ref_params, cfg, params = smoke_pair(ref, "qwen3-0.6b")
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S), dtype=np.int32)
    launches = fa.flash_attention.launches
    prefill, decode = long_steps(cfg, "decode_32k", CAP, B)
    logits, cache = prefill(params, {"tokens": tokens}, seq_cap=CAP)
    assert fa.flash_attention.launches == launches  # CPU tensors: the plain version
    # JAX dispatches asynchronously: the reference's prefill ends here, so the
    # port's prefills that follow run alone on the CPU, as the first one did
    want_logits, want_cache = jax.block_until_ready(ref_model.prefill(ref_params, {"tokens": jnp.asarray(tokens)}))
    return ref_model, ref_params, cfg, params, tokens, (prefill, decode), (logits, cache), (want_logits, want_cache)


def test_qwen3_prefill_past_the_chunked_attention_threshold(reference_stack):  # noqa: F811
    """2 x 4,096 tokens through the ``prefill_32k`` step: logits and every
    layer's k and v within 2e-5 of the largest reference value; the
    cache's slots past the prompt untouched.  The same prompt through
    ``decode_32k``'s prefill, into a cache of 4,160 slots, gives the same
    logits and k and v bit for bit: the capacity only sizes the cache."""
    _, _, cfg, params, tokens, _, got, want = _qwen3_prefill(reference_stack)
    prefill, _ = long_steps(cfg, "prefill_32k", S, B)
    logits, cache = prefill(params, {"tokens": tokens})
    assert tuple(cache[0]["blocks"][0]["k"].shape)[2] == S  # capacity: the prompt
    torch.testing.assert_close(logits, got[0], rtol=0, atol=0)  # the same step, capacity aside
    for seg, wide_seg in zip(cache, got[1]):
        for blk, wide in zip(seg["blocks"], wide_seg["blocks"]):
            for name in blk:
                torch.testing.assert_close(blk[name], wide[name][:, :, :S], rtol=0, atol=0, msg=name)
    assert (err := rel_err(logits, want[0])) <= PREFILL_REL, f"prefill logits {err:.3g}"
    for seg, want_seg in zip(got[1], want[1]):
        for blk, want_blk in zip(seg["blocks"], want_seg["blocks"]):
            assert blk.keys() == want_blk.keys() == {"k", "v"}
            for name in blk:
                assert not blk[name][:, :, S:].any(), name
                assert (err := rel_err(blk[name][:, :, :S], want_blk[name])) <= PREFILL_REL, f"cache {name} {err:.3g}"


def test_qwen3_decode_after_a_long_prompt(reference_stack):  # noqa: F811
    """8 greedy decode steps after the 4,096-token prompt, in a cache of
    4,160 slots (the ``decode_32k`` step): each step's logits against the
    reference's decode on its cache grown to 4,160 (1e-4 of the largest
    value), and against the port's own prefill of the prompt and the ids
    fed so far, whose last logits it must repeat (2e-5)."""
    ref_model, ref_params, cfg, params, tokens, (prefill, decode), got, want = _qwen3_prefill(reference_stack)
    logits, cache = got
    want_logits, want_cache = want
    want_cache = [
        {"blocks": [{n: jnp.pad(x, [(0, 0), (0, 0), (0, CAP - S), (0, 0), (0, 0)]) for n, x in blk.items()}
                    for blk in seg["blocks"]]}
        for seg in want_cache
    ]
    ref_decode = ref_model.decode_step
    fed = tokens
    for t in range(STEPS):
        ids = logits.argmax(dim=-1)[:, None].to(torch.int32)
        want_ids = jnp.argmax(want_logits, axis=-1)[:, None].astype(jnp.int32)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids), err_msg=f"step {t} ids")
        logits, cache = decode(params, cache, ids, S + t)
        want_logits, want_cache = ref_decode(ref_params, want_cache, want_ids, jnp.int32(S + t))
        assert (err := rel_err(logits, want_logits)) <= DECODE_REL, f"decode step {t} {err:.3g}"
        fed = np.concatenate([fed, ids.numpy()], axis=1)
        if t in (0, STEPS - 1):  # S + 1 tokens, padded to 4,160 for the kernel; and S + 8
            again, _ = prefill(params, {"tokens": fed}, seq_cap=CAP)
            assert (err := rel_err(logits, again)) <= PREFILL_REL, f"decode step {t} against prefill {err:.3g}"


def _mamba2(ref):
    ref_model, ref_params, cfg, params = smoke_pair(ref, "mamba2-780m")
    assert (scan_chunk(cfg, L), scan_chunk(cfg, L - TAIL)) == (16, 8)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (1, L), dtype=np.int32)
    prefill, decode = long_steps(cfg, "long_500k", L, 1)
    return ref_model, ref_params, cfg, params, tokens, prefill, decode


def test_mamba2_prefill_over_128_chunks(reference_stack):  # noqa: F811
    """One row of 2,048 tokens (the ``long_500k`` step's shape, cut), 128
    chunks of 16: logits, and every layer's state and conv window, within
    2e-5 of the largest reference value."""
    ref_model, ref_params, cfg, params, tokens, prefill, _ = _mamba2(reference_stack)
    launches = ks.ssd_scan.launches
    logits, cache = prefill(params, {"tokens": tokens})
    assert ks.ssd_scan.launches == launches
    want_logits, want_cache = ref_model.prefill(ref_params, {"tokens": jnp.asarray(tokens)})
    assert (err := rel_err(logits, want_logits)) <= PREFILL_REL, f"prefill logits {err:.3g}"
    blk, want_blk = cache[0]["blocks"][0], want_cache[0]["blocks"][0]
    assert blk.keys() == want_blk.keys() == {"ssm", "conv"}
    for name in blk:
        for layer in range(cfg.num_layers):
            err = rel_err(blk[name][layer], want_blk[name][layer])
            assert err <= PREFILL_REL, f"layer {layer} {name} {err:.3g}"


def test_mamba2_state_carried_by_decode_steps(reference_stack):  # noqa: F811
    """The prefill of 2,048 tokens (chunk 16) against the prefill of the
    first 2,040 (chunk 8) followed by 8 decode steps on the last 8: the
    last logits and every layer's state and conv window within 2e-5 of the
    largest value."""
    _, _, cfg, params, tokens, prefill, decode = _mamba2(reference_stack)
    want_logits, want_cache = prefill(params, {"tokens": tokens})
    logits, cache = prefill(params, {"tokens": tokens[:, :L - TAIL]})
    for t in range(L - TAIL, L):
        logits, cache = decode(params, cache, tokens[:, t:t + 1], t)
    assert (err := rel_err(logits, want_logits)) <= PREFILL_REL, f"logits {err:.3g}"
    blk, want_blk = cache[0]["blocks"][0], want_cache[0]["blocks"][0]
    for name in blk:
        for layer in range(cfg.num_layers):
            err = rel_err(blk[name][layer], want_blk[name][layer])
            assert err <= PREFILL_REL, f"layer {layer} {name} {err:.3g}"
