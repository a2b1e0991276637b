"""The prefill in token windows held to the reference, at the CPU's size.

A prompt longer than ``Model.prefill``'s ``window`` runs layer by layer,
each per-token op one window at a time: attention takes a window's queries
against the cache's slots up to its last (K3 right-aligned, ``sq < skv``),
the SSD block carries its conv window and its scan's state from the window
before (``ssd_scan(..., h0=...)``), and the MoE routes over the whole
prompt before it runs its experts window by window.  The reference has no
windows: its ``Model.prefill`` runs the whole prompt at once, and so these
tests hold the port's windowed prefill to it, on the smoke configs in f32
with the port's seed-0 weights carried across to the reference (its own
init's compile would take most of the file's time) and seeded numpy
prompts:

  - ``ssd_scan_plain`` from an initial state against the reference's
    ``ssd_chunked(..., h0=...)``, and a scan split in two (the first
    half's state the second's h0) against the whole;
  - jamba-, mamba2-, qwen3- and deepseek-v3-smoke (S of 128-256, windows
    of 32-64, jamba's and mamba2's prompt of 200 not a multiple of their
    scan chunk 16: its last 8 tokens take a window of their own): the
    last logits and every layer's cache entry within 2e-5 of the largest
    reference value, the reference's expert choices replayed and the
    port's own equal to them;
  - jamba-smoke's MoE at capacity factor 0.5, where each expert drops
    pairs over the whole prompt: the windowed prefill drops the
    reference's pairs (any other drop would move a token's FFN output by
    about half of it);
  - the decode step after a windowed prefill of 200 tokens against the
    reference's prefill of 201 (at the capacity factor that drops no
    pair): logits and the cache within 1e-4.
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
from repro_torch.models import Model, tree_to_numpy  # noqa: E402
from repro_torch.models.model import PREFILL_WINDOW, prefill_windows  # noqa: E402
from torch_parity import odd_positions, reference_routes, reference_stack, rel_err  # noqa: E402,F401

import route_check  # noqa: E402  (tools/, put on the path by torch_parity)

PREFILL_REL = 2e-5  # f32: of the largest reference value
DECODE_REL = 1e-4
JAMBA = "jamba-1.5-large-398b"
TOKENS = ("k", "v", "ckv", "k_rope")  # cache entries of (n, B, slots, ...)


def _cache_errors(got, want) -> dict:
    """Each cache entry's largest difference over its largest |want| value,
    the worst layer's; token entries over the slots ``want`` holds."""
    worst: dict[str, float] = {}
    for seg, want_seg in zip(got, want):
        for blk, want_blk in zip(seg["blocks"], want_seg["blocks"]):
            assert blk.keys() == want_blk.keys()
            for name, w in want_blk.items():
                g = blk[name][:, :, :w.shape[2]] if name in TOKENS else blk[name]
                for layer in range(w.shape[0]):
                    worst[name] = max(worst.get(name, 0.0), rel_err(g[layer], np.asarray(w[layer])))
    return worst


def _pair(ref, arch: str, capacity_factor=None):
    """``arch``'s smoke config in f32 in both packages (MoE at
    ``capacity_factor``, where given) and the port's seed-0 weights as the
    port's CPU tensors and the reference's arrays: (reference model, its
    params, the port's config, the port's params)."""
    configs = []
    for c in (ref.get_smoke_config(arch), port_configs.get_smoke_config(arch)):
        c = dataclasses.replace(c, dtype="float32")
        if capacity_factor is not None:
            c = dataclasses.replace(c, moe=dataclasses.replace(c.moe, capacity_factor=capacity_factor))
        configs.append(c)
    ref_cfg, cfg = configs
    params = Model(cfg).init(seed=0, device="cpu")
    return ref.Model(ref_cfg), jax.tree.map(jnp.asarray, tree_to_numpy(params)), cfg, params


def _window_odd_positions(s: int, window: int) -> np.ndarray:
    """(3, s) int32: ``odd_positions`` (restarting, repeated, reversed)
    within each window of ``window`` tokens, each window's above the ones
    before it, as a prefill in token windows takes them."""
    rows = [odd_positions(t1 - t0) + 1000 * i for i, t0 in enumerate(range(0, s, window))
            for t1 in [min(t0 + window, s)]]
    return np.concatenate(rows, axis=1).astype(np.int32)


def _windowed_against_whole(ref, monkeypatch, arch: str, s: int, window: int, capacity_factor=None,
                            positions: bool = False):
    """``arch``'s smoke config (at ``capacity_factor``, where given): the
    reference's whole prefill of 2 seeded prompts of ``s`` tokens (with
    ``positions``, 3 at ``_window_odd_positions``), then the port's in
    windows of ``window``, replaying the reference's expert choices.
    Returns (logits error, cache errors, the port's own choices that
    differ, the reference's route records, the port's config)."""
    ref_model, ref_params, cfg, params = _pair(ref, arch, capacity_factor)
    assert len(prefill_windows(cfg, s, window)) > 1
    pos = {"positions": _window_odd_positions(s, window)} if positions else {}
    tokens = np.random.default_rng(7).integers(0, cfg.vocab_size, (3 if positions else 2, s), dtype=np.int32)
    with reference_routes(monkeypatch) as want_routes:
        want_logits, want_cache = jax.tree.map(np.asarray, ref_model.prefill(
            ref_params, {"tokens": jnp.asarray(tokens), **{k: jnp.asarray(v) for k, v in pos.items()}}))
    launches = fa.flash_attention.launches, ks.ssd_scan.launches
    with route_check.RouteRecorder(replay=want_routes.idx if cfg.moe else None) as got_routes:
        logits, cache = Model(cfg).prefill(
            params, {"tokens": torch.from_numpy(tokens), **{k: torch.from_numpy(v) for k, v in pos.items()}},
            window=window)
    assert (fa.flash_attention.launches, ks.ssd_scan.launches) == launches  # CPU tensors: the plain versions
    diffs = route_check.compare(cfg, want_routes.probs, got_routes.probs) if cfg.moe else []
    return rel_err(logits, want_logits), _cache_errors(cache, want_cache), diffs, want_routes, cfg


# ---------------------------------------------------------------------------
# K4 from an initial state
# ---------------------------------------------------------------------------


def _scan_inputs(b, l, h, p, g, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, l, h)))).astype(np.float32)
    a = -np.exp(rng.standard_normal(h) * 0.5).astype(np.float32)
    bm, cm = (rng.standard_normal((b, l, g, n)).astype(np.float32) * 0.3 for _ in range(2))
    h0 = rng.standard_normal((b, h, p, n)).astype(np.float32)
    return x, dt, a, bm, cm, h0


@pytest.mark.parametrize("b,l,h,p,g,n,chunk", [(2, 128, 4, 16, 2, 16, 32), (1, 96, 6, 32, 3, 32, 48)])
def test_plain_scan_from_h0_matches_the_chunked_reference(reference_stack, b, l, h, p, g, n, chunk):  # noqa: F811
    """y and the final state from a drawn h0, f32, within 2e-5 of the
    largest reference value."""
    from repro.models.ssm import ssd_chunked

    *arrays, h0 = _scan_inputs(b, l, h, p, g, n, seed=3)
    want_y, want_h = ssd_chunked(*map(jnp.asarray, arrays), h0=jnp.asarray(h0), chunk=chunk)
    y, h_final = ks.ssd_scan(*map(torch.from_numpy, arrays), chunk=chunk, h0=torch.from_numpy(h0))
    assert rel_err(y, want_y) <= PREFILL_REL and rel_err(h_final, want_h) <= PREFILL_REL
    y0, _ = ks.ssd_scan(*map(torch.from_numpy, arrays), chunk=chunk)
    assert rel_err(y0, want_y) > 1e-3  # h0 reaches y


def test_a_scan_split_in_two_carries_its_state():
    """The first half's h_final as the second half's h0: both halves' y and
    the final state equal the whole scan's (f32, 2e-5); h0 of another shape
    or dtype raises."""
    *arrays, _ = _scan_inputs(2, 192, 4, 16, 2, 16, seed=4)
    x, dt, a, bm, cm = map(torch.from_numpy, arrays)
    want_y, want_h = ks.ssd_scan(x, dt, a, bm, cm, chunk=32)
    y1, h1 = ks.ssd_scan(x[:, :96], dt[:, :96], a, bm[:, :96], cm[:, :96], chunk=32)
    y2, h2 = ks.ssd_scan(x[:, 96:], dt[:, 96:], a, bm[:, 96:], cm[:, 96:], chunk=48, h0=h1)
    assert rel_err(torch.cat([y1, y2], dim=1), want_y) <= PREFILL_REL and rel_err(h2, want_h) <= PREFILL_REL
    with pytest.raises(ValueError, match="h0 must be"):
        ks.ssd_scan(x, dt, a, bm, cm, chunk=32, h0=h1[:, :2])
    with pytest.raises(ValueError, match="h0 must be"):
        ks.ssd_scan(x, dt, a, bm, cm, chunk=32, h0=h1.double())


# ---------------------------------------------------------------------------
# the windows
# ---------------------------------------------------------------------------


def test_windows_sit_at_multiples_of_the_scan_chunk(reference_stack):  # noqa: F811
    """Up to one window the prompt runs whole; past it, SSD configs cut at
    multiples of their chunk and give the prompt's last ``S mod chunk``
    tokens a window of their own; attention-only configs cut anywhere."""
    from repro_torch.configs import get_config, get_smoke_config

    jamba, qwen3 = get_config(JAMBA), get_smoke_config("qwen3-0.6b")
    assert prefill_windows(jamba, PREFILL_WINDOW) == [(0, PREFILL_WINDOW)]
    w = prefill_windows(jamba, 524_272)
    assert len(w) == 17 and w[-2:] == [(491_520, 524_032), (524_032, 524_272)]
    assert all(t1 - t0 == PREFILL_WINDOW for t0, t1 in w[:15])
    assert prefill_windows(jamba, 2 * PREFILL_WINDOW) == [(0, PREFILL_WINDOW), (PREFILL_WINDOW, 2 * PREFILL_WINDOW)]
    assert prefill_windows(qwen3, 100, 32) == [(0, 32), (32, 64), (64, 96), (96, 100)]
    with pytest.raises(ValueError, match="multiple of the scan chunk"):
        prefill_windows(jamba, 524_272, 1000)


@pytest.mark.parametrize("arch,s,window,positions", [
    (JAMBA, 200, 32, False),  # 6 windows of 32 and one of 8: attention, SSD + MoE and SSD layers
    ("mamba2-780m", 200, 64, False),
    ("qwen3-0.6b", 256, 64, False),
    ("qwen3-0.6b", 96, 40, True),  # K3's position route: a window's positions against the prefix's, q 24 rows ahead
    ("deepseek-v3-671b", 128, 48, False),  # MLA: windows of 48, 48 and 32; then a MoE layer
])
def test_windowed_prefill_matches_the_reference(reference_stack, monkeypatch, arch, s, window, positions):  # noqa: F811
    """The port's prefill in windows against the reference's whole prefill:
    the last logits and every layer's cache entry (k, v; ssm, conv; ckv,
    k_rope) within 2e-5 of the largest reference value, the port's own
    expert choices equal to the reference's; with ``positions``, prompts
    whose positions restart, repeat or run backwards within each window
    and rise from one window to the next, which RoPE rotates by and K3
    masks by."""
    err, errs, diffs, _, _ = _windowed_against_whole(reference_stack, monkeypatch, arch, s, window,
                                                     positions=positions)
    assert err <= PREFILL_REL, f"prefill logits {err:.3g}"
    assert errs and max(errs.values()) <= PREFILL_REL, errs
    assert diffs == [], route_check.summary(diffs, 0)


def test_windowed_moe_drops_the_references_pairs(reference_stack, monkeypatch):  # noqa: F811
    """jamba-smoke at capacity factor 0.5: each expert keeps the first
    ``capacity_per_seq`` of its pairs over the whole prompt of 256 tokens,
    and the windowed prefill (windows of 32) holds the reference within
    2e-5, which it does only where it keeps and drops the same pairs."""
    from repro_torch.models.moe import capacity_per_seq

    err, errs, diffs, want_routes, cfg = _windowed_against_whole(
        reference_stack, monkeypatch, JAMBA, 256, 32, capacity_factor=0.5)
    k, cap = cfg.moe.experts_per_token, capacity_per_seq(cfg, 256)
    kept = [route_check.kept_experts(p, k, cap).sum() for p in want_routes.probs]
    assert all(n < 2 * 256 * k for n in kept), kept  # pairs dropped in every MoE layer
    assert err <= PREFILL_REL, f"prefill logits {err:.3g}"
    assert max(errs.values()) <= PREFILL_REL, errs
    assert diffs == [], route_check.summary(diffs, 0)


def test_decode_after_a_windowed_prefill_repeats_the_longer_prefill(reference_stack, monkeypatch):  # noqa: F811
    """jamba-smoke at capacity factor experts / top-k (no pair dropped, so
    a prefill of S+1 is the function of a prefill of S and a step): the
    greedy decode step after the port's windowed prefill of 200 tokens
    (windows of 32, its last 8 tokens in a window of their own) into a
    cache of 208 slots, against the reference's prefill of those 200 and
    the step's id; logits and the cache (k/v over the 201 slots, ssm,
    conv) within 1e-4 of the largest reference value, replaying the
    reference's expert choices (the prefill's for the prompt, then the
    step's token)."""
    moe = port_configs.get_smoke_config(JAMBA).moe
    ref_model, ref_params, cfg, params = _pair(reference_stack, JAMBA, moe.n_experts / moe.experts_per_token)
    s, window = 200, 32
    tokens = np.random.default_rng(8).integers(0, cfg.vocab_size, (2, s), dtype=np.int32)
    model = Model(cfg)
    logits, cache = model.prefill(params, {"tokens": torch.from_numpy(tokens)}, seq_cap=s + 8, window=window)
    ids = logits.argmax(dim=-1)[:, None].to(torch.int32)
    longer = np.concatenate([tokens, ids.numpy()], axis=1)
    with reference_routes(monkeypatch) as want_routes:
        want_logits, want_cache = jax.tree.map(np.asarray, ref_model.prefill(ref_params, {"tokens": jnp.asarray(longer)}))
    replay = [idx[:, :s] for idx in want_routes.idx] + [idx[:, s:] for idx in want_routes.idx]
    with route_check.RouteRecorder(replay=replay):
        logits, cache = model.prefill(params, {"tokens": torch.from_numpy(tokens)}, seq_cap=s + 8, window=window)
        step_logits, cache = model.decode_step(params, cache, ids, s)
    assert (err := rel_err(step_logits, want_logits)) <= DECODE_REL, f"decode logits {err:.3g}"
    errs = _cache_errors(cache, want_cache)
    assert errs.keys() == {"k", "v", "ssm", "conv"} and max(errs.values()) <= DECODE_REL, errs


def test_positions_that_cross_a_window_boundary_raise():
    """In token windows a query sees the keys up to its window's last token
    only, so positions that let it see a later one (two packed prompts
    restarting at token 32, or reversed) raise, and the same prompt
    prefilled whole is served; positions repeated in pairs (0, 0, 1, 1,
    ...) cross no boundary of 32 and give the whole prefill's logits."""
    cfg = dataclasses.replace(port_configs.get_smoke_config("qwen3-0.6b"), dtype="float32")
    model = Model(cfg)
    params = model.init(seed=0, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(9).integers(0, cfg.vocab_size, (1, 64)))
    restart, pairs, reverse = (torch.from_numpy(row)[None] for row in odd_positions(64))
    for positions in (restart, reverse):
        with pytest.raises(ValueError, match="increase across windows"):
            model.prefill(params, {"tokens": tokens, "positions": positions}, window=32)
        model.prefill(params, {"tokens": tokens, "positions": positions}, window=64)
    windowed, _ = model.prefill(params, {"tokens": tokens, "positions": pairs}, window=32)
    whole, _ = model.prefill(params, {"tokens": tokens, "positions": pairs})
    assert rel_err(windowed, whole.numpy()) <= PREFILL_REL
