"""Comparing the expert routes of two runs of one MoE model.

Routing is discrete.  Where two runs compute a layer's input with other
rounding (bf16 on the card against the CPU, or the port against the
reference), a token whose k-th and (k+1)-th expert probabilities lie
closer than that rounding may take another expert in one run (a *swap*).
A swap also moves the pairs that follow it in its sequence's expert order,
so another token's pair may be kept by an expert in one run and dropped at
its capacity in the other (a *drop shift*).  Either changes that token's
FFN output by about 1/k of it, and attention and the SSD scan carry the
change into other tokens and later layers, where a whole-tensor bar sees
it although both runs are right.

So a check runs the run held as right first, recording each MoE layer's
router probabilities and expert choices in call order (``RouteRecorder``),
then the other run replaying those choices (``RouteRecorder(replay=...)``):
each layer still computes its own probabilities, and its gates are its own
probabilities at the replayed experts, renormalised as ``moe.route_logits`` does;
only the discrete choice is taken over.  Every output is then held to its
bar, and ``compare`` lists the (token, layer) pairs whose own choice
differed, with the first run's probability gap, for the check to bound.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import moe


class RouteRecorder:
    """``with RouteRecorder() as rec:`` records, for each ``moe.route_logits``
    call the port makes (one a MoE layer's pass: ``moe.route`` calls it, and
    so does a prefill in token windows on the whole prompt's logits), its
    (B, S, E) f32 probabilities into ``rec.probs`` and
    its own (B, S, k) experts into ``rec.idx``.  With ``replay`` (another
    run's ``idx``, one array a call in the same order) each call takes
    those experts instead of its own top-k.  Reading the records copies to
    the host: a check's tool, not the serving path."""

    def __init__(self, replay: list | None = None):
        self.probs: list[np.ndarray] = []
        self.idx: list[np.ndarray] = []
        self.replay = replay
        self._real = None

    def __enter__(self) -> "RouteRecorder":
        real = self._real = moe.route_logits

        def route_logits(cfg, logits):
            probs, gate, idx = real(cfg, logits)
            self.probs.append(probs.detach().float().cpu().numpy())
            self.idx.append(idx.detach().cpu().numpy())
            if self.replay is not None:
                idx = torch.as_tensor(self.replay[len(self.idx) - 1], device=idx.device)
                gate = probs.gather(-1, idx)
                gate = gate / gate.sum(dim=-1, keepdim=True).clamp_min(1e-9)
            return probs, gate, idx

        moe.route_logits = route_logits
        return self

    def __exit__(self, *exc) -> None:
        moe.route_logits = self._real


def kept_experts(probs: np.ndarray, k: int, cap: int) -> np.ndarray:
    """(B, S, E) bool: the experts that keep one of each token's top-k
    pairs, by ``apply_moe``'s rule (pairs in token order, then in order of
    probability; an expert keeps its first ``cap``)."""
    b, s, e = probs.shape
    idx = np.argsort(-probs, axis=-1, kind="stable")[..., :k].reshape(b, s * k)
    onehot = idx[..., None] == np.arange(e)
    rank = np.take_along_axis(np.cumsum(onehot, axis=1), idx[..., None], axis=2)[..., 0] - 1
    out = np.zeros((b, s, e), bool)
    rows, pairs = np.nonzero(rank < cap)
    out[rows, pairs // k, idx[rows, pairs]] = True
    return out


@dataclasses.dataclass(frozen=True)
class Difference:
    call: int  # the pass over the stack: 0 the prefill, t + 1 decode step t
    layer: int  # the MoE layer's index in the stack
    row: int
    token: int  # within the call
    kind: str  # "swap": the top-k sets differ; "drop": they agree, the kept experts do not
    gap: float  # want's k-th minus (k+1)-th probability of that token


def differences(cfg: ModelConfig, want: np.ndarray, got: np.ndarray, call: int = 0,
                layer: int = 0) -> list[Difference]:
    """The tokens of one MoE layer's call whose kept experts differ between
    two runs' probabilities (B, S, E), ``want`` the run held as right."""
    k = cfg.moe.experts_per_token
    cap = moe.capacity_per_seq(cfg, want.shape[1])
    top_w = np.sort(np.argsort(-want, axis=-1, kind="stable")[..., :k], axis=-1)
    top_g = np.sort(np.argsort(-got, axis=-1, kind="stable")[..., :k], axis=-1)
    swapped = (top_w != top_g).any(axis=-1)
    shifted = (kept_experts(want, k, cap) != kept_experts(got, k, cap)).any(axis=-1) & ~swapped
    srt = -np.sort(-want, axis=-1)
    gap = srt[..., k - 1] - srt[..., k] if want.shape[-1] > k else np.full(want.shape[:2], np.inf)
    return [Difference(call, layer, int(row), int(tok), "swap" if swapped[row, tok] else "drop",
                       float(gap[row, tok]))
            for row, tok in zip(*np.nonzero(swapped | shifted))]


def compare(cfg: ModelConfig, want: list, got: list) -> list[Difference]:
    """Every differing (token, layer) of two runs' recorded probabilities,
    one array per MoE layer a pass over the stack, in call order (``want``
    the run held as right)."""
    moe_layers = [i for i, (_, is_moe) in enumerate(cfg.layer_plan()) if is_moe]
    if len(want) != len(got) or len(want) % len(moe_layers):
        raise ValueError(f"{len(want)} and {len(got)} records for {len(moe_layers)} MoE layers a pass")
    out = []
    for i, (pw, pg) in enumerate(zip(want, got)):
        call, j = divmod(i, len(moe_layers))
        out += differences(cfg, pw, pg, call, moe_layers[j])
    return out


def summary(diffs: list[Difference], pairs: int) -> dict:
    """The differences as a check prints them, beside the pairs compared."""
    return {"pairs_compared": pairs, "swaps": sum(d.kind == "swap" for d in diffs),
            "drop_shifts": sum(d.kind == "drop" for d in diffs),
            "max_swap_gap": max((d.gap for d in diffs if d.kind == "swap"), default=0.0),
            "differences": [dataclasses.asdict(d) for d in diffs]}
