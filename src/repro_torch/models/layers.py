"""Shared neural layers: norms, FFN, RoPE, embeddings, the head and the loss.

Activations stay in the model's dtype (bf16 at full size) with f32
reductions in the norms and RoPE, as in the reference.  Parameters are
declared as ``ParamDef`` trees; apply functions are plain functions of
tensors.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from .params import ParamDef

# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def norm_defs(cfg: ModelConfig) -> dict:
    if cfg.norm == "nonparam_ln":  # OLMo: no learnable affine
        return {}
    if cfg.norm == "layernorm":
        return {
            "scale": ParamDef((cfg.d_model,), (None,), torch.float32, "ones"),
            "bias": ParamDef((cfg.d_model,), (None,), torch.float32, "zeros"),
        }
    return {"scale": ParamDef((cfg.d_model,), (None,), torch.float32, "ones")}


def apply_norm(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    if cfg.norm in ("layernorm", "nonparam_ln"):
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + 1e-5)
        if cfg.norm == "layernorm":
            y = y * p["scale"] + p["bias"]
    else:  # rmsnorm
        y = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + 1e-6)
        y = y * p["scale"]
    return y.to(x.dtype)


def rms_norm_simple(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (y * scale).to(x.dtype)


# ---------------------------------------------------------------------------
# dense FFN
# ---------------------------------------------------------------------------


def ffn_defs(cfg: ModelConfig, d_ff: int | None = None) -> dict:
    d, f, dt = cfg.d_model, d_ff or cfg.d_ff, dtype_of(cfg)
    if cfg.act == "swiglu":
        return {
            "w_gate": ParamDef((d, f), ("embed", "ffn"), dt),
            "w_up": ParamDef((d, f), ("embed", "ffn"), dt),
            "w_down": ParamDef((f, d), ("ffn", "embed"), dt),
        }
    return {
        "w_up": ParamDef((d, f), ("embed", "ffn"), dt),
        "w_down": ParamDef((f, d), ("ffn", "embed"), dt),
    }


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` as the reference computes it: x * 1 / (1 + exp(-x)),
    each op rounded to x's dtype.  ``F.silu`` rounds once, which in bf16
    moves a third of the values by an ulp; the SSD scan carries that into
    its state, and the FFN's weight gradients move by it."""
    return x * (1 / (1 + torch.exp(-x)))


def apply_ffn(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    if cfg.act == "swiglu":
        h = silu(x @ p["w_gate"]) * (x @ p["w_up"])
    else:
        h = F.gelu(x @ p["w_up"], approximate="tanh")  # jax.nn.gelu's default
    return h @ p["w_down"]


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """``1 / theta ** (arange(0, hd, 2) / hd)`` in f32, the exponent rounded
    to f32 as in the reference and the power and reciprocal taken in f64,
    then rounded once: the value the reference's compiled step computes.
    Torch's f32 power leaves a third of the frequencies an ulp off, and an
    angle ``position * freq`` drifts from the reference's in proportion to
    the position (k of a 4,096-token prompt 2.5e-5 of its largest value)."""
    e = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return (1.0 / theta ** e.double()).float()


@functools.lru_cache(maxsize=None)
def _rope_freqs_on(head_dim: int, theta: float, device: torch.device) -> torch.Tensor:
    """``rope_freqs`` made once per (head_dim, theta, device), not on every
    layer's q and k of every step; a normal tensor even when first asked
    for under ``torch.inference_mode``."""
    with torch.inference_mode(False):
        return rope_freqs(head_dim, theta, device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S).  The two
    rotated halves are split, not interleaved pairs; computed in f32."""
    hd = x.shape[-1]
    freqs = _rope_freqs_on(hd, theta, x.device)  # (hd/2,)
    angles = positions[..., :, None, None].float() * freqs  # (..., S, 1, hd/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# embeddings / head
# ---------------------------------------------------------------------------


def embed_defs(cfg: ModelConfig) -> dict:
    return {
        "tok": ParamDef(
            (cfg.n_codebooks, cfg.padded_vocab, cfg.d_model),
            (None, "vocab_in", "embed"),
            dtype_of(cfg),
            "embed_normal",
        )
    }


def apply_embed(cfg: ModelConfig, p: dict, tokens: torch.Tensor) -> torch.Tensor:
    """tokens: (B, S) integer ids (or (B, S, 1)) → (B, S, D).  A
    multi-codebook config (MusicGen) takes (B, S, n_codebooks) and sums the
    per-codebook lookups in codebook order, one add at a time in the
    table's dtype, as the reference's ``sum`` does."""
    if cfg.n_codebooks == 1:
        if tokens.dim() == 3:
            tokens = tokens[..., 0]
        return p["tok"][0][tokens]
    if tokens.dim() != 3 or tokens.shape[-1] != cfg.n_codebooks:
        raise ValueError(
            f"{cfg.name}: tokens must be (B, S, {cfg.n_codebooks}), one id a codebook; got {tuple(tokens.shape)}"
        )
    x = p["tok"][0][tokens[..., 0]]
    for q in range(1, cfg.n_codebooks):
        x = x + p["tok"][q][tokens[..., q]]
    return x


def head_defs(cfg: ModelConfig) -> dict:
    if cfg.tie_embeddings:
        return {}
    return {
        "w": ParamDef(
            (cfg.d_model, cfg.n_codebooks * cfg.padded_vocab),
            ("embed", "vocab"),
            dtype_of(cfg),
        )
    }


def apply_head(cfg: ModelConfig, head_p: dict, embed_p: dict, x: torch.Tensor) -> torch.Tensor:
    """Returns logits (B, S, n_codebooks*padded_vocab).  Padded columns must
    be masked by the caller (``mask_padded_vocab``)."""
    if cfg.tie_embeddings:
        w = embed_p["tok"].reshape(cfg.n_codebooks * cfg.padded_vocab, cfg.d_model).T
        return x @ w
    return x @ head_p["w"]


def mask_padded_vocab(cfg: ModelConfig, logits: torch.Tensor) -> torch.Tensor:
    """logits (..., padded_vocab): the padding columns take the finite
    -2**30 so they never win the softmax or the argmax.  The fill is a
    Python number: a tensor made from one on the card is a copy from host
    memory, which waits for every launch queued before it."""
    if cfg.padded_vocab == cfg.vocab_size:
        return logits
    pad = torch.arange(logits.shape[-1], device=logits.device) >= cfg.vocab_size
    return logits.masked_fill(pad, -(2.0**30))


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean CE over masked positions, in f32.  logits (..., V), labels
    integer (negative at masked positions), mask float (0/1)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    safe = labels.clamp(min=0).long()
    ll = torch.take_along_dim(logits, safe[..., None], dim=-1)[..., 0]
    nll = (lse - ll) * mask
    return nll.sum() / mask.sum().clamp(min=1.0)


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
