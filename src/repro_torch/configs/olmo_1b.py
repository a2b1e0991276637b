"""olmo-1b [dense] — non-parametric LN [arXiv:2402.00838].

16L, d_model=2048, 16H (MHA kv=16), d_ff=8192, vocab=50304.
OLMo uses non-parametric LayerNorm (no affine) and SwiGLU.
"""

import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b",
    family="dense",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=8192,
    vocab_size=50304,
    pattern=("attn",),
    norm="nonparam_ln",
    tie_embeddings=True,
    grad_accum={"train_4k": 4},
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG,
    name="olmo-smoke",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=128,
    vocab_size=256,
)
