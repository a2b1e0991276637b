"""yi-6b [dense] — llama-arch GQA [arXiv:2403.04652].

32L, d_model=4096, 32H (GQA kv=4), d_ff=11008, vocab=64000.
"""

import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="yi-6b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=4,
    d_ff=11008,
    vocab_size=64000,
    pattern=("attn",),
    rope_theta=5_000_000.0,
    norm="rmsnorm",
    grad_accum={"train_4k": 4},
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG,
    name="yi-smoke",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=256,
)
