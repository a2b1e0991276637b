"""qwen3-0.6b [dense] — qk_norm, GQA [hf:Qwen/Qwen3-0.6B].

28L, d_model=1024, 16H (GQA kv=8, head_dim=128 explicit), d_ff=3072,
vocab=151936.
"""

import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b",
    family="dense",
    num_layers=28,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,  # explicit (≠ d_model // heads), per the release
    d_ff=3072,
    vocab_size=151936,
    pattern=("attn",),
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    norm="rmsnorm",
    grad_accum={"train_4k": 4},
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG,
    name="qwen3-smoke",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=32,
    d_ff=128,
    vocab_size=256,
)
