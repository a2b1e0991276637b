"""qwen1.5-110b [dense] — QKV bias [hf:Qwen/Qwen1.5-110B].

80L, d_model=8192, 64H (GQA kv=8), d_ff=49152, vocab=152064.
"""

import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-110b",
    family="dense",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=49152,
    vocab_size=152064,
    pattern=("attn",),
    qkv_bias=True,
    rope_theta=1_000_000.0,
    norm="rmsnorm",
    remat_policy="none",
    optimizer="adamw_bf16",  # capacity: bf16 moments (DESIGN §5)
    grad_accum={"train_4k": 8},
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG,
    name="qwen1.5-smoke",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=256,
)
