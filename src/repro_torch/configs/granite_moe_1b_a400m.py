"""granite-moe-1b-a400m [moe] — 32 experts top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base].

24L, d_model=1024, 16H (GQA kv=8), d_expert=512, vocab=49155.
"""

import dataclasses

from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    d_ff=0,  # every FFN is MoE
    vocab_size=49155,
    pattern=("attn",),
    moe=MoEConfig(n_experts=32, experts_per_token=8, d_expert=512),
    tie_embeddings=True,
    norm="rmsnorm",
    grad_accum={"train_4k": 2},
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG,
    name="granite-moe-smoke",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    vocab_size=256,
    moe=MoEConfig(n_experts=4, experts_per_token=2, d_expert=32),
)
