"""jamba-1.5-large-398b [hybrid] — Mamba+attn 1:7 interleave, MoE
[arXiv:2403.19887].

72L = 9×(1 attn + 7 mamba) super-blocks, d_model=8192, 64H (GQA kv=8),
d_ff=24576, vocab=65536, MoE 16 experts top-2 on every other layer.
Note: we use Mamba2 SSD blocks for the mamba layers (substrate-wide SSD
implementation; Jamba-1 used Mamba-1 — recorded deviation, DESIGN.md §9).
"""

import dataclasses

from .base import ModelConfig, MoEConfig, SSDConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    pattern=("attn",) + ("ssd",) * 7,
    ssd=SSDConfig(d_state=128, d_conv=4, expand=2, head_dim=64, n_groups=8),
    moe=MoEConfig(
        n_experts=16,
        experts_per_token=2,
        d_expert=24576,
        moe_every=2,
        capacity_factor=1.25,
    ),
    norm="rmsnorm",
    remat_policy="none",
    optimizer="adamw_bf16",  # capacity: bf16 moments (DESIGN §5)
    grad_accum={"train_4k": 8},
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG,
    name="jamba-smoke",
    num_layers=8,  # one super-block
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    ssd=SSDConfig(d_state=16, d_conv=4, expand=2, head_dim=16, n_groups=2, chunk=16),
    moe=MoEConfig(n_experts=4, experts_per_token=2, d_expert=128, moe_every=2),
)
