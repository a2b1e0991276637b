"""deepseek-v3-671b [moe] — MLA, 1 shared + 256 routed top-8, MTP
[arXiv:2412.19437].

61L, d_model=7168, 128H, vocab=129280.  First 3 layers dense (d_ff=18432 per
the release); MoE layers use 256 routed experts (d_expert=2048, top-8) plus
1 shared expert.  MLA: q_lora 1536, kv_lora 512, rope 64, v_head 128.
"""

import dataclasses

from .base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,
    d_ff=18432,  # dense layers (first 3); spec's d_ff=2048 is the expert dim
    vocab_size=129280,
    pattern=("mla",),
    mla=MLAConfig(
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
    ),
    moe=MoEConfig(
        n_experts=256,
        experts_per_token=8,
        d_expert=2048,
        n_shared_experts=1,
        first_k_dense=3,
        capacity_factor=1.25,
    ),
    mtp=True,
    norm="rmsnorm",
    remat_policy="none",
    optimizer="adamw_bf16",  # capacity: bf16 moments (DESIGN §5)
    grad_accum={"train_4k": 8},
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG,
    name="deepseek-v3-smoke",
    num_layers=4,
    d_model=64,
    num_heads=4,
    d_ff=128,
    vocab_size=256,
    mla=MLAConfig(
        q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16
    ),
    moe=MoEConfig(
        n_experts=8, experts_per_token=2, d_expert=32, n_shared_experts=1, first_k_dense=1
    ),
)
