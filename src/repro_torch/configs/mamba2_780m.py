"""mamba2-780m [ssm] — SSD (state-space duality) [arXiv:2405.21060].

48L, d_model=1536, attention-free, d_ff=0, vocab=50280, ssm_state=128.
Tied embeddings (per the released checkpoints).
"""

import dataclasses

from .base import ModelConfig, SSDConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    num_layers=48,
    d_model=1536,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    pattern=("ssd",),
    ssd=SSDConfig(d_state=128, d_conv=4, expand=2, head_dim=64, n_groups=1),
    tie_embeddings=True,
    norm="rmsnorm",
    optimizer="adamw",
    grad_accum={"train_4k": 2},
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG,
    name="mamba2-780m-smoke",
    num_layers=4,
    d_model=64,
    vocab_size=256,
    ssd=SSDConfig(d_state=16, d_conv=4, expand=2, head_dim=16, n_groups=1, chunk=16),
)
