"""internvl2-2b [vlm] — InternViT + InternLM2 [arXiv:2404.16821].

Backbone (InternLM2-1.8B): 24L, d_model=2048, 16H (GQA kv=8), d_ff=8192,
vocab=92553.  The InternViT frontend is a STUB per the assignment:
``input_specs()`` supplies 256 precomputed patch embeddings (B, 256, 2048)
which are projected and spliced over the first 256 positions.
"""

import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=92553,
    pattern=("attn",),
    vis_prefix_len=256,
    norm="rmsnorm",
    grad_accum={"train_4k": 4},
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG,
    name="internvl2-smoke",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    vis_prefix_len=8,
)
