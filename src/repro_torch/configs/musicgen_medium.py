"""musicgen-medium [audio] — decoder-only over EnCodec tokens
[arXiv:2306.05284].

48L, d_model=1536, 24H (MHA), d_ff=6144, 4 codebooks × vocab 2048.
The EnCodec frontend is a stub per the assignment: the data pipeline feeds
token ids (B, S, 4); embeddings are the sum over codebooks and the head
emits 4×2048 logits.  MusicGen uses plain LayerNorm + GELU FFN.
"""

import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    pattern=("attn",),
    n_codebooks=4,
    norm="layernorm",
    act="gelu",
    grad_accum={"train_4k": 2},
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG,
    name="musicgen-smoke",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=128,
    vocab_size=64,
)
