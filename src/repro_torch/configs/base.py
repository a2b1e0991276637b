"""Model / run configuration system.

One ``ModelConfig`` describes an architecture; the 10 assigned architectures
each get a module in this package exporting ``CONFIG`` (full size) and
``SMOKE_CONFIG`` (reduced, CPU-runnable).  ``ShapeConfig`` describes the
assigned input-shape cells (train / prefill / decode / long-context decode).
"""

from __future__ import annotations

import dataclasses
from typing import Literal

BlockKind = Literal["attn", "mla", "ssd"]


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-style Multi-head Latent Attention dims."""

    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSDConfig:
    """Mamba2 SSD block dims."""

    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 256  # SSD chunk length

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    experts_per_token: int
    d_expert: int  # per-expert ffn hidden dim
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.001  # load-balance loss
    moe_every: int = 1  # apply MoE FFN every k-th layer (others dense)
    first_k_dense: int = 0  # first k layers use dense FFN (DeepSeek)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    # repeating mixer pattern, cycled over num_layers, e.g. ("attn",) or
    # ("attn",) + ("ssd",)*7  (Jamba 1:7)
    pattern: tuple[BlockKind, ...] = ("attn",)
    head_dim: int = 0  # 0 -> d_model // num_heads
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    norm: str = "rmsnorm"  # rmsnorm | layernorm | nonparam_ln
    act: str = "swiglu"  # swiglu | gelu
    tie_embeddings: bool = False
    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    ssd: SSDConfig | None = None
    mtp: bool = False  # DeepSeek multi-token-prediction aux module
    n_codebooks: int = 1  # MusicGen EnCodec codebooks
    vis_prefix_len: int = 0  # InternVL2 patch-embedding prefix positions
    dtype: str = "bfloat16"
    # training-side knobs (capacity engineering; see DESIGN.md §5)
    remat: bool = True
    remat_policy: str = "dots"  # dots | none (full remat; ≥100B archs)
    attn_chunk: int = 0  # 0 -> auto: chunked attention when seq > 8192
    optimizer: str = "adamw"  # adamw | adamw_bf16 | sgdm | adafactor
    grad_accum: dict[str, int] = dataclasses.field(default_factory=dict)  # per-shape

    # -- derived -----------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 128 (Megatron/MaxText practice) so
        the vocab dim always divides TP=16; padded logits are masked to -inf
        in the loss and in serving."""
        return -(-self.vocab_size // 128) * 128

    def block_kinds(self) -> list[BlockKind]:
        """Mixer kind for each of the num_layers layers."""
        p = self.pattern
        return [p[i % len(p)] for i in range(self.num_layers)]

    def layer_is_moe(self) -> list[bool]:
        if self.moe is None:
            return [False] * self.num_layers
        m = self.moe
        return [
            i >= m.first_k_dense and (i % m.moe_every == m.moe_every - 1 if m.moe_every > 1 else True)
            for i in range(self.num_layers)
        ]

    def layer_plan(self) -> list[tuple[BlockKind, bool]]:
        return list(zip(self.block_kinds(), self.layer_is_moe()))

    def segments(self) -> list[tuple[list[tuple[BlockKind, bool]], int]]:
        """Split layers into (super_block_plan, n_repeat) segments so each
        segment is a repetition of an identical super-block — the unit we
        ``lax.scan`` over (keeps HLO size ~O(pattern), not O(num_layers))."""
        plan = self.layer_plan()
        n = len(plan)
        segments: list[tuple[list[tuple[BlockKind, bool]], int]] = []
        i = 0
        while i < n:
            # pick the super-block with the most repetitions (that's what
            # minimizes HLO size: one scan body per segment), tie-breaking on
            # layers covered, then on shorter super-blocks
            best = None  # (reps, covered, -blk_len, block)
            for blk_len in range(1, min(16, n - i) + 1):
                block = plan[i : i + blk_len]
                reps = 1
                while plan[i + reps * blk_len : i + (reps + 1) * blk_len] == block:
                    reps += 1
                cand = (reps, blk_len * reps, -blk_len, block)
                if best is None or cand[:3] > best[:3]:
                    best = cand
            reps, covered, _, block = best
            segments.append((block, reps))
            i += covered
        return segments


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"
    subquadratic_only: bool = False  # long_500k: SSM/hybrid archs only


TRAIN_4K = ShapeConfig("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524_288, 1, "decode", subquadratic_only=True)

SHAPES: dict[str, ShapeConfig] = {
    s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
}

#: Families whose decode state is sub-quadratic in context (may run long_500k)
SUBQUADRATIC_FAMILIES = ("ssm", "hybrid")


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Whether a (arch × shape) cell runs; (False, reason) for documented skips."""
    if shape.subquadratic_only and cfg.family not in SUBQUADRATIC_FAMILIES:
        return False, (
            "pure full-attention arch: 524k-token decode requires sub-quadratic "
            "state (see DESIGN.md §Arch-applicability)"
        )
    return True, ""
