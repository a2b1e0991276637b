"""Model: the end-to-end LM API that the trainer and the server call.

- ``train_loss(params, batch)``              → (loss, metrics), differentiable
- ``prefill(params, batch, seq_cap)``        → (last-position logits, cache)
- ``decode_step(params, cache, tokens, pos)`` → (logits, cache updated in place)
- ``cache_spec(batch, seq_cap)`` → the cache's shapes and dtypes;
  ``new_cache(batch, seq_cap, device)`` allocates it.

Dense GQA decoders, attention-free Mamba2 (SSD) stacks, and either with
Mixture-of-Experts FFNs (Granite-MoE; Jamba's hybrid attention/SSD stack);
DeepSeek-V3's MLA attention with its latent cache, and its multi-token
prediction (MTP) loss in training; MusicGen's multi-codebook audio head
(tokens (B, S, n_codebooks), their embeddings summed, logits
(..., n_codebooks, padded_vocab)) and InternVL2's vision prefix
(``batch["vis_embed"]`` (B, vis_prefix_len, d_model), the stubbed
frontend's output, projected by ``vis_proj`` and spliced over the first
``vis_prefix_len`` positions in training and prefill).
"""

from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from . import transformer as tf
from .layers import (
    apply_embed,
    apply_head,
    apply_norm,
    cross_entropy,
    dtype_of,
    embed_defs,
    head_defs,
    mask_padded_vocab,
    norm_defs,
)
from .params import ParamDef, init_params, param_count

MTP_WEIGHT = 0.3


class Model:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg

    # ------------------------------------------------------------------
    # parameters
    # ------------------------------------------------------------------
    def param_defs(self) -> dict:
        cfg = self.cfg
        d = {
            "embed": embed_defs(cfg),
            "segments": tf.segment_defs(cfg),
            "final_norm": norm_defs(cfg),
            "head": head_defs(cfg),
        }
        if cfg.vis_prefix_len:  # projects the stubbed vision frontend's output
            d["vis_proj"] = {"w": ParamDef((cfg.d_model, cfg.d_model), ("embed", None), dtype_of(cfg))}
        if cfg.mtp:
            d["mtp"] = {
                "proj": ParamDef((2 * cfg.d_model, cfg.d_model), (None, "embed"), dtype_of(cfg)),
                "norm_h": norm_defs(cfg),
                "norm_e": norm_defs(cfg),
                "block": tf.block_defs(cfg, cfg.block_kinds()[0], False),
                "final_norm": norm_defs(cfg),
            }
        return d

    def init(self, seed: int, device: torch.device | str | None = None) -> dict:
        """Parameters drawn from ``seed`` on ``device`` (``None`` = the card)."""
        return init_params(self.param_defs(), seed, device)

    def param_count(self) -> int:
        return param_count(self.param_defs())

    # ------------------------------------------------------------------
    # training
    # ------------------------------------------------------------------
    def _embed_inputs(self, params: dict, batch: dict) -> torch.Tensor:
        """The token embeddings; with a vision prefix, positions
        0..vis_prefix_len-1 hold ``vis_embed @ vis_proj.w`` instead (joined
        by ``torch.cat``, so gradients reach both)."""
        cfg = self.cfg
        x = apply_embed(cfg, params["embed"], batch["tokens"])
        if not cfg.vis_prefix_len:
            return x
        n = cfg.vis_prefix_len
        vis = batch.get("vis_embed")
        if vis is None:
            raise ValueError(f"{cfg.name}: the batch needs vis_embed (B, {n}, {cfg.d_model})")
        b, s = x.shape[:2]
        if tuple(vis.shape) != (b, n, cfg.d_model):
            raise ValueError(f"{cfg.name}: vis_embed must be (B, {n}, {cfg.d_model}); got {tuple(vis.shape)}")
        if s < n:
            raise ValueError(f"{cfg.name}: {s} positions cannot hold the vision prefix of {n}")
        return torch.cat([vis.to(x.dtype) @ params["vis_proj"]["w"], x[:, n:]], dim=1)

    def _lm_loss(self, params: dict, h: torch.Tensor, batch: dict) -> torch.Tensor:
        cfg = self.cfg
        logits = apply_head(cfg, params["head"], params["embed"], h)
        labels = batch["labels"]
        if cfg.n_codebooks > 1:  # labels (B, S, n_codebooks), one a codebook
            logits = logits.reshape(*logits.shape[:2], cfg.n_codebooks, cfg.padded_vocab)
            if labels.shape != logits.shape[:-1]:
                raise ValueError(f"{cfg.name}: labels must be {tuple(logits.shape[:-1])}; got {tuple(labels.shape)}")
            return cross_entropy(mask_padded_vocab(cfg, logits), labels, (labels >= 0).float())
        logits = mask_padded_vocab(cfg, logits)
        if labels.dim() == 3:
            labels = labels[..., 0]
        return cross_entropy(logits, labels, (labels >= 0).float())

    def train_loss(self, params: dict, batch: dict) -> tuple[torch.Tensor, dict]:
        """batch: ``tokens`` and ``labels`` (B, S), labels negative where
        masked (both (B, S, n_codebooks) for a multi-codebook config, the
        loss the mean over every position and codebook); ``vis_embed``
        (B, vis_prefix_len, d_model) for a vision-prefix config, whose labels
        are masked over the prefix by the caller; ``positions`` (default ``arange(S)``) and ``segment_ids``
        (default zeros), which packed rows restart and number per document.
        Returns the loss (the mean next-token loss plus the MoE layers'
        summed load-balance loss, plus ``MTP_WEIGHT`` times the MTP loss
        where the config has it) and {"loss_lm", "aux", "loss"} (``aux`` is
        zero without MoE layers), with "loss_mtp" beside them for MTP."""
        cfg = self.cfg
        x = self._embed_inputs(params, batch)
        b, s = x.shape[:2]
        positions = batch.get("positions")
        if positions is None:
            positions = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
        segment_ids = batch.get("segment_ids")
        if segment_ids is None:
            segment_ids = torch.zeros((b, s), dtype=torch.int32, device=x.device)
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        for seg_params, segment in zip(params["segments"], cfg.segments()):
            x, aux = tf.segment_train(cfg, segment, seg_params, x, positions, segment_ids)
            aux_total = aux_total + aux
        h = apply_norm(cfg, params["final_norm"], x)
        loss_lm = self._lm_loss(params, h, batch)
        loss = loss_lm + aux_total
        metrics = {"loss_lm": loss_lm, "aux": aux_total}
        if cfg.mtp:
            loss_mtp = self._mtp_loss(params, x, batch, positions, segment_ids)
            loss = loss + MTP_WEIGHT * loss_mtp
            metrics["loss_mtp"] = loss_mtp
        metrics["loss"] = loss
        return loss, metrics

    def _mtp_loss(self, params: dict, h, batch: dict, positions, segment_ids) -> torch.Tensor:
        """DeepSeek-V3's multi-token prediction, one extra depth: at position
        t the backbone's output h_t (before the final norm), joined with the
        embedding of token t+1, goes through one more block of the first
        layer's kind (dense FFN) and the shared head to predict token t+2,
        the label at t+1.  ``torch.roll`` wraps as ``jnp.roll`` does; the
        last 2 positions have no t+2 target and are masked."""
        cfg = self.cfg
        mtp = params["mtp"]
        tokens, labels = batch["tokens"], batch["labels"]
        if tokens.dim() == 3:
            tokens = tokens[..., 0]
        if labels.dim() == 3:
            labels = labels[..., 0]
        emb_next = apply_embed(cfg, params["embed"], torch.roll(tokens, -1, dims=1))
        z = torch.cat([apply_norm(cfg, mtp["norm_h"], h), apply_norm(cfg, mtp["norm_e"], emb_next)], dim=-1)
        z, _ = tf.block_apply_train(
            cfg, cfg.block_kinds()[0], False, mtp["block"], z @ mtp["proj"], positions, segment_ids
        )
        z = apply_norm(cfg, mtp["final_norm"], z)
        logits = mask_padded_vocab(cfg, apply_head(cfg, params["head"], params["embed"], z))
        labels_p1 = torch.roll(labels, -1, dims=1)
        mask = (labels_p1 >= 0).float()
        mask[:, -2:] = 0.0
        return cross_entropy(logits, labels_p1, mask)

    # ------------------------------------------------------------------
    # cache
    # ------------------------------------------------------------------
    def cache_spec(self, batch: int, seq_cap: int) -> list:
        """Shapes and dtypes of the cache, in the prefill cache's structure:
        per segment ``{"blocks": [...]}``, one dict per block of the
        super-block, each entry (n_repeat, B, ...).  Attention blocks hold
        k/v (n_repeat, B, seq_cap, kv_heads, head_dim); MLA blocks the
        latents ``ckv`` (n_repeat, B, seq_cap, kv_lora_rank) and ``k_rope``
        (n_repeat, B, seq_cap, qk_rope_head_dim); SSD blocks hold the state
        ``ssm`` (n_repeat, B, H, P, N) f32 and the conv window ``conv``
        (n_repeat, B, d_conv - 1, conv_dim), neither of which depends on
        ``seq_cap``."""
        return [
            {"blocks": [self._mixer_cache_spec(kind, n_repeat, batch, seq_cap) for kind, _ in plan]}
            for plan, n_repeat in self.cfg.segments()
        ]

    def _mixer_cache_spec(self, kind: str, n: int, b: int, s_cap: int) -> dict:
        cfg = self.cfg
        dt = dtype_of(cfg)
        if kind == "attn":
            shape = (n, b, s_cap, cfg.num_kv_heads, cfg.resolved_head_dim)
            return {"k": (shape, dt), "v": (shape, dt)}
        if kind == "mla":
            m = cfg.mla
            return {"ckv": ((n, b, s_cap, m.kv_lora_rank), dt), "k_rope": ((n, b, s_cap, m.qk_rope_head_dim), dt)}
        s = cfg.ssd
        conv_dim = s.d_inner(cfg.d_model) + 2 * s.n_groups * s.d_state
        return {
            "ssm": ((n, b, s.n_heads(cfg.d_model), s.head_dim, s.d_state), torch.float32),
            "conv": ((n, b, s.d_conv - 1, conv_dim), dt),
        }

    def new_cache(self, batch: int, seq_cap: int, device: torch.device | str) -> list:
        """A zeroed cache of capacity ``seq_cap`` on ``device``."""
        return [
            {"blocks": [{name: torch.zeros(shape, dtype=dt, device=device)
                         for name, (shape, dt) in blk.items()} for blk in seg["blocks"]]}
            for seg in self.cache_spec(batch, seq_cap)
        ]

    # ------------------------------------------------------------------
    # serving
    # ------------------------------------------------------------------
    def prefill(self, params: dict, batch: dict, seq_cap: int | None = None) -> tuple[torch.Tensor, list]:
        """batch["tokens"] (B, S) → (logits (B, padded_vocab), cache);
        (B, S, n_codebooks) → logits (B, n_codebooks, padded_vocab) for a
        multi-codebook config.  A vision-prefix config also takes
        ``batch["vis_embed"]`` (B, vis_prefix_len, d_model), spliced over
        the first positions as in training.

        ``batch["positions"]`` (B, S), default ``arange(S)`` in every row, are
        the positions RoPE rotates by and attention masks by, as in the
        reference: a query sees the keys at positions up to its own, so rows
        that restart (packed prompts), repeat or reverse their positions are
        served.  A prompt without positions is masked by index, which is the
        same mask.

        An attention cache has capacity ``seq_cap`` (default S) and holds the
        prompt's k/v (MLA: its latents) in slots 0..S-1; decode steps write
        the slots after them.  An SSD cache holds the state after the prompt."""
        cfg = self.cfg
        x = self._embed_inputs(params, batch)
        b, s = x.shape[:2]
        positions = batch.get("positions")  # None: arange(S) in every row, masked by index
        if positions is not None:
            positions = torch.as_tensor(positions, device=x.device)
            if tuple(positions.shape) != (b, s):
                raise ValueError(f"positions must be (B, S) = {(b, s)}; got {tuple(positions.shape)}")
        caches = self.new_cache(b, s if seq_cap is None else seq_cap, x.device)
        for seg_params, seg_cache, segment in zip(params["segments"], caches, cfg.segments()):
            x = tf.segment_prefill(cfg, segment, seg_params, seg_cache, x, positions)
        h = apply_norm(cfg, params["final_norm"], x[:, -1:, :])
        logits = apply_head(cfg, params["head"], params["embed"], h)[:, 0]
        return self._shape_logits(logits), caches

    def decode_step(
        self, params: dict, caches: list, tokens: torch.Tensor, pos: int
    ) -> tuple[torch.Tensor, list]:
        """tokens (B, 1), or (B, 1, n_codebooks) for a multi-codebook
        config, at position ``pos``, the cache slot it writes; the logits
        are shaped as ``prefill``'s."""
        cfg = self.cfg
        x = apply_embed(cfg, params["embed"], tokens)
        for seg_params, seg_cache, segment in zip(params["segments"], caches, cfg.segments()):
            x = tf.segment_decode(cfg, segment, seg_params, seg_cache, x, pos)
        h = apply_norm(cfg, params["final_norm"], x)
        logits = apply_head(cfg, params["head"], params["embed"], h)[:, 0]
        return self._shape_logits(logits), caches

    def _shape_logits(self, logits: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        if cfg.n_codebooks > 1:
            logits = logits.reshape(logits.shape[0], cfg.n_codebooks, cfg.padded_vocab)
        return mask_padded_vocab(cfg, logits)

