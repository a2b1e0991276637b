"""Batched serving runtime: SPDL request pipeline → prefill → decode loop.

Requests stream through an SPDL pipeline (tokenize and pad run on the
worker pool, as training-side loading does); the server runs a prefill on
each full batch, then greedy decode steps against the batch's cache, which
is allocated once at ``prompt_len + max_new`` and written in place.

Which kernel a prefill launches depends on the block kind: attention
blocks (Qwen3 and the other dense decoders) run the hand-written
``flash_attention`` kernel, once a layer, and keep a KV cache; DeepSeek's
MLA blocks run it too and keep the latent cache (``ckv`` and ``k_rope``);
Mamba2 SSD blocks run the hand-written ``ssd_scan`` kernel, once a layer,
and keep a fixed-size state (``ssm`` and ``conv``).  Decode steps run plain
PyTorch: masked attention over the KV cache (MLA's absorbed into the
latent space), or the one-token SSD recurrence.  An
SSD prompt is scanned in chunks of the reference's size
(``models.ssm.scan_chunk``: ``SSDConfig.chunk`` where it divides
``prompt_len``, else the largest power of two that does).

The server takes byte prompts, which carry one codebook and no image:
MusicGen (several codebooks) and InternVL2 (a vision prefix) are served
through the step builders of ``launch/steps.py``, which take their
(B, S, n_codebooks) tokens and ``vis_embed``; ``BatchServer`` raises for
them, as the reference's server fails on them.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable

import numpy as np
import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..core import PipelineBuilder
from ..data.tokenizer import ByteTokenizer
from ..launch.steps import build_decode_step, build_prefill_step
from ..device import resolve_device


@dataclasses.dataclass
class ServeResult:
    prompt: str
    token_ids: list[int]
    text: bytes


class BatchServer:
    def __init__(
        self,
        cfg: ModelConfig,
        params,
        *,
        batch_size: int = 4,
        prompt_len: int = 32,
        max_new: int = 16,
        device: torch.device | str | None = None,  # None = torch.device("cuda")
    ):
        if cfg.n_codebooks > 1 or cfg.vis_prefix_len:
            raise NotImplementedError(
                f"{cfg.name}: BatchServer's byte prompts carry one codebook and no image embeddings, so it "
                "cannot serve a multi-codebook or vision-prefix config (the reference's server fails on both); "
                "drive launch.steps.build_prefill_step and build_decode_step with the model's own inputs"
            )
        self.device = resolve_device(device, "BatchServer")
        self.cfg = cfg
        self.params = params
        self.batch_size = batch_size
        self.prompt_len = prompt_len
        self.max_new = max_new
        shape = ShapeConfig("serve", prompt_len, batch_size, "prefill")
        dshape = ShapeConfig("serve_d", prompt_len + max_new, batch_size, "decode")
        self.prefill = build_prefill_step(cfg, shape, self.device).fn
        self.decode = build_decode_step(cfg, dshape, self.device).fn
        self.tok = ByteTokenizer(cfg.vocab_size)

    # -- request pipeline -----------------------------------------------------
    def _batches(self, prompts: Iterable[str]):
        # the stages capture what they read, not the server: the pipeline's
        # objects hold one another in cycles, which would keep the server's
        # parameters alive after the pipeline stops, until the collector runs
        tok, prompt_len = self.tok, self.prompt_len

        def tokenize(p: str) -> dict:
            ids = tok.encode(p, add_eos=False)[:prompt_len]
            padded = np.zeros(prompt_len, np.int32)
            padded[-len(ids):] = ids  # left-pad so decode positions align
            return {"prompt": p, "tokens": padded}

        def to_batch(rows: list[dict]) -> dict:
            return {
                "prompts": [r["prompt"] for r in rows],
                "tokens": np.stack([r["tokens"] for r in rows]),
            }

        return (
            PipelineBuilder()
            .add_source(prompts, name="requests")
            .pipe(tokenize, concurrency=4, name="tokenize")
            .aggregate(self.batch_size, drop_last=False, name="batch")
            .pipe(to_batch, name="collate")
            .add_sink(buffer_size=2)
            .build(num_threads=4)
        )

    def generate(self, prompts: list[str]) -> list[ServeResult]:
        results: list[ServeResult] = []
        pipe = self._batches(prompts)
        with pipe.auto_stop():
            for batch in pipe:
                results.extend(self._generate_batch(batch))
        return results

    def _generate_batch(self, batch) -> list[ServeResult]:
        toks = batch["tokens"]
        b = toks.shape[0]
        if b < self.batch_size:  # pad the ragged tail batch
            toks = np.concatenate([toks, np.zeros((self.batch_size - b, toks.shape[1]), np.int32)])
        logits, caches = self.prefill(
            self.params, {"tokens": toks}, seq_cap=self.prompt_len + self.max_new
        )
        cur = logits.argmax(dim=-1, keepdim=True)  # greedy; first index on ties
        steps = []
        for t in range(self.max_new):
            steps.append(cur)
            logits, caches = self.decode(self.params, caches, cur, self.prompt_len + t)
            cur = logits.argmax(dim=-1, keepdim=True)
        out_ids = torch.cat(steps, dim=1).cpu().tolist()  # one sync per batch
        return [
            ServeResult(p, ids, self.tok.decode(np.array(ids)))
            for p, ids in zip(batch["prompts"], out_ids[:b])
        ]
