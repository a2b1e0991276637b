"""Drive the PyTorch port's image path, its LM serving path (dense, SSD,
Mixture-of-Experts, MLA, multi-codebook and vision-prefix models) and its
LM training path on one CUDA card and check them.

    python3 chip_smoke.py

Builds the hand-written kernels from ``src/repro_torch/kernels/csrc``,
holds each against its plain PyTorch version at the main paths' shapes
(with timings and the card's bound; the decode kernels bit for bit, also at
the edges of their row staging, and timed once more in turn beside a cast
and a copy of the same bytes), then runs
  - the port's image loader at ImageNet training geometry (256x256 RGB
    frames, batch 128, random 224x224 crops and flips decoded on the card),
    checks every delivered batch against the same loader run on the CPU,
    and times one batch's host→device copy; then at a batch of 4 over 64
    of the frames with one read failed (``loader_holes``), which blocked
    the loader for good until its slab ring counted the chunked slot
    binder's run-ahead: 15 dense batches, each equal to the CPU run's;
  - the same frames from the sharded record store (``shards``): packed into
    6 shards of 256 and read (a) by mmap, (b) over loopback HTTP through a
    prefetch cache of about two shards, (c) projected to the image column
    of an image + caption pack, (d) through (b)'s warm cache as a peer, (e)
    under ``HealthMonitor.guard()`` with 1% of reads failed and the metrics
    exporter scraped once; every image batch equal to (a)'s, which equals
    its CPU run; (f) token documents in shards over HTTP into
    ``build_lm_loader`` on the card (equal to the in-memory CPU run) and
    two ``Trainer.fit`` steps of Qwen3-0.6B in 2 layers; (g) the
    ``MPLoader`` baseline (4 spawned workers) into K2;
  - Qwen3-0.6B and Mamba2-780m at full width, cut to 2 layers, on the card
    against the same model and weights on the CPU (prefill, then 4 decode
    steps), and each so again at a prompt of 20 tokens: Qwen3's prefill
    pads it to K3's 64-row tiles (``prefill_ragged``), Mamba2's scans it in
    one chunk of 20 steps, not a multiple of K4's 64-row tiles
    (``prefill_ragged_ssd``), and Qwen3 at prompts of two packed
    documents whose positions restart, which K3 masks by position
    (``prefill_restart``);
  - ``apply_moe`` at Granite-MoE-1B-A400M's prefill shape on the card
    against the CPU, in f32 and bf16, and under
    ``torch.cuda.set_sync_debug_mode("error")`` (``moe``);
  - Granite-MoE-1B-A400M at full width, cut to 2 layers, on the card
    against the CPU in f32 with TF32 off (every route equal) and in bf16,
    and Jamba-1.5-Large (2 layers: attention with its dense FFN, then SSD
    with a 16-expert MoE; K3 and K4 in one stack) in bf16; every MoE
    route that differs is printed with its probability gap;
  - Qwen1.5-110B at full width, cut to 2 layers, on the card against the
    CPU in f32 and bf16, its QKV biases (zeros in the reference's init)
    drawn from a seed;
  - DeepSeek-V3 at full width on the card against the CPU: 2 dense MLA
    layers in f32 with TF32 off, and 4 layers (3 dense, then one of 256
    experts top 8 and a shared expert; 31.6 GB of bf16 weights) in bf16,
    MLA's prefill in K3 at head dim 192;
  - ``BatchServer`` on Qwen3-0.6B at full width and depth (28 layers,
    seed-initialized weights), prefill attention in ``flash_attention``;
  - ``BatchServer`` on Mamba2-780m at full width and depth (48 SSD layers,
    seed-initialized weights), the prefill scan in ``ssd_scan``;
  - ``BatchServer`` on Granite-MoE-1B-A400M at full width and depth (24
    attention layers, each FFN 32 experts top 8), K3 in its prefill;
  - ``BatchServer`` on DeepSeek-V3 at full width, cut to 4 layers, K3 in
    its MLA prefill;
  - ``BatchServer`` on Jamba-1.5-Large at full width, cut to 4 layers
    (attention + dense, SSD + MoE, SSD + dense, SSD + MoE), K3 and K4 in
    each prefill, and on Qwen1.5-110B cut to 4 layers;
  - MusicGen-medium (48 layers, four codebooks) and InternVL2-2B (24
    layers, a vision prefix of 256 positions) at full width and depth
    through ``build_prefill_step`` and ``build_decode_step`` in the
    server's greedy loop (``BatchServer`` takes byte prompts, which carry
    neither), K3 in every prefill; each checked before at 2 layers against
    the CPU in f32 and bf16;
  - the reference's long shapes through ``build_step`` at full width and
    depth (``long_shapes``): K3 at ``prefill_32k``'s attention of Qwen3,
    DeepSeek-V3 (MLA, head dim 192), Yi-6B and OLMo-1B and K4 at
    ``long_500k``'s scan against their plain versions; Qwen3-0.6B at
    ``prefill_32k`` (4 rows of 32,768) and ``decode_32k`` (8 rows, a
    prefill of 32,704 tokens, then 64 greedy steps to the cache's last
    slot); the decode step after a 32k prompt against the prefill of one
    token more; DeepSeek-V3 in 4 layers at ``prefill_32k`` and
    ``decode_32k`` (2 rows: 64 absorbed steps over the 32,768-slot latent
    cache) and its decode step against the prefill of one token more in its
    3 dense layers; Yi-6B and OLMo-1B at ``prefill_32k`` (2 rows);
    Jamba-1.5-Large in 3 layers at ``prefill_32k`` and ``decode_32k`` (2
    rows; K3 at its attention and K4 at its 32k scan held to their plain
    versions) and its decode step against the prefill of one token more;
    Qwen1.5-110B in 4 layers at ``prefill_32k`` (2 rows); Yi-6B and
    OLMo-1B at full depth and Qwen1.5-110B in 4 layers at ``decode_32k`` (2
    rows) and Yi-6B's decode step against the prefill of one token more;
    Granite-MoE-1B-A400M (4 rows), MusicGen-medium (2 rows, four
    codebooks), InternVL2-2B (4 rows, its vision prefix) and Mamba2-780m
    (8 rows) at full width and depth at ``prefill_32k`` and ``decode_32k``,
    K3 at Granite's and MusicGen's attention and K4 at Mamba2's 32k scan
    held to their plain versions, MusicGen's and InternVL2's decode step
    against the prefill of one token more, and Granite's so at the capacity
    that drops no pair, in bf16 and f32; Mamba2-780m at ``long_500k``
    (524,288 tokens, then 16 decode steps); the state after 524,288 tokens
    against a prefill of 64 tokens fewer and 64 decode steps; Jamba-1.5-Large
    in 3 layers at ``long_500k`` (a prefill of 524,272 tokens into the
    524,288-slot cache, then 16 decode steps) and its decode step there
    against the prefill of one token more; every prompt past 32,768 tokens
    prefilled in token windows (``Model.prefill``'s ``window``), K3 at a
    window's queries against 524,288 keys and K4 from an initial state held
    to their plain versions, and the windowed prefill against the whole one
    at 32,768 tokens;
  - one training step of Qwen3-0.6B, Mamba2-780m, Granite-MoE-1B-A400M,
    DeepSeek-V3, MusicGen-medium, InternVL2-2B, OLMo-1B and Yi-6B at full
    width, cut to 2 layers (DeepSeek to 1, its MTP block beside it), up to
    the optimizer's
    update, on the card against the same step on the CPU, in f32
    with TF32 off and in bf16 (``train_check``: loss, grad norm and every
    gradient leaf; Granite's aux loss and routes, DeepSeek's MTP loss too);
  - ``Trainer.fit`` on ``build_lm_loader`` batches at full width
    (``train``; sequence 4096, global batch 8): Qwen3-0.6B (cut to 14
    layers) for a step, with a checkpoint after it that a fresh
    ``Trainer.from_checkpoint`` restores bit for bit and then steps on from,
    Mamba2-780m (cut to 12 layers) for 2 steps, Granite-MoE-1B-A400M for 2
    steps (its aux loss beside the LM loss), OLMo-1B for 2 steps (both at
    full depth), Qwen1.5-110B cut to 2 layers for 2 steps on
    ``adamw_bf16``, step 1's update of a few parts of its parameters held
    on the host to one bf16 ulp (``adamw_update_check``), DeepSeek-V3 in
    its 3 dense MLA layers and the MTP block on ``adamw_bf16`` and Yi-6B
    cut to 16 layers on f32 moments, 2 steps each; and 2 steps of
    MusicGen-medium (cut to 24 layers) and InternVL2-2B at the same
    sequence and batch through ``build_step`` on ``train_batch``'s codebook
    labels and vision prefix (``phase_train_steps``).  Training launches
    none of the four kernels: the reference trains through its plain
    attention and SSD scan, which the port repeats under autograd;
  - the torch twins of the reference's four examples (``examples``, from
    ``examples_torch/``): (a) ``quickstart`` on the card, every batch equal
    to its CPU run; (b) every section of ``imagenet_pipeline``, each K1 and
    K2 output held against its plain version and its ``kernels/ref.py``
    oracle; (c) ``serve_llm`` at its smoke config, then Yi-6B and OLMo-1B
    checked in 2 layers against the CPU (f32 and bf16) and served at full
    width and depth through its ``serve``, each batch's ids equal to the
    step builders' greedy loop; (d) ``train_lm`` at its defaults for 100 steps, then
    again on the same directory, resuming at the saved step; (e) K3 and K4
    on both routes against their ``ref.py`` oracles.
Each phase prints one JSON line, then a ``seconds`` line with its time and
the script's so far.  The last three lines are the kernel
summary, the card's name and power limit as ``nvidia-smi`` gives them, and
``{"ok": true, "device": ...}``.

Exits non-zero, printing no result, when torch sees no CUDA card or when
any phase fails.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import io
import json
import math
import os
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tools"))  # route_check
sys.path.insert(0, str(ROOT / "tests"))  # torch_parity's draw_zero_leaves, which the CPU tests draw with too

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
BATCH, FRAME, CROP = 128, (256, 256), (224, 224)
FRAMES = 1536  # 12 batches an epoch; 2 epochs cycle the 10-slab ring twice over
# Peaks of the H100 SXM part (NVIDIA's data sheet, dense, at 700 W); every
# bound row carries the nvidia-smi name of the card it ran on beside them.
PEAKS_FOR = "H100 SXM"
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12  # outside the tensor cores
BF16_TC_OPS_PER_S = 989e12  # bf16 on the tensor cores
OPS_PER_ELEMENT = 3  # x*scale, -mean_c, *(1/std_c)
BF16_BAR, F32_BAR = "1 bf16 ulp", 2e-5
TIMED_RUNS = 30
HOST_COVER_CYCLES = 200_000  # a device sleep of ~0.1 ms, longer than a wrapper's host time
FA_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}  # tests/test_kernels.py TOL, atol and rtol
# bf16 K3 against its plain version, beside FA_TOL: max |got - want| over max |want| of each output row
# (one query of one head).  A row that sees n keys of unit-normal q, k, v has values ~sqrt(e / n), under
# FA_TOL's atol from n ~ 10k on, so FA_TOL alone passes a wrong row at 32k.  Both sides compute the same
# f32 arithmetic and round to bf16, so a sound row is at most one bf16 ulp of its largest value off
# (2**-8 .. 2**-7 of it); the bar is two ulps.  On an H100 every case read at most 2**-7, and faults
# planted in the kernel (probes_torch/k3_wgmma.py --faults) 0.29-1.9, one of them within FA_TOL at 32k
FA_ROW_REL = 2.0**-6
SSD_TOL = {torch.float32: 3e-5, torch.bfloat16: 6e-2}  # tests/test_kernels.py's SSD sweep, atol and rtol
# K4 against its plain version, beside SSD_TOL: for y, max |got - want| over max |want| of each (batch,
# head, chunk); for h_final, of each (batch, head).  At long-memory draws (ssd_inputs_long_memory) y and the
# state scale with dt, far under SSD_TOL's atol, so SSD_TOL alone passes a state carried wrongly between
# blocks.  Set from the readings of sound runs and of faults planted in the kernel's carry
# (probes_torch/k4_wgmma.py --faults; PERF.md)
SSD_CHUNK_REL = 2.0**-6
SSD_STATE_REL = 1e-4
MODEL_REL = 2e-2  # bf16 model outputs: max |card - cpu| over max |cpu|
# bf16: the SSD state of Jamba's decode step against the prefill of one token more.  The last tokens'
# inputs reach it through two bf16 pipelines (the step's and the prefill's) and three layers, attention,
# SSD + MoE, SSD: the SSD layer after the MoE read 2.07e-2 (seed 0) and 3.06e-2 (condition_attention's
# weights), the same check in f32 6.7e-5 and 6.7e-6 (probes_torch/hybrid_decode_gap.py, NVIDIA H100 80GB
# HBM3, 700.00 W).  The CPU tests hold jamba-smoke's bf16 caches to the reference's at the same bar
# (HYBRID_BF16_REL in tests/test_torch_models.py: 2.4-3.5e-2 measured there)
HYBRID_STATE_REL = 5e-2
TRAIN_F32_REL = 1e-4  # f32 train step, TF32 off: the CPU tests' f32 gradient bar, of the largest |cpu value|
SWAP_GAP = 1e-2  # bf16: a MoE route may differ from the CPU's only where its k-th and (k+1)-th probabilities are closer
SWAP_GAP_F32 = 1e-5  # f32, TF32 off: the same, for rounding some 1e-6 of a value
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW, SERVE_PROMPTS = 8, 512, 16, 16
MLA_V_DIM = 128  # DeepSeek-V3's v head dim, padded to q's 192 for K3
CHECK_SEQ, CHECK_BATCH = 512, 2  # train_check: one step, card against CPU, 2 layers
DEEPSEEK_CHECK_SEQ = 128  # DeepSeek-V3's train_check, one row, two steps on the CPU
DEEPSEEK_CHECK_LAYERS = 1  # cut from 2 for the time limit: one dense MLA layer and the MTP block, 3.12 B
TRAIN_SEQ, TRAIN_BATCH = 4096, 8  # train: TRAIN_4K's sequence, its global batch 256 cut to 8
# Qwen3's train phase, cut for the time limit from 6 steps, a checkpoint at 3 and 2 resumed steps,
# then from 3, a checkpoint at 2 and 1 resumed step; the steps after the checkpoint are the resumed
# trainer's (the trainer that saved it took them too until they were cut as a repeat)
TRAIN_STEPS, TRAIN_CKPT_AT = 2, 1
# examples phase: train_lm's first run, cut from its default 300 steps for the time limit (one
# checkpoint, at 100), and its second run, one of its logged steps (cut from two for the time limit)
TRAIN_LM_FIRST_STEPS, TRAIN_LM_RESUMED_STEPS = 100, 20
OWN_ROUNDING = 1.5  # a bf16 gradient leaf may differ by 1.5x the CPU's own bf16 rounding of it
SHARD_SAMPLES, SHARD_WINDOW = 256, 512  # shards phase: 6 shards of about 50 MB; the shuffle spans two
SHARD_CACHE_BYTES = 110_000_000  # about two shards: every epoch over HTTP evicts
LM_DOCS, LM_BATCHES = 4096, 3  # shards phase (f): token documents in 4 shards; batches held to the CPU run
MP_WORKERS = 4  # shards phase (g): the process-pool baseline's workers
CHECK_SEQ_DENSE = 256  # examples phase: Yi-6B's and OLMo-1B's model_check prompt
# long_shapes: the reference's SHAPES at full width and depth (DeepSeek-V3 in LONG_MLA_LAYERS), rows by
# (arch, shape), cut from the shapes' 32 and 128 for the time limit and the card's 80 GB: a decode_32k
# row of Qwen3-0.6B holds a 3.76 GB cache.  DeepSeek-V3's 4 layers hold 30.3 GB of bf16 weights; its
# prefill, a row of 32,768 tokens, holds about 7 GB of intermediates in an MLA layer (q, k, v, the padded
# v and their copies for K3) and about 30 GB in the MoE layer (apply_moe keeps the dispatched tokens and
# the experts' outputs, 4.7 GB each at 1,280 slots an expert, and combines 262,144 pairs of 7,168 values
# in f32, 7.5 GB twice): one row reckoned at about 62 GB, two at about 93 GB, and one row peaked at 63.72 GB
# (NVIDIA H100 80GB HBM3, 700.00 W).  apply_moe now sums the k gated outputs into one f32 (B, S, D)
# accumulator (0.94 GB a row) and lets the dispatched tokens and the experts' intermediates go before the
# combine: about 12-13 GB a row in the MoE layer at its peak, 2 rows about 60-68 GB beside the 31.6 GB
# Jamba-1.5-large in JAMBA_LONG_LAYERS layers reckons at about 19 GB a row of 32,768 tokens in its MoE
# layer (5,120 slots an expert at capacity factor 1.25: the dispatched tokens 1.34 GB, the experts' three
# intermediates about 4 GB each, their outputs 1.34 GB, two f32 copies of 65,536 pairs 2.1 GB each) and
# about 8 GB in an SSD layer, beside 25.9 GB of weights: 2 rows.  Qwen1.5-110B in QWEN15_LAYERS layers:
# 15.9 GB of weights and about 9.7 GB a row of FFN intermediates: 2 rows.  decode_32k, 2 rows each: Yi-6B's
# cache 2.15 GB a row beside 12.1 GB of weights, OLMo-1B's (MHA) 4.29 GB a row beside 2.35 GB, Qwen1.5-110B's
# in QWEN15_LAYERS layers 0.54 GB a row beside 15.9 GB.  Granite-MoE-1B-A400M: 2.7 GB of weights; a row of
# 32,768 holds a 1.61 GB cache and about 5 GB in a MoE layer (10,240 slots an expert: the dispatched tokens
# 0.67 GB, three expert intermediates of 0.34 GB, their outputs 0.67 GB, the token-order gather 0.54 GB, two
# f32 copies of 262,144 pairs 1.07 GB each): 4 rows.  MusicGen-medium: 2.8 GB; its 48 MHA layers of 1,536
# hold a 9.66 GB cache a row: 2 rows.  InternVL2-2B: 3.8 GB; a 3.22 GB cache and 1.6 GB of FFN intermediates
# a row: 4 rows, so its K3 shape is Qwen3-0.6B's (LAUNCH_KEYS).  Mamba2-780m: 1.6 GB; a 75 MB state and
# about 2 GB of transients a row in a layer: 8 rows (long_500k's row of 524,288 peaked at 45.9 GB).
# Jamba-1.5-large at long_500k, JAMBA_LONG_LAYERS layers, one row: prefilled in token windows of 32,768
# (Model.prefill), it holds 25.9 GB of weights, the bf16 residual stream of 524,288 x 8,192 (8.6 GB), the
# 2.15 GB cache and one window's intermediates (about 19 GB in the MoE layer, 8 in an SSD layer): 55-62 GB
LONG_ROWS = {("qwen3-0.6b", "prefill_32k"): 4, ("qwen3-0.6b", "decode_32k"): 8, ("mamba2-780m", "long_500k"): 1,
             ("jamba-1.5-large-398b", "long_500k"): 1,
             ("deepseek-v3-671b", "prefill_32k"): 2, ("deepseek-v3-671b", "decode_32k"): 2,
             ("yi-6b", "prefill_32k"): 2, ("olmo-1b", "prefill_32k"): 2,
             ("jamba-1.5-large-398b", "prefill_32k"): 2, ("jamba-1.5-large-398b", "decode_32k"): 2,
             ("qwen1.5-110b", "prefill_32k"): 2,
             ("yi-6b", "decode_32k"): 2, ("olmo-1b", "decode_32k"): 2, ("qwen1.5-110b", "decode_32k"): 2,
             ("granite-moe-1b-a400m", "prefill_32k"): 4, ("granite-moe-1b-a400m", "decode_32k"): 4,
             ("musicgen-medium", "prefill_32k"): 2, ("musicgen-medium", "decode_32k"): 2,
             ("internvl2-2b", "prefill_32k"): 4, ("internvl2-2b", "decode_32k"): 4,
             ("mamba2-780m", "prefill_32k"): 8, ("mamba2-780m", "decode_32k"): 8}
LONG_MLA_LAYERS = 4  # DeepSeek-V3 as serve runs it: 3 dense MLA layers, then one of 256 experts
LONG_MLA_CHECK_LAYERS = 3  # its decode-against-prefill check: the dense layers alone (first_k_dense)
# Jamba at the long shapes: attention + dense FFN, SSD + MoE, SSD + dense, every block kind it has (25.9 GB)
JAMBA_LONG_LAYERS = 3
JAMBA_SERVE_LAYERS = 4  # serve: attention + dense, SSD + MoE, SSD + dense, SSD + MoE (46.1 GB)
QWEN15_LAYERS = 4  # Qwen1.5-110B served and at prefill_32k (15.9 GB); its model_check in 2 (10.4 GB)
# the hybrid decode check: at capacity factor experts / top-k (8) an expert holds every token of the
# prompt, and its three intermediates take 786 kB a token (25.7 GB at 32,705 tokens): at 8,192 the MoE
# layer holds about 24 GB beside the 25.9 GB of weights.  Its f32 witness: 51.8 GB of weights, and at
# 2,048 tokens about 12 GB in the MoE layer.  The prefill of one token more scans in chunks of 1
JAMBA_CHECK_PROMPT = {"bfloat16": 8192, "float32": 2048}
# Granite-MoE's decode check, LONG_CHECK_LAYERS layers at capacity factor experts / top-k (4): an expert
# holds every token, 32 x 32,708 slots a row; the dispatched tokens and the experts' outputs 2.14 GB each
# and three intermediates 1.07 GB each a row in bf16, twice that in f32: the whole decode_32k prompt, one
# row as Jamba's (2 rows took 8.6 and 10.8 s on an H100)
GRANITE_CHECK_ROWS = 1
ROUTE_DIFFERENCES_SHOWN = 16  # a long check's own route differences printed, those at the largest gaps
# long_k3: arch -> (case, the kernels line's key, the rows and q heads held to the plain version, None: all)
LONG_K3 = {"qwen3-0.6b": ("k3_prefill_32k", "prefill_32k", None, None),
           "deepseek-v3-671b": ("k3_mla_prefill_32k", "mla_prefill_32k", 1, 32),
           "yi-6b": ("k3_yi_prefill_32k", "yi_prefill_32k", 1, None),
           "olmo-1b": ("k3_olmo_prefill_32k", "olmo_prefill_32k", 1, None),
           "qwen1.5-110b": ("k3_h64_kv8_prefill_32k", "h64_kv8_prefill_32k", 1, None),
           "granite-moe-1b-a400m": ("k3_granite_prefill_32k", "granite_prefill_32k", 1, None),
           "musicgen-medium": ("k3_musicgen_prefill_32k", "musicgen_prefill_32k", 1, None)}
# long_k4: (arch, the shape whose scan it is) -> (case, the kernels line's key); Mamba2's long_500k case is
# the whole 524,288-token scan, which its prefill in token windows no longer launches (LONG_K4_H0's is)
LONG_K4 = {("mamba2-780m", "long_500k"): ("k4_long_500k", "long_500k"),
           ("jamba-1.5-large-398b", "prefill_32k"): ("k4_jamba_prefill_32k", "jamba_prefill_32k"),
           ("mamba2-780m", "prefill_32k"): ("k4_mamba2_prefill_32k", "mamba2_prefill_32k")}
# K3 at the last two token windows of Jamba's long_500k prefill (long_k3_window): case, the kernels line's key
LONG_K3_WINDOW = ("k3_jamba_long_500k", "jamba_long_500k_windows")
LONG_K3_WINDOW_ROWS = 1024  # its plain version runs on a window's last rows of one kv head's q heads
# K4 from an initial state h0 at a window of a long_500k prefill (long_k4_h0): arch -> (case, the kernels
# line's key); Mamba2's 48 heads split their chunks in segments, Jamba's 256 do not
LONG_K4_H0 = {"jamba-1.5-large-398b": ("k4_h0_jamba_window", "jamba_window_h0"),
              "mamba2-780m": ("k4_h0_mamba2_window", "mamba2_window_h0")}
# long_run: the kernels line's entries under which an (arch, shape) path counts its launches, the entries of
# the long_k3/long_k4/long_k3_window/long_k4_h0 cases at its kernels' shapes.  A decode_32k prefill counts
# under its prefill_32k case.  Jamba's attention is Qwen1.5-110B's K3 shape (64 heads of 128 over 8 kv heads, 2
# rows at prefill_32k), InternVL2-2B's Qwen3-0.6B's (16 heads of 128 over 8 kv heads, 4 rows).  A long_500k
# prefill's windows count under the window cases, which time windows of the shapes that prefill runs
_KEYS_32K = {"qwen3-0.6b": {"flash_attention": "prefill_32k"},
             "deepseek-v3-671b": {"flash_attention": "mla_prefill_32k"},
             "yi-6b": {"flash_attention": "yi_prefill_32k"},
             "olmo-1b": {"flash_attention": "olmo_prefill_32k"},
             "qwen1.5-110b": {"flash_attention": "h64_kv8_prefill_32k"},
             "granite-moe-1b-a400m": {"flash_attention": "granite_prefill_32k"},
             "musicgen-medium": {"flash_attention": "musicgen_prefill_32k"},
             "internvl2-2b": {"flash_attention": "prefill_32k"},
             "jamba-1.5-large-398b": {"flash_attention": "h64_kv8_prefill_32k", "ssd_scan": "jamba_prefill_32k"},
             "mamba2-780m": {"ssd_scan": "mamba2_prefill_32k"}}
LAUNCH_KEYS = {**{(arch, shape): keys for arch, keys in _KEYS_32K.items() for shape in ("prefill_32k", "decode_32k")},
               ("jamba-1.5-large-398b", "long_500k"): {"flash_attention": LONG_K3_WINDOW[1],
                                                       "ssd_scan": LONG_K4_H0["jamba-1.5-large-398b"][1]},
               ("mamba2-780m", "long_500k"): {"ssd_scan": LONG_K4_H0["mamba2-780m"][1]}}
# the windowed prefill against the whole one (long_window_check), Jamba in JAMBA_LONG_LAYERS layers, one row:
# (tokens, window) by dtype; the f32 witness at the length its 51.8 GB of weights leave room for
WINDOW_CHECK = {"bfloat16": (32_768, 8_192), "float32": (4_096, 1_024)}
LONG_TAIL = 64  # decode_32k decodes the cache's last 64 slots; the checks decode 64 tokens after a prefill
LONG_500K_STEPS = 16  # long_500k's decode steps from the prefill's state
# Jamba at long_500k: the prompt leaves the cache's last LONG_500K_ROOM slots to the decode steps
LONG_500K_ROOM = LONG_500K_STEPS
LONG_500K_PROMPT = 524_288 - LONG_500K_ROOM  # and its decode check's prompt
LONG_CHECK_LAYERS = 4  # the decode-against-prefill and state checks: full width, 4 layers
LONG_TIMED_RUNS = 5  # K3/K4 at the long shapes: each launch is 35-215 ms
# Yi-6B and OLMo-1B have no qk_norm: on the seed-0 weights an H100 read Yi f32 1.52e-4 / 3.90e-4 and
# bf16 8.7e-3 / 0.127 (prefill / decode logits), OLMo bf16 5.95e-2 / 0.225, over their bars, and OLMo f32
# 4.8e-5 / 7.4e-5, within; the checks over the bar run on condition_attention's weights
# Qwen1.5-110B has none either, and a wider d_model (8,192) over the same 128-dim heads: both run so.
# MusicGen-medium and InternVL2-2B neither: on the seed-0 weights an H100 read f32 6.99e-5 and 8.81e-5 of
# the largest CPU value (logits), bf16 2.31e-2 / 5.67e-2 and 0.177 / 0.125 (prefill / decode logits)
CONDITIONED = {("yi-6b", "float32"): True, ("yi-6b", "bfloat16"): True,
               ("olmo-1b", "float32"): False, ("olmo-1b", "bfloat16"): True,
               ("qwen1.5-110b", "float32"): True, ("qwen1.5-110b", "bfloat16"): True,
               ("musicgen-medium", "float32"): True, ("musicgen-medium", "bfloat16"): True,
               ("internvl2-2b", "float32"): True, ("internvl2-2b", "bfloat16"): True}
QWEN15_CHECK_SEQ = 128  # Qwen1.5-110B's model_check prompt, as Jamba's: the CPU run is most of its time
YI_CHECK_SEQ = 128  # Yi-6B's train_check: one row, as DeepSeek-V3's; its 2 layers hold 0.87 B parameters
# train: Qwen1.5-110B in 2 layers, 5.21 B parameters: bf16 params, gradients and both adamw_bf16 moments
# come to 41.7 GB, beside about 5-8 GB of f32 logits of 4,096 x 152,064 and their gradient (4 layers would
# hold 63 GB of state alone)
QWEN15_TRAIN_LAYERS = 2
ADAMW_CHECK_ROWS = 4096  # the AdamW update check holds the embedding's and layer 0's w_down's first rows
ADAMW_CHECK_PIECE = 1 << 22  # ... and runs on the host in pieces of this many elements
# train: depth cut for the time limit (PERF.md §5 keeps the full-depth steps): Qwen3-0.6B from 28, Mamba2-780m
# from 48 (24 until this slice's cases came in)
QWEN3_TRAIN_LAYERS, MAMBA2_TRAIN_LAYERS = 14, 12
# MusicGen-medium's train_4k steps in 24 of its 48 layers, as Mamba2's: 0.70 B parameters, about 7 GB of
# parameters and moments (InternVL2-2B's 24 layers, its full depth: 1.89 B, about 19 GB)
MUSICGEN_TRAIN_LAYERS = 24
# train: DeepSeek-V3 in its 3 dense MLA layers (first_k_dense) and the MTP block, which is dense too
# (block_kinds()[0]), on adamw_bf16 at accum 8: the embedding and the head 0.93 B each, 0.58 B a dense
# layer, the MTP block 0.69 B, 4.29 B in all, about 25.7 GB of bf16 parameters and moments and 8.6 GB of
# bf16 gradients (twice that while a microbatch's gradients are summed).  No MoE layer: one layer of 256
# experts holds 11.3 B parameters, about 90 GB of adamw_bf16 state alone
DEEPSEEK_TRAIN_LAYERS = 3
# train: Yi-6B on f32 AdamW moments (its config's adamw) at accum 4, 2 rows a microbatch: 0.524 B parameters
# outside the layers and 0.173 B a layer, 10 bytes a parameter of bf16 parameters and f32 moments, 2 of the
# summed bf16 gradients and 2 more of a microbatch's while they are summed.  24 layers: 4.68 B, 56.1 GB of
# state and summed gradients, 65.5 GB with a microbatch's, then the backward's transients (f32 logits of
# 2 x 4,096 x 64,000 and their gradient, 2.1 GB each, one recomputed layer, 24 saved layer inputs) of about
# 8-12 GB: 73-78 GB, less than 8 GB under the card's 80.  16 layers: 3.29 B, 39.5 GB, 46.0 GB with a
# microbatch's, about 54-58 GB at the peak; the update's f32 temporaries (about four of the largest leaf,
# the 0.26 B embedding: 4.2 GB) come after a microbatch's gradients are freed.  Full depth (32 layers,
# 72.7 GB before activations) does not fit
YI_TRAIN_LAYERS = 16
# loader_holes: the image loader at a batch of 4 over the first 64 frames, one read failed (ROADMAP F-ref-5)
HOLES_BATCH, HOLES_FRAMES, HOLES_FAILED, HOLES_LIMIT_S = 4, 64, 7, 120.0


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


SCRIPT_START = time.monotonic()


def timed(label: str, fn, *args, **kwargs) -> None:
    """Run one phase, then print its seconds and the script's so far under ``label``."""
    t0 = time.monotonic()
    fn(*args, **kwargs)
    emit({"phase": "seconds", "of": label, "seconds": time.monotonic() - t0,
          "script_seconds": time.monotonic() - SCRIPT_START})


def bf16_ulp_steps(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Distance in bf16 ulps between two bf16 tensors of equal shape."""
    def order(t):
        bits = t.contiguous().view(torch.int16).to(torch.int32)
        mag = bits & 0x7FFF
        return torch.where(bits < 0, -mag, mag)
    return (order(got) - order(want)).abs()


def compare(got: torch.Tensor, want: torch.Tensor) -> dict:
    """max |got - want| and the count of elements over the dtype's bar."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"shape/dtype {got.shape} {got.dtype} vs {want.shape} {want.dtype}")
    err = (got.float() - want.float()).abs()
    if got.dtype == torch.bfloat16:
        over = int((bf16_ulp_steps(got, want) > 1).sum())
        bar = BF16_BAR
    else:
        over = int((err > F32_BAR).sum())
        bar = F32_BAR
    if not torch.isfinite(got.float()).all():
        raise AssertionError("non-finite output")
    return {"max_abs_err": float(err.max()), "mismatches": int((err > 0).sum()),
            "over_bar": over, "bar": bar}


def release_card() -> None:
    """Return what earlier phases left to the card before a phase that needs
    most of it: objects in reference cycles (a pipeline's, a trainer's) go
    only when the collector runs, and with them the tensors they hold."""
    gc.collect()
    torch.cuda.empty_cache()


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _timed_once(fn, flush: torch.Tensor, hide_host: bool) -> float:
    flush.zero_()
    if hide_host:
        torch.cuda._sleep(HOST_COVER_CYCLES)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def time_ms(fn, flush: torch.Tensor, hide_host: bool = True, runs: int = TIMED_RUNS, warm: int = 3) -> float:
    """Median device time of ``fn`` over ``runs`` launches after ``warm``
    untimed ones, each after an L2 flush (the decode reads a batch that was
    just copied in, cold).  With ``hide_host`` the card sleeps after the
    flush while the host enqueues ``fn``, so the wrapper's host time before
    its launch is not counted."""
    for _ in range(warm):
        fn()
    return statistics.median(_timed_once(fn, flush, hide_host) for _ in range(runs))


def time_interleaved_ms(fns: dict, flush: torch.Tensor) -> dict:
    """``time_ms`` of each of ``fns``, taken in turn within each of the
    TIMED_RUNS rounds, so that all of them see the same card state."""
    for fn in fns.values():
        for _ in range(3):
            fn()
    times: dict[str, list[float]] = {name: [] for name in fns}
    for _ in range(TIMED_RUNS):
        for name, fn in fns.items():
            times[name].append(_timed_once(fn, flush, True))
    return {name: statistics.median(t) for name, t in times.items()}


def host_ms(fn, dev: torch.device) -> float:
    """Median host time of one call of ``fn`` with the card idle: what the
    caller's thread spends before it returns."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(TIMED_RUNS):
        sync(dev)
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    sync(dev)
    return statistics.median(times)


def bound(nbytes: int, ops: int, ops_per_s: float, card: str) -> dict:
    """The least time for ``nbytes`` of memory traffic and ``ops`` operations
    at the published peaks of ``PEAKS_FOR``, with the card it ran on."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "ops": ops, "peaks_for": PEAKS_FOR, "card": card}


def dequant_bound(n_read: int, in_size: int, n_out: int, out_size: int, extra_bytes: int, card: str) -> dict:
    return bound(n_read * in_size + n_out * out_size + extra_bytes, n_out * OPS_PER_ELEMENT, F32_OPS_PER_S, card)


def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return smi


def phase_build() -> None:
    from repro_torch.kernels import _build

    seconds, log = _build.build_all()
    ptxas = [ln.strip() for ln in log.splitlines()
             if "entry function" in ln or ("ptxas info" in ln and "Used" in ln) or "spill" in ln]
    emit({"phase": "build", "seconds": seconds, "dir": str(_build.BUILD_DIR.relative_to(ROOT)), "ptxas": ptxas})


def phase_kernels(dev: torch.device, summary: dict, card: str) -> None:
    """K1 and K2 against their plain versions on the card, every case bit
    for bit: the main paths' shapes, and the edges of the kernel's row
    staging (spans that end at x's last byte, rows of 51 bytes, odd left
    offsets that start a span mid-word, a batch of 1, a row tile cut short,
    draws outside the frame and flips other than 0 and 1).  The main cases
    are timed, K1 also through its wrapper, and K1, K2 and a same-bytes
    cast once more in turn."""
    from repro_torch.kernels import dequant_normalize as dn

    gen = torch.Generator(device="cpu").manual_seed(0)
    mean = torch.tensor(MEAN, device=dev)
    std = torch.tensor(STD, device=dev)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)  # > the 50 MB L2
    k1, k2 = summary["dequant_normalize_augment"], summary["dequant_normalize"]

    def frames(shape, dtype):
        if dtype == torch.uint8:
            return torch.randint(0, 256, shape, generator=gen, dtype=torch.uint8).to(dev)
        return torch.rand(shape, generator=gen).to(dev)

    def draws(kind, n, h, w, oh, ow):
        flip = torch.randint(0, 2, (n,), generator=gen, dtype=torch.int32)
        top = torch.randint(0, h - oh + 1, (n,), generator=gen)
        left = torch.randint(0, w - ow + 1, (n,), generator=gen)
        if kind == "corner":
            top, left = torch.full((n,), h - oh), torch.full((n,), w - ow)
        elif kind == "odd_left":
            left = (left | 1).clamp(max=w - ow)
        elif kind == "wild":
            flip = torch.tensor([2, -1, 7, 0] * n, dtype=torch.int32)[:n]
            top = torch.tensor([-5, 100, -1, 1000] * n)[:n]
            left = torch.tensor([100, -5, -1, 3] * n)[:n]
        return flip, torch.stack([top, left], 1).to(torch.int32)

    def exact(row, what):
        if row["mismatches"]:
            emit(row)
            raise AssertionError(f"{what}: {row['mismatches']} elements differ from the plain version")

    u8, f32, bf16 = torch.uint8, torch.float32, torch.bfloat16
    odd = (3, 13, 17, 3)  # 51-byte rows; x ends 5 bytes into a 16-byte word
    cases = [  # name, shape, in dtype, out_hw, out dtype, draws
        ("main", (BATCH, *FRAME, 3), u8, CROP, bf16, "random"),
        ("f32_in", (BATCH, *FRAME, 3), f32, CROP, bf16, "random"),
        ("f32_out", (BATCH, *FRAME, 3), u8, CROP, f32, "random"),
        ("odd", odd, u8, (9, 11), bf16, "random"),
        ("far_corner", (BATCH, *FRAME, 3), u8, CROP, bf16, "corner"),
        ("far_corner_odd", odd, u8, (9, 11), bf16, "corner"),
        ("odd_left", (BATCH, *FRAME, 3), u8, CROP, bf16, "odd_left"),
        ("batch1", (1, *FRAME, 3), u8, CROP, bf16, "random"),
        ("ragged_rows", (4, 40, 48, 3), u8, (27, 32), bf16, "random"),  # 27 rows: 3 tiles of 8 and one of 3
        ("wild_draws", (4, 40, 48, 3), u8, (27, 32), bf16, "wild"),
        ("odd_f32_in_out", odd, f32, (9, 11), f32, "corner"),
    ]
    for case, shape, in_dtype, (oh, ow), out_dtype, kind in cases:
        n, h, w, c = shape
        x = frames(shape, in_dtype)
        flip, crop = draws(kind, n, h, w, oh, ow)
        got = dn.dequant_normalize_augment(x, mean, std, flip, crop, out_hw=(oh, ow), out_dtype=out_dtype)
        want = dn.dequant_normalize_augment_plain(x, mean, std, flip, crop, out_hw=(oh, ow), out_dtype=out_dtype)
        sync(dev)
        row = {"phase": "kernels", "kernel": "dequant_normalize_augment", "case": case,
               "shape": list(shape), "in": str(in_dtype), "out_hw": [oh, ow], "out": str(out_dtype),
               "draws": kind, **compare(got, want)}
        k1["max_abs_err"] = max(k1["max_abs_err"], row["max_abs_err"])
        exact(row, f"dequant_normalize_augment {case}")
        if case == "main":
            dflip, dcrop = flip.to(dev), crop.to(dev)
            params = dn._card_draws(x, dflip, dcrop)

            def wrapper():
                return dn.dequant_normalize_augment(x, mean, std, flip, crop, out_hw=(oh, ow), out_dtype=out_dtype)

            row["ms"] = time_ms(lambda: dn._launch(x, mean, std, params, oh, ow, dn.U8_SCALE, out_dtype, "k1"),
                                flush)
            row["wrapper_ms"] = time_ms(wrapper, flush, hide_host=False)
            row["wrapper_host_ms"] = host_ms(wrapper, dev)
            row["plain_ms"] = time_ms(lambda: dn.dequant_normalize_augment_plain(
                x, mean, std, dflip, dcrop, out_hw=(oh, ow), out_dtype=out_dtype), flush)
            row.update(dequant_bound(n * oh * ow * c, x.element_size(), n * c * oh * ow, got.element_size(),
                                     params.numel() * 4 + 2 * c * 4, card))
            row["over_bound"] = row["ms"] / row["bound_ms"]
            row["wrapper_note"] = ("wrapper_ms: device time with the host's draws staged and copied in the "
                                   "timed window; wrapper_host_ms: the caller's host time a call, card idle")
            k1_main = (x, params)
            k1.update({key: row[key] for key in
                       ("ms", "plain_ms", "bound_ms", "bound_by", "wrapper_ms", "wrapper_host_ms")})
        emit(row)

    k2_cases = [  # name, shape, in dtype, out dtype
        ("main", (BATCH, *CROP, 3), u8, bf16),
        ("odd", odd, u8, bf16),
        ("odd_f32_out", odd, u8, f32),
        ("batch1", (1, *CROP, 3), u8, bf16),
    ]
    for case, shape, in_dtype, out_dtype in k2_cases:
        x = frames(shape, in_dtype)
        got = dn.dequant_normalize(x, mean, std, out_dtype=out_dtype)
        want = dn.dequant_normalize_plain(x, mean, std, out_dtype=out_dtype)
        sync(dev)
        row = {"phase": "kernels", "kernel": "dequant_normalize", "case": case,
               "shape": list(x.shape), "out": str(out_dtype), **compare(got, want)}
        k2["max_abs_err"] = max(k2["max_abs_err"], row["max_abs_err"])
        exact(row, f"dequant_normalize {case}")
        if case == "main":
            row["ms"] = time_ms(lambda: dn.dequant_normalize(x, mean, std), flush)
            row["plain_ms"] = time_ms(lambda: dn.dequant_normalize_plain(x, mean, std), flush)
            row.update(dequant_bound(x.numel(), 1, x.numel(), 2, 2 * 3 * 4, card))
            row["over_bound"] = row["ms"] / row["bound_ms"]
            k2_x = x
            k2.update({key: row[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by")})
        emit(row)

    # K1 and K2 in turn, with a cast that reads and writes K2's bytes beside them
    x1, params = k1_main
    half = torch.empty(k2_x.numel() * 3 // 2, dtype=torch.uint8, device=dev)  # half of K2's bytes
    half_out = torch.empty_like(half)
    both = time_interleaved_ms({
        "k1": lambda: dn._launch(x1, mean, std, params, *CROP, dn.U8_SCALE, bf16, "k1"),
        "k2": lambda: dn._launch(k2_x, mean, std, None, *CROP, dn.U8_SCALE, bf16, "k2"),
        "same_bytes": lambda: k2_x.to(bf16),
        "memcpy_same_bytes": lambda: half_out.copy_(half),
    }, flush)
    emit({"phase": "kernels", "case": "k1_k2_interleaved", "k1_ms": both["k1"], "k2_ms": both["k2"],
          "same_bytes_ms": both["same_bytes"], "memcpy_same_bytes_ms": both["memcpy_same_bytes"],
          "bound_ms": k2["bound_ms"],
          "same_bytes": "x.to(torch.bfloat16) on K2's input: the same bytes read and written, "
                        "no transpose, no normalize; a yardstick, not library_ms",
          "memcpy_same_bytes": "a device-to-device copy of half K2's bytes: the same bytes moved as "
                               "plainly as the card moves them",
          "order": "K1, K2, same_bytes, memcpy_same_bytes in turn, each after an L2 flush, "
                   "median of TIMED_RUNS rounds"})
    k1["interleaved_ms"], k2["interleaved_ms"] = both["k1"], both["k2"]
    k2["same_bytes_ms"], k2["memcpy_same_bytes_ms"] = both["same_bytes"], both["memcpy_same_bytes"]


def run_loader(ds, device, decode, epochs: int, keep) -> tuple[int, float]:
    """Drive the port's image loader; ``keep(batch)`` sees each batch on
    the consumer thread.  Returns (batches, wall seconds to the last one)."""
    from repro_torch.data import CheckpointableSampler, build_image_loader

    pipe = build_image_loader(
        ds, batch_size=BATCH, hw=FRAME, device=device, device_decode=decode, epochs=epochs,
        sampler=CheckpointableSampler(len(ds), batch_size=BATCH, seed=0),
    )
    t0 = time.monotonic()
    n = 0
    with pipe.auto_stop():
        for batch in pipe:
            keep(batch["images"])
            n += 1
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return n, time.monotonic() - t0


def h2d_copy(dev: torch.device) -> dict:
    """One batch's host→device copy as ``DeviceTransfer._put`` makes it:
    from a pinned slab-shaped tensor, on a side stream, timed with CUDA
    events on that stream (median of TIMED_RUNS copies)."""
    host = torch.full((BATCH, *FRAME, 3), 7, dtype=torch.uint8, pin_memory=True)
    side = torch.cuda.Stream(dev)
    times = []
    for i in range(3 + TIMED_RUNS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(side):
            start.record(side)
            host.to(dev, non_blocking=True)
            end.record(side)
        end.synchronize()
        if i >= 3:
            times.append(start.elapsed_time(end))
    ms = statistics.median(times)
    return {"h2d_ms": ms, "h2d_gb_per_s": host.numel() / ms * 1e-6, "h2d_batch_bytes": host.numel()}


def phase_main(ds, dev: torch.device, summary: dict) -> None:
    from repro_torch.data.transfer import DeviceDecode
    from repro_torch.kernels import dequant_normalize as dn

    decode = DeviceDecode(MEAN, STD, out_hw=CROP, flip=True, crop=True, seed=0)
    host: list[torch.Tensor] = []
    n_host, _ = run_loader(ds, "cpu", decode, 2, host.append)

    card: list[torch.Tensor] = []
    dn.dequant_normalize_augment.launches = 0
    n_card, wall = run_loader(ds, dev, decode, 2, card.append)
    launches = dn.dequant_normalize_augment.launches

    worst = {"max_abs_err": 0.0, "mismatches": 0, "over_bar": 0}
    for got, want in zip(card, host):
        if got.device != dev or tuple(got.shape) != (BATCH, 3, *CROP):
            raise AssertionError(f"delivered {got.device} {tuple(got.shape)}")
        r = compare(got.cpu(), want)
        worst = {"max_abs_err": max(worst["max_abs_err"], r["max_abs_err"]),
                 "mismatches": worst["mismatches"] + r["mismatches"],
                 "over_bar": worst["over_bar"] + r["over_bar"], "bar": r["bar"]}
    expected = 2 * (FRAMES // BATCH)
    emit({"phase": "main", "frames": FRAMES, "hw": list(FRAME), "batch": BATCH, "out_hw": list(CROP),
          "batches": n_card, "cpu_batches": n_host, "k1_launches": launches,
          "slabs_pinned": n_card == expected,
          "pinned_rule": "on CUDA the transfer copies each slab batch from its pinned tensor and raises otherwise",
          "all_batches_vs_cpu_run": worst, "wall_s": wall, "images_per_s": n_card * BATCH / wall,
          "h2d_bytes": n_card * BATCH * FRAME[0] * FRAME[1] * 3, "loader_ms_per_batch": wall / n_card * 1e3,
          **h2d_copy(dev), "k1_ms": summary["dequant_normalize_augment"]["ms"],
          "reading": "images_per_s, the copy's time and h2d_bytes are not gates"})
    if n_card != expected or n_host != expected:
        raise AssertionError(f"delivered {n_card} (card) / {n_host} (cpu) batches, expected {expected}")
    if launches != n_card:
        raise AssertionError(f"K1 launched {launches} times for {n_card} batches")
    if worst["over_bar"]:
        raise AssertionError(f"{worst['over_bar']} decoded elements over the bar against the CPU run")
    summary["dequant_normalize_augment"]["launches"] = launches
    summary["dequant_normalize_augment"]["max_abs_err"] = max(
        summary["dequant_normalize_augment"]["max_abs_err"], worst["max_abs_err"])


class FailedRead:
    """``ds`` with ``read_bytes(failed)`` raising, every other read as ``ds``'s."""

    def __init__(self, ds, failed: int):
        self.ds, self.failed = ds, failed

    def __len__(self) -> int:
        return len(self.ds)

    def read_bytes(self, i: int):
        if i == self.failed:
            raise OSError(f"planted failed read of sample {i}")
        return self.ds.read_bytes(i)


def phase_loader_holes(ds, dev: torch.device, summary: dict) -> None:
    """The image loader at a batch of HOLES_BATCH, its default chunk of 16,
    over the first HOLES_FRAMES frames in order, ``DeviceDecode`` with flip
    and crop, and sample HOLES_FAILED's read failed: the slot binder binds
    a chunk's 16 slots, four slabs, before it hands a row on, and behind
    the hole each batch takes its last row from the next slab.  Until the
    slab ring counted that run-ahead the loader blocked for good here
    (ROADMAP F-ref-5).  The card's run drains on a thread within
    HOLES_LIMIT_S; its (HOLES_FRAMES - 1) // HOLES_BATCH batches must equal
    the same loader's CPU run (K1's plain version) bit for bit, and K1 must
    launch once a batch."""
    import threading

    from repro_torch.data import CheckpointableSampler, build_image_loader
    from repro_torch.data.transfer import DeviceDecode
    from repro_torch.kernels import dequant_normalize as dn

    def loader(device):
        return build_image_loader(
            FailedRead(ds, HOLES_FAILED), batch_size=HOLES_BATCH, hw=FRAME, device=device,
            sampler=CheckpointableSampler(HOLES_FRAMES, batch_size=1, shuffle=False),
            device_decode=DeviceDecode(MEAN, STD, out_hw=CROP, flip=True, crop=True, seed=0))

    def within_limit(pipe) -> list[torch.Tensor]:
        got: list[torch.Tensor] = []

        def run():
            with pipe.auto_stop():
                for batch in pipe:
                    got.append(batch["images"])

        reader = threading.Thread(target=run, daemon=True)
        reader.start()
        reader.join(timeout=HOLES_LIMIT_S)
        if reader.is_alive():
            pipe.stop()  # closes the arena, which wakes a blocked slot wait
            raise AssertionError(f"loader_holes: the loader blocked after {len(got)} batches")
        return got

    t0 = time.monotonic()
    host = within_limit(loader("cpu"))
    pipe = loader(dev)
    dn.dequant_normalize_augment.launches = 0
    card = within_limit(pipe)
    torch.cuda.synchronize()
    launches = dn.dequant_normalize_augment.launches
    stats = {s.name: s for s in pipe.stats()}
    want = (HOLES_FRAMES - 1) // HOLES_BATCH
    worst = max((compare(g.cpu(), w) for g, w in zip(card, host)), key=lambda r: (r["over_bar"], r["max_abs_err"]))
    row = {"phase": "loader_holes", "frames": HOLES_FRAMES, "batch": HOLES_BATCH, "chunk": 16,
           "failed_sample": HOLES_FAILED, "batches": len(card), "cpu_batches": len(host), "expected": want,
           "read_failed": stats["read"].num_failed, "num_slabs": stats["batch"].num_slabs,
           "slabs_in_flight": stats["batch"].slabs_in_flight, "k1_launches": launches,
           "shapes": sorted({str((b.device.type, tuple(b.shape))) for b in card}),
           "vs_cpu_run": worst, "seconds": time.monotonic() - t0}
    emit(row)
    if len(card) != want or len(host) != want or row["read_failed"] != 1:
        raise AssertionError(f"loader_holes: {len(card)} (card) / {len(host)} (cpu) batches and "
                             f"{row['read_failed']} failed reads, expected {want} and 1")
    if row["shapes"] != [str((dev.type, (HOLES_BATCH, 3, *CROP)))]:
        raise AssertionError(f"loader_holes: delivered {row['shapes']}")
    if launches != len(card):
        raise AssertionError(f"loader_holes: K1 launched {launches} times for {len(card)} batches")
    if worst["over_bar"] or worst["mismatches"]:
        raise AssertionError(f"loader_holes: K1 differs from its plain version's CPU run: {worst}")
    count_launches(summary, "loader_holes", {"dequant_normalize_augment": launches})
    summary["dequant_normalize_augment"]["max_abs_err"] = max(
        summary["dequant_normalize_augment"]["max_abs_err"], worst["max_abs_err"])


def phase_example(ds, dev: torch.device, summary: dict) -> None:
    """The uint8 wire without device_decode: the consumer decodes the raw
    batches it receives with ``ops.dequant_normalize``."""
    from repro_torch.kernels import dequant_normalize as dn
    from repro_torch.kernels import ops

    mean = torch.tensor(MEAN, device=dev)
    std = torch.tensor(STD, device=dev)
    pairs = []

    def keep(x: torch.Tensor) -> None:
        pairs.append((ops.dequant_normalize(x, mean, std), dn.dequant_normalize_plain(x, mean, std)))

    dn.dequant_normalize.launches = 0
    n, _ = run_loader(ds, dev, None, 1, keep)
    launches = dn.dequant_normalize.launches
    worst = max((compare(g, w) for g, w in pairs), key=lambda r: (r["over_bar"], r["max_abs_err"]))
    emit({"phase": "example", "batches": n, "k2_launches": launches, "vs_plain": worst})
    if launches < 1 or launches != n:
        raise AssertionError(f"K2 launched {launches} times for {n} batches")
    if worst["over_bar"]:
        raise AssertionError("K2 over the bar on delivered batches")
    summary["dequant_normalize"]["launches"] = launches
    summary["dequant_normalize"]["max_abs_err"] = max(
        summary["dequant_normalize"]["max_abs_err"], worst["max_abs_err"])


class Captioned:
    """The frames as a two-column source for a format-v2 pack: each frame's
    encoded image, and a short caption beside it."""

    schema_fields = ("image", "caption")

    def __init__(self, frames):
        self.frames = frames

    def __len__(self) -> int:
        return len(self.frames)

    @staticmethod
    def caption(i: int) -> bytes:
        return b"a synthetic photograph, frame %d of the shard phase" % i

    def read_fields(self, i: int, fields=None) -> dict:
        blobs = {"image": self.frames.read_bytes(i), "caption": self.caption(i)}
        return {f: blobs[f] for f in (fields or self.schema_fields)}


def shard_loader(ds, device, **kw):
    """``build_image_loader`` at ``main``'s geometry and decode over a shard
    dataset, with the shard-aware shuffle, 2 epochs."""
    from repro_torch.data import CheckpointableSampler, build_image_loader
    from repro_torch.data.transfer import DeviceDecode

    sampler = CheckpointableSampler(len(ds), batch_size=BATCH, seed=0, shard_sizes=ds.shard_sizes,
                                    shard_window=SHARD_WINDOW)
    return build_image_loader(
        ds, batch_size=BATCH, hw=FRAME, device=device, epochs=2, sampler=sampler,
        device_decode=DeviceDecode(MEAN, STD, out_hw=CROP, flip=True, crop=True, seed=0), **kw,
    )


def drain(pipe, keep, batches=None) -> list[float]:
    """Iterate ``batches`` (default: the pipeline itself) under the pipeline's
    auto-stop, ``keep(images)`` on each; returns each batch's arrival
    seconds after the start, the card synchronized at the end."""
    times, t0 = [], time.monotonic()
    with pipe.auto_stop():
        for batch in (pipe if batches is None else batches):
            keep(batch["images"])
            times.append(time.monotonic() - t0)
    torch.cuda.synchronize()
    return times


def shard_row(sub: str, times: list[float], launches: int, pipe, **extra) -> dict:
    stats = {st.name: st for st in pipe.stats()}
    n = len(times)
    return {"phase": "shards", "sub": sub, "batches": n, "k1_launches": launches,
            "images_per_s": n * BATCH / times[-1], "loader_ms_per_batch": times[-1] / n * 1e3,
            "wall_s": times[-1], "read_failed": stats["read"].num_failed,
            "slabs_in_flight": stats["batch"].slabs_in_flight, **extra}


def equal_batches(got: list[torch.Tensor], want: list[torch.Tensor], sub: str) -> None:
    if len(got) != len(want):
        raise AssertionError(f"shards {sub}: {len(got)} batches against {len(want)}")
    for j, (g, w) in enumerate(zip(got, want)):
        if g.device != w.device or not torch.equal(g, w):
            raise AssertionError(f"shards {sub}: batch {j} differs from (a)'s")


def phase_shards(ds, root: pathlib.Path, dev: torch.device, summary: dict) -> None:
    """The image path from the sharded record store, sub-phases (a)-(g)
    (their docstrings in ``shards_*``): ``main``'s frames packed into 6
    shards of 256 (about 50 MB each; the noise frames do not compress),
    read by mmap, over loopback HTTP, projected from a two-column pack,
    through a peer's warm cache and under the health monitor with injected
    read faults, each into K1 on the card; token documents from shards
    into ``build_lm_loader`` and ``Trainer.fit``; and the process-pool
    baseline into K2."""
    from repro_torch.data import ShardDataset, pack
    from repro_torch.data.shards.testing import serve_shards
    from repro_torch.kernels import dequant_normalize as dn

    k1 = dn.dequant_normalize_augment
    launches: dict[str, int] = {}
    t0 = time.monotonic()
    v1 = pack(ds, root / "shards", samples_per_shard=SHARD_SAMPLES)
    emit({"phase": "shards", "sub": "pack", "shards": v1.num_shards, "samples": len(v1),
          "bytes": sum(f.stat().st_size for f in (root / "shards").glob("*.rpshard")),
          "seconds": time.monotonic() - t0})
    v1.close()

    # (a) local: mmap views decoded into pinned slabs, every batch against a CPU run
    local = ShardDataset(root / "shards")
    host: list[torch.Tensor] = []
    drain(shard_loader(local, "cpu"), host.append)
    base: list[torch.Tensor] = []
    k1.launches = 0
    pipe = shard_loader(local, dev)
    times = drain(pipe, base.append)
    launches["local"] = k1.launches
    worst = {"max_abs_err": 0.0, "mismatches": 0}
    for got, want in zip(base, host):
        r = compare(got.cpu(), want)
        worst = {"max_abs_err": max(worst["max_abs_err"], r["max_abs_err"]),
                 "mismatches": worst["mismatches"] + r["mismatches"]}
    clean = shard_row("local", times, launches["local"], pipe, cpu_batches=len(host),
                      all_batches_vs_cpu_run=worst)
    emit(clean)
    local.close()
    expected = 2 * (FRAMES // BATCH)
    if len(base) != expected or len(host) != expected or worst["mismatches"]:
        raise AssertionError(f"shards local: {len(base)} / {len(host)} batches, {worst} against the CPU run")
    if launches["local"] != expected:
        raise AssertionError(f"shards local: K1 launched {launches['local']} times for {expected} batches")
    del host

    with serve_shards(root / "shards") as origin:
        b_ds = shards_http(origin, root, dev, base, launches)
        shards_peers(origin, b_ds, root, dev, base, launches)
        shards_guarded(origin, root, dev, launches, clean["slabs_in_flight"])
        b_ds.close()
    shards_projection(ds, root, dev, base, launches)
    del base
    summary["dequant_normalize_augment"]["launches"] += sum(launches.values())
    summary["dequant_normalize_augment"].setdefault("launches_by_path", {}).update(
        {f"shards {sub}": n for sub, n in launches.items()})
    shards_lm(root, dev)
    shards_baseline(root, dev, summary, clean["images_per_s"])
    emit({"phase": "shards", "sub": "done", "k1_launches": launches, "seconds": time.monotonic() - t0})


def shards_http(origin, root: pathlib.Path, dev, base: list, launches: dict):
    """(b) the shards over loopback HTTP into a prefetch cache of about two
    shards: every epoch misses and evicts.  Returns the open dataset, whose
    warm cache (d) serves."""
    from repro_torch.data import ShardDataset
    from repro_torch.kernels import dequant_normalize as dn

    ds = ShardDataset(origin.url, cache_dir=root / "cache_b", cache_bytes=SHARD_CACHE_BYTES)
    got: list[torch.Tensor] = []
    dn.dequant_normalize_augment.launches = 0
    pipe = shard_loader(ds, dev)
    times = drain(pipe, got.append)
    launches["http"] = dn.dequant_normalize_augment.launches
    pf = ds.prefetcher.stats()
    half = len(times) // 2
    emit(shard_row("http", times, launches["http"], pipe, cache_bytes=SHARD_CACHE_BYTES,
                   cold_epoch_s=times[half - 1], warm_epoch_s=times[-1] - times[half - 1],
                   prefetcher={key: pf[key] for key in ("hits", "misses", "evictions", "bytes_fetched",
                                                        "index_fetches", "range_fetches", "sparse_shards")},
                   origin_requests=origin.requests, origin_bytes_served=origin.bytes_served))
    equal_batches(got, base, "http")
    if launches["http"] != len(got):
        raise AssertionError(f"shards http: K1 launched {launches['http']} times for {len(got)} batches")
    if not pf["evictions"]:
        raise AssertionError("shards http: a cache of about two shards evicted nothing")
    return ds


def shards_peers(origin, warm, root: pathlib.Path, dev, base: list, launches: dict) -> None:
    """(d) (b)'s warm prefetcher served by a ``PeerShardServer``; a second
    rank reads the origin with that peer in front of it."""
    from repro_torch.data import PeerShardServer, ShardDataset
    from repro_torch.kernels import dequant_normalize as dn

    with PeerShardServer(warm.prefetcher) as peer:
        before = origin.requests
        ds = ShardDataset(origin.url, cache_dir=root / "cache_d", cache_bytes=SHARD_CACHE_BYTES,
                          peers=[peer.url])
        got: list[torch.Tensor] = []
        dn.dequant_normalize_augment.launches = 0
        pipe = shard_loader(ds, dev)
        times = drain(pipe, got.append)
        launches["peers"] = dn.dequant_normalize_augment.launches
        pf = ds.prefetcher.stats()
        served = peer.stats()
        ds.close()
    emit(shard_row("peers", times, launches["peers"], pipe,
                   tier={key: pf.get(f"source_{key}") for key in ("peer_hits", "peer_bytes", "origin_fetches",
                                                                    "origin_bytes", "peer_errors")},
                   origin_requests_this_rank=origin.requests - before,
                   peer_served={key: served[key] for key in ("requests", "misses", "served_whole",
                                                              "served_ranges", "bytes_served")}))
    equal_batches(got, base, "peers")
    if launches["peers"] != len(got):
        raise AssertionError(f"shards peers: K1 launched {launches['peers']} times for {len(got)} batches")
    if not pf.get("source_peer_hits"):
        raise AssertionError("shards peers: no read came from the peer")


def shards_guarded(origin, root: pathlib.Path, dev, launches: dict, clean_slabs: int) -> None:
    """(e) (b)'s loader under ``HealthMonitor.guard()`` (degrading by
    ``disable_verify``), reads failed by a seeded ``FaultInjectingStage``
    (1%: the same count every run), and a ``MetricsExporter`` scraped once
    over loopback after the 12th batch.  The holes must show as the read
    stage's failures, batches stay dense, and the drained loader holds as
    many slabs as (a)'s clean one."""
    import urllib.request

    from repro_torch.core import FaultInjectingStage, HealthMonitor, MetricsExporter, disable_verify
    from repro_torch.data import ShardDataset
    from repro_torch.kernels import dequant_normalize as dn

    ds = ShardDataset(origin.url, cache_dir=root / "cache_e", cache_bytes=SHARD_CACHE_BYTES)
    chaos = FaultInjectingStage(ds.read_bytes, seed=23, error_rate=0.01)
    ds.read_bytes = chaos
    pipe = shard_loader(ds, dev)
    exporter = MetricsExporter()
    exporter.add_pipeline(pipe, name="images")
    monitor = HealthMonitor(pipe, degraded_after_s=5.0, stalled_after_s=60.0,
                            actions=[disable_verify(ds.prefetcher)])
    shapes, scrape = set(), {}

    def keep(x: torch.Tensor) -> None:
        shapes.add((x.device.type, tuple(x.shape)))
        if keep.n == 11:  # mid-run, after the 12th batch
            with exporter.serve() as server:
                scrape["text"] = urllib.request.urlopen(server.url, timeout=30).read().decode()
        keep.n += 1

    keep.n = 0
    dn.dequant_normalize_augment.launches = 0
    times = drain(pipe, keep, monitor.guard(tick=0.5))
    launches["guarded"] = dn.dequant_normalize_augment.launches
    ds.close()
    errors = chaos.stats()["injected_errors"]
    families = sorted({line.split()[2] for line in scrape.get("text", "").splitlines() if line.startswith("# TYPE")})
    row = shard_row("guarded", times, launches["guarded"], pipe, injected_errors=errors,
                    clean_slabs_in_flight=clean_slabs, degrade_actions=monitor.applied_actions(),
                    shapes=sorted(str(sh) for sh in shapes), scrape_families=len(families),
                    scrape_has=[f for f in families if "shard_cache" in f or f.endswith("stage_items_out_total")])
    emit(row)
    want_batches = (2 * FRAMES - errors) // BATCH
    if not errors or row["read_failed"] != errors or row["batches"] != want_batches:
        raise AssertionError(f"shards guarded: {errors} injected, {row['read_failed']} failed reads, "
                             f"{row['batches']} batches (expected {want_batches})")
    if shapes != {(dev.type, (BATCH, 3, *CROP))}:
        raise AssertionError(f"shards guarded: delivered {shapes}")
    if launches["guarded"] != row["batches"]:
        raise AssertionError(f"shards guarded: K1 launched {launches['guarded']} times for {row['batches']} batches")
    if row["slabs_in_flight"] != clean_slabs:
        raise AssertionError(f"shards guarded: {row['slabs_in_flight']} slabs in flight after the drain, "
                             f"a clean run {clean_slabs}")
    for family in ("repro_stage_items_out_total", "repro_shard_cache_hits_total", "repro_arena_slabs_in_flight"):
        if family not in families:
            raise AssertionError(f"shards guarded: the scrape lacks {family}")


def shards_projection(ds, root: pathlib.Path, dev, base: list, launches: dict) -> None:
    """(c) the same frames packed as format v2 with an image and a caption
    column, read over HTTP with ``fields=("image",)``.  The image column is
    most of a shard, so the prefetcher's sparse threshold goes to 1.0 (a
    projected fetch then always pulls column ranges) and its sparse→full
    promotion is off (it fetches whole shards).  No caption byte may
    cross: every shard enters the cache as a projected sparse entry, no
    range the dataset fetched touches a caption cell, and the origin serves
    at most the shard files less their caption columns, plus the image
    bytes fetched twice: a demand read that races the prefetch of the same
    sample fetches it again and keeps one copy
    (``SparseShardReader._read_range``).  ``HttpShardSource`` logs every
    fetch while the phase runs, and the log's bytes must be the origin's."""
    from repro_torch.data import HttpShardSource, ShardDataset, pack
    from repro_torch.data.shards.testing import serve_shards
    from repro_torch.kernels import dequant_normalize as dn

    pack(Captioned(ds), root / "shards_v2", samples_per_shard=SHARD_SAMPLES, format_version=2).close()
    captions = sum(len(Captioned.caption(i)) for i in range(len(ds)))
    files = sum(f.stat().st_size for f in (root / "shards_v2").iterdir())
    fetched: list[tuple[str, int, int]] = []  # (file, start, length) of every HTTP fetch, the manifest's too
    fetch_range, fetch_whole = HttpShardSource.fetch_range, HttpShardSource.fetch

    def logged_range(self, name, start, length):
        data = fetch_range(self, name, start, length)
        fetched.append((name, start, len(data)))
        return data

    def logged_whole(self, name):
        data = fetch_whole(self, name)
        fetched.append((name, 0, len(data)))
        return data

    HttpShardSource.fetch_range, HttpShardSource.fetch = logged_range, logged_whole
    try:
        with serve_shards(root / "shards_v2") as origin:
            proj = ShardDataset(origin.url, fields=("image",), cache_dir=root / "cache_c")
            proj.prefetcher.sparse_threshold = 1.0
            proj.prefetcher.promote_threshold = None  # a sparse→full upgrade would fetch the caption column
            got: list[torch.Tensor] = []
            dn.dequant_normalize_augment.launches = 0
            pipe = shard_loader(proj, dev, fields=("image",))
            times = drain(pipe, got.append)
            launches["projection"] = dn.dequant_normalize_augment.launches
            pf = proj.prefetcher.stats()
            with origin.lock:
                served = origin.bytes_served
            proj.close()
    finally:
        HttpShardSource.fetch_range, HttpShardSource.fetch = fetch_range, fetch_whole
    wire = wire_bytes(fetched, {path.name: caption_cells(path) for path in (root / "shards_v2").glob("*.rpshard")})
    emit(shard_row("projection", times, launches["projection"], pipe, caption_bytes=captions,
                   files_bytes=files, origin_bytes_served=served, fetched=wire,
                   prefetcher={key: pf[key] for key in ("sparse_shards", "fields_requested", "bytes_fetched",
                                                        "bytes_skipped", "range_fetches", "index_fetches")}))
    equal_batches(got, base, "projection")
    if launches["projection"] != len(got):
        raise AssertionError(f"shards projection: K1 launched {launches['projection']} times for {len(got)} batches")
    if (pf["sparse_shards"] != FRAMES // SHARD_SAMPLES or wire["bytes"] != served or wire["caption_bytes"]
            or served - wire["fetched_twice"] > files - captions):
        raise AssertionError(f"shards projection: {pf['sparse_shards']} sparse shards, {served} bytes served "
                             f"of {files} ({captions} of them captions); fetched {wire}")


def caption_cells(path: pathlib.Path) -> list[tuple[int, int]]:
    """(start, end) file offsets of every caption cell of a v2 shard file."""
    from repro_torch.data.shards.format import open_shard_reader

    reader = open_shard_reader(path)
    try:
        cells = [reader.index.locate("caption", i)[:2] for i in range(reader.index.n_samples)]
    finally:
        reader.close()
    return [(off, off + length) for off, length in cells]


def wire_bytes(fetched: list[tuple[str, int, int]], captions: dict) -> dict:
    """What a log of (shard, start, length) fetches moved: its bytes, the
    bytes fetched more than once, and the caption bytes among them
    (``captions``: each shard's caption cells)."""
    out = {"fetches": len(fetched), "bytes": sum(n for *_, n in fetched), "fetched_twice": 0, "caption_bytes": 0}
    for shard in {name for name, *_ in fetched}:
        spans = sorted((start, start + n) for name, start, n in fetched if name == shard and n)
        merged: list[list[int]] = []
        for a, b in spans:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        out["fetched_twice"] += sum(b - a for a, b in spans) - sum(b - a for a, b in merged)
        out["caption_bytes"] += sum(max(0, min(b, d) - max(a, c)) for a, b in merged for c, d in captions.get(shard, ()))
    return out


def shards_lm(root: pathlib.Path, dev) -> None:
    """(f) token documents packed into shards and served over HTTP into
    ``build_lm_loader`` on the card: the first LM_BATCHES batches equal the
    same loader's CPU run over the in-memory documents; then ``Trainer.fit``
    takes 2 steps of Qwen3-0.6B at full width, cut to 2 layers, from the
    same pipeline."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import CheckpointableSampler, ShardDataset, SyntheticTokenDataset, build_lm_loader, pack
    from repro_torch.data.shards.testing import serve_shards
    from repro_torch.runtime import Trainer, TrainerConfig

    t0 = time.monotonic()
    cfg = dataclasses.replace(get_config("qwen3-0.6b"), num_layers=2)
    docs = SyntheticTokenDataset(LM_DOCS, vocab=cfg.vocab_size)
    shards = pack(docs, root / "docs", samples_per_shard=LM_DOCS // 4)

    def loader(ds, device):
        sampler = CheckpointableSampler(len(ds), batch_size=8, seed=0, shard_sizes=shards.shard_sizes,
                                        shard_window=SHARD_WINDOW)
        return build_lm_loader(ds, seq_len=TRAIN_SEQ, batch_size=TRAIN_BATCH, sampler=sampler, device=device)

    def first(it) -> list[dict]:
        return [{k: v.clone() for k, v in next(it).items()} for _ in range(LM_BATCHES)]

    pipe, _ = loader(docs, "cpu")
    with pipe.auto_stop():
        want = first(iter(pipe))
    with serve_shards(root / "docs") as origin, tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as ckpt:
        ds = ShardDataset(origin.url, cache_dir=root / "cache_f")
        pipe, sampler = loader(ds, dev)
        with pipe.auto_stop():
            t1 = time.monotonic()
            got = first(iter(pipe))
            load_s = time.monotonic() - t1
            trainer = Trainer(cfg, ShapeConfig("train_4k", TRAIN_SEQ, TRAIN_BATCH, "train"),
                              tcfg=TrainerConfig(ckpt_dir=ckpt, ckpt_every=10**9, log_every=1), device=dev)
            history = trainer.fit(pipe, steps=2, sampler=sampler)["history"]
            health = trainer.health()
        pf = ds.prefetcher.stats()
        ds.close()
    shards.close()
    same = all(g.keys() == w.keys() and all(torch.equal(g[k].cpu(), w[k]) for k in g) for g, w in zip(got, want))
    emit({"phase": "shards", "sub": "lm", "docs": LM_DOCS, "shards": shards.num_shards, "seq": TRAIN_SEQ,
          "batch": TRAIN_BATCH, "batches": len(got), "equal_to_cpu_in_memory": same,
          "devices": sorted({str(v.device) for g in got for v in g.values()}),
          "loader_ms_per_batch": load_s / len(got) * 1e3, "tokens_per_s_loader": len(got) * TRAIN_SEQ * TRAIN_BATCH / load_s,
          "arch": cfg.name, "layers": cfg.num_layers, "train_steps": len(history),
          "losses": [h["loss"] for h in history], "data_wait_frac": health["data_wait_frac"],
          "prefetcher": {key: pf[key] for key in ("hits", "misses", "bytes_fetched")},
          "k1_launches": 0, "reading": "data_wait_frac is a reading, not a gate", "seconds": time.monotonic() - t0})
    if not same or len(got) != LM_BATCHES or any(v.device.type != dev.type for g in got for v in g.values()):
        raise AssertionError("shards lm: the card's batches from shards differ from the CPU run in memory")
    if len(history) != 2 or not all(math.isfinite(h["loss"]) for h in history):
        raise AssertionError(f"shards lm: {len(history)} steps, losses {[h['loss'] for h in history]}")


def shards_baseline(root: pathlib.Path, dev, summary: dict, local_images_per_s: float) -> None:
    """(g) the paper's baseline: ``MPLoader``, 4 spawned worker processes,
    each unpickling (a)'s ``ShardDataset`` (and so importing the port and
    torch), batches pickled back over a pipe in order; the consumer copies
    each to the card and decodes it with ``ops.dequant_normalize`` (K2).
    One epoch; the first batch is held to K2's plain version."""
    from repro_torch.data import ShardDataset
    from repro_torch.data.baselines import MPLoader
    from repro_torch.kernels import dequant_normalize as dn
    from repro_torch.kernels import ops

    mean = torch.tensor(MEAN, device=dev)
    std = torch.tensor(STD, device=dev)
    ds = ShardDataset(root / "shards")
    loader = MPLoader(ds, batch_size=BATCH, hw=FRAME, num_workers=MP_WORKERS)
    dn.dequant_normalize.launches = 0
    n, check, times, t0 = 0, None, [], time.monotonic()
    for batch in loader:
        x = torch.from_numpy(batch).to(dev)
        y = ops.dequant_normalize(x, mean, std)
        if check is None:
            check = compare(y, dn.dequant_normalize_plain(x, mean, std))
        n += 1
        times.append(time.monotonic() - t0)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = dn.dequant_normalize.launches
    ds.close()
    emit({"phase": "shards", "sub": "baseline", "loader": "MPLoader", "workers": MP_WORKERS, "batches": n,
          "k2_launches": launches, "startup_s": loader.startup_s, "first_batch_s": times[0] if times else None,
          "images_per_s": n * BATCH / wall, "images_per_s_after_first": (n - 1) * BATCH / (wall - times[0]),
          "local_images_per_s": local_images_per_s,
          "loader_ms_per_batch": wall / n * 1e3, "wall_s": wall, "first_batch_vs_plain": check,
          "reading": "images_per_s beside (a)'s is a reading, not a gate"})
    if n != FRAMES // BATCH or launches != n:
        raise AssertionError(f"shards baseline: {n} batches, K2 launched {launches} times")
    if check["over_bar"]:
        raise AssertionError("shards baseline: K2 over the bar on the first batch")
    summary["dequant_normalize"]["launches"] += launches
    summary["dequant_normalize"].setdefault("launches_by_path", {})["shards baseline"] = launches


def within_tol(got: torch.Tensor, want: torch.Tensor, tols: dict = FA_TOL) -> dict:
    """|got - want| against ``tols[dtype]`` as atol and rtol, and bf16 ulps
    apart; taken a slice of 2**26 elements at a time, so that the f32
    copies of a long shape's outputs never stand whole beside them."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"shape/dtype {got.shape} {got.dtype} vs {want.shape} {want.dtype}")
    tol = tols[got.dtype]
    err = over = ulps = 0
    for g, w in zip(got.reshape(-1).split(1 << 26), want.reshape(-1).split(1 << 26)):
        if not torch.isfinite(g.float()).all():
            raise AssertionError("non-finite output")
        diff = (g.float() - w.float()).abs()
        err = max(err, float(diff.max()))
        over += int((diff > tol + tol * w.float().abs()).sum())
        if got.dtype == torch.bfloat16:
            ulps = max(ulps, int(bf16_ulp_steps(g, w).max()))
    row = {"max_abs_err": err, "bar": f"atol=rtol={tol}", "over_bar": over}
    if got.dtype == torch.bfloat16:
        row["max_bf16_ulps"] = ulps
    return row


def row_rel(got: torch.Tensor, want: torch.Tensor) -> dict:
    """The scale-aware bar beside FA_TOL: for each output row (the last
    dim: one query of one head), max |got - want| over max |want|; the
    largest over the rows, the query index of its row, and the rows over
    ``FA_ROW_REL``.  Taken 2**26 elements at a time."""
    hd, sq = got.shape[-1], got.shape[-2]
    rows_g, rows_w = got.reshape(-1, hd), want.reshape(-1, hd)
    step = max(1, (1 << 26) // hd)
    worst, at, over = 0.0, 0, 0
    for i in range(0, rows_g.shape[0], step):
        g, w = rows_g[i:i + step].float(), rows_w[i:i + step].float()
        rel = (g - w).abs().amax(dim=1) / w.abs().amax(dim=1).clamp_min(1e-30)
        k = int(rel.argmax())
        if float(rel[k]) > worst:
            worst, at = float(rel[k]), i + k
        over += int((rel > FA_ROW_REL).sum())
    return {"max_row_rel_err": worst, "worst_row_query": at % sq, "row_bar": FA_ROW_REL, "over_row_bar": over}


def causal_pairs(sq: int, skv: int, causal: bool) -> int:
    """(query, key) pairs the mask admits for one (batch, head): row i of q
    sees keys 0 .. i + skv - sq."""
    if not causal:
        return sq * skv
    return sq * (skv - sq + 1) + sq * (sq - 1) // 2


def k3_tiles(sq: int, skv: int, causal: bool, hd: int, block_k: int) -> dict:
    """What the bf16 kernel's loop bounds give for one (batch, head), on
    its own plan (``flash_attention.wgmma_plan``, read from the library):
    blocks of 128 query rows, two
    warpgroups of 64; key stages loaded (K and V each, up to the block's
    diagonal) and multiplied by a warpgroup (up to its own), and the share
    of those on a warpgroup's diagonal (masked element by element)."""
    from repro_torch.kernels.flash_attention import wgmma_plan

    plan = wgmma_plan(hd, block_k)
    rows, wg_rows, keys = plan["rows"], plan["warpgroup_rows"], plan["stage_keys"]
    per_step = block_k // keys  # a softmax step's stages, loaded and multiplied whole
    blocks = loaded = multiplied = diagonal = 0
    for q0 in range(0, sq, rows):
        blocks += 1
        last = min(q0 + rows, sq) - 1 + skv - sq
        loaded += (min(skv // block_k, last // block_k + 1) if causal else skv // block_k) * per_step
        for r0 in range(q0, min(q0 + rows, sq), wg_rows):
            first, wg_last = r0 + skv - sq, min(r0 + wg_rows, sq) - 1 + skv - sq
            n = (min(skv // block_k, wg_last // block_k + 1) if causal else skv // block_k) * per_step
            multiplied += n
            diagonal += sum(causal and k * keys + keys - 1 > first for k in range(n))
    return {"blocks": blocks, "stage_keys": keys, "ring_slots": plan["ring_slots"], "smem_bytes": plan["smem_bytes"],
            "kv_stages_loaded": loaded, "warpgroup_stages": multiplied, "diagonal_share": diagonal / multiplied}


def restart_positions(b: int, s: int, gen: torch.Generator) -> torch.Tensor:
    """(b, s) int32 rows of two packed prompts each, the second restarting at
    0 after a seeded split; the last row repeats every position instead
    (0, 0, 1, 1, ...).  The index mask gets every row wrong."""
    rows = []
    for _ in range(b - 1):
        k = int(torch.randint(1, s, (1,), generator=gen))
        rows.append(torch.cat([torch.arange(k), torch.arange(s - k)]))
    rows.append(torch.arange(s) // 2)
    return torch.stack(rows).to(torch.int32)


def position_pairs(q_pos: torch.Tensor, kv_pos: torch.Tensor) -> int:
    """(query, key) pairs the position mask admits, summed over the batch."""
    return int((q_pos[:, :, None] >= kv_pos[:, None, :]).sum())


LIBRARY_ATTENTION = ("torch.nn.functional.scaled_dot_product_attention(is_causal=True) on its fused backends, "
                     "enable_gqa where k has fewer heads")
# where q has fewer rows than k: the causal mask aligned at the bottom right, which SDPA dispatches to flash
LIBRARY_ATTENTION_RIGHT = ("torch.nn.functional.scaled_dot_product_attention(attn_mask=torch.nn.attention.bias."
                           "causal_lower_right(sq, skv)), enable_gqa where k has fewer heads")


def library_attention(q, k, v, causal: bool):
    """One PyTorch call for the same function (the yardstick; never on the
    port's path).  Where q has fewer rows than k (a window of a prefill in
    token windows) the causal mask is ``causal_lower_right``'s, query i at
    key i + skv - sq, as K3 aligns it; SDPA takes that mask to flash
    attention without building it.  SDPA may take only its fused backends
    (flash, memory-efficient, cuDNN): a shape they refuse raises rather
    than fall back to the math backend, whose scores at 32k keys would not
    fit the card."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from torch.nn.attention.bias import causal_lower_right

    sdpa = torch.nn.functional.scaled_dot_product_attention
    backends = [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION, SDPBackend.CUDNN_ATTENTION]
    gqa = q.shape[1] != k.shape[1]
    sq, skv = q.shape[2], k.shape[2]
    mask = {"attn_mask": causal_lower_right(sq, skv)} if causal and sq < skv else {"is_causal": causal}

    def call():
        with sdpa_kernel(backends):
            return sdpa(q, k, v, enable_gqa=gqa, **mask)
    return call


def phase_flash(dev: torch.device, summary: dict, card: str) -> None:
    """K3 against its plain version on the card, each case on the route its
    dtype picks (bf16: the tensor-core kernel, also held to FA_ROW_REL;
    f32: the CUDA-core kernel);
    times at the serving shape for both routes, with each kernel's ptxas
    registers and spills."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cpu").manual_seed(1)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [  # name, b, h, hkv, sq, skv, hd, dtype, causal, block_q, block_k
        ("main", 8, 16, 8, SERVE_PROMPT, SERVE_PROMPT, 128, bf16, True, 128, 128),
        ("f32", 8, 16, 8, SERVE_PROMPT, SERVE_PROMPT, 128, f32, True, 128, 128),
        ("noncausal", 8, 16, 8, SERVE_PROMPT, SERVE_PROMPT, 128, bf16, False, 128, 128),
        ("right_aligned", 8, 16, 8, 128, SERVE_PROMPT, 128, bf16, True, 128, 128),
        ("mha_hd64", 4, 8, 8, 256, 256, 64, bf16, True, 128, 128),
        ("hd32", 2, 4, 2, 256, 256, 32, bf16, True, 128, 128),  # Qwen3's smoke heads
        ("block_k64", 8, 16, 8, SERVE_PROMPT, SERVE_PROMPT, 128, bf16, True, 64, 64),
        ("block_k128_gqa4", 2, 8, 2, 384, 384, 64, bf16, True, 128, 128),  # 3 steps of 128 keys
        ("ragged_rows", 1, 4, 2, 96, 192, 128, bf16, True, 32, 64),  # sq not a multiple of 64 rows
        ("f32_hd64", 2, 8, 2, 384, 384, 64, f32, False, 128, 64),
        ("granite", 8, 16, 8, SERVE_PROMPT, SERVE_PROMPT, 64, bf16, True, 128, 128),  # Granite-MoE's prefill
        ("musicgen", 8, 24, 24, SERVE_PROMPT, SERVE_PROMPT, 64, bf16, True, 128, 128),  # MusicGen's: MHA, groups of 1
        ("jamba", 2, 64, 8, 128, 128, 128, bf16, True, 128, 128),  # Jamba's model_check prefill
        ("yi", 8, 32, 4, SERVE_PROMPT, SERVE_PROMPT, 128, bf16, True, 128, 128),  # Yi-6B's prefill: kv groups of 8
        ("olmo", 8, 16, 16, SERVE_PROMPT, SERVE_PROMPT, 128, bf16, True, 128, 128),  # OLMo-1B's: MHA
        # Jamba-1.5-large's and Qwen1.5-110B's serving prefill: 64 heads over 8 kv heads
        ("h64_kv8", 8, 64, 8, SERVE_PROMPT, SERVE_PROMPT, 128, bf16, True, 128, 128),
        # DeepSeek-V3's MLA prefill: 128 heads as kv groups of 1, q and k of
        # 128 + 64 rope dims, v of 128 zero-padded to 192
        ("mla", 8, 128, 128, SERVE_PROMPT, SERVE_PROMPT, 192, bf16, True, 128, 128),
        ("mla_f32", 8, 128, 128, SERVE_PROMPT, SERVE_PROMPT, 192, f32, True, 128, 128),
        ("mla_block_k64", 8, 128, 128, SERVE_PROMPT, SERVE_PROMPT, 192, bf16, True, 64, 64),  # one stage a step
        ("mla_ragged_rows", 1, 16, 16, 96, 192, 192, bf16, True, 32, 64),  # sq not a multiple of 64 rows
        # the position route (q_pos >= kv_pos) on restart positions: Qwen3's serving shape on both
        # kernels, block_k 64, MLA's head dim, and rows past sq with keys padded at INT32_MAX
        ("pos_main", 8, 16, 8, SERVE_PROMPT, SERVE_PROMPT, 128, bf16, True, 128, 128),
        ("pos_f32", 8, 16, 8, SERVE_PROMPT, SERVE_PROMPT, 128, f32, True, 128, 128),
        ("pos_block_k64", 8, 16, 8, SERVE_PROMPT, SERVE_PROMPT, 128, bf16, True, 64, 64),
        ("pos_mla", 2, 16, 16, 256, 256, 192, bf16, True, 64, 64),
        ("pos_ragged_rows", 2, 4, 2, 96, 192, 128, bf16, True, 32, 64),
        # a consumer warpgroup wholly past sq (sq an odd multiple of 64, as decode_32k's prefill of
        # 32,704 tokens): it multiplies nothing, empties the block's slots and stores no row
        ("wg_past_sq", 1, 4, 2, 192, 384, 128, bf16, True, 64, 64),
        ("wg_past_sq_hd32", 1, 2, 2, 192, 384, 32, bf16, True, 64, 64),
        ("wg_past_sq_one_block", 1, 2, 1, 64, 64, 64, bf16, True, 64, 64),
        ("pos_wg_past_sq", 1, 4, 2, 192, 384, 128, bf16, True, 64, 64),
        # the remaining (head dim, block_k, mask) corners of the bf16 kernel's instances
        ("hd32_block_k64", 2, 4, 2, 256, 256, 32, bf16, True, 64, 64),
        ("noncausal_hd32", 2, 4, 2, 256, 256, 32, bf16, False, 128, 128),
        ("noncausal_hd192", 2, 4, 2, 256, 256, 192, bf16, False, 128, 128),
        ("pos_hd64_block_k64", 2, 4, 2, 256, 256, 64, bf16, True, 64, 64),
        ("pos_hd192_block_k128", 2, 16, 16, 256, 256, 192, bf16, True, 128, 128),
    ]
    ptxas = _build.ptxas("flash_attention")
    entry = summary["flash_attention"]
    for name, b, h, hkv, sq, skv, hd, dtype, causal, bq, bk in cases:
        q, k, v = (torch.randn(shape, generator=gen).to(dev, dtype)
                   for shape in ((b, h, sq, hd), (b, hkv, skv, hd), (b, hkv, skv, hd)))
        if "mla" in name:
            v[..., MLA_V_DIM:] = 0  # mla_prefill's zero padding of v
        kw = {"causal": causal, "block_q": bq, "block_k": bk}
        if name.startswith("pos"):
            kv_pos = restart_positions(b, skv, gen)
            q_pos = kv_pos[:, :sq].clone()
            if sq < skv:  # keys past the prompt padded as _causal_flash pads them
                kv_pos[:, sq:] = 2**31 - 1
            kw.update(q_pos=q_pos.to(dev), kv_pos=kv_pos.to(dev))
        got = fa.flash_attention(q, k, v, **kw)
        want = fa.flash_attention_plain(q, k, v, **kw)
        sync(dev)
        row = {"phase": "kernels", "kernel": "flash_attention", "case": name, "q": [b, h, sq, hd],
               "kv": [b, hkv, skv, hd], "dtype": str(dtype), "causal": causal, "block_q": bq, "block_k": bk,
               "route": fa.kernel_route(dtype, hd, bk), **within_tol(got, want)}
        if dtype == bf16:
            row.update(row_rel(got, want))
        entry["max_abs_err"] = max(entry["max_abs_err"], row["max_abs_err"])
        if row["over_bar"] or row.get("over_row_bar"):
            emit(row)
            raise AssertionError(f"flash_attention {name}: {row['over_bar']} elements over FA_TOL, "
                                 f"{row.get('over_row_bar')} rows over FA_ROW_REL")
        if "mla" in name and got[..., MLA_V_DIM:].any():
            raise AssertionError(f"flash_attention {name}: the zero-padded v's output columns are not zero")
        if name.startswith("pos"):
            row["positions"] = "restart (two packed prompts a row, seeded split), last row repeated"
        if name in ("main", "f32", "granite", "musicgen", "yi", "olmo", "h64_kv8", "mla", "mla_f32", "mla_block_k64",
                    "pos_main", "pos_f32"):
            row["ms"] = time_ms(lambda: fa.flash_attention(q, k, v, **kw), flush)
            nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, got, kw.get("q_pos"), kw.get("kv_pos"))
                         if t is not None)
            pairs = (position_pairs(kw["q_pos"].cpu(), kw["kv_pos"].cpu()) if "q_pos" in kw
                     else causal_pairs(sq, skv, causal) * b)
            ops = 4 * hd * pairs * h
            row.update(bound(nbytes, ops, BF16_TC_OPS_PER_S if dtype == bf16 else F32_OPS_PER_S, card))
        if name in ("pos_main", "pos_f32"):  # beside the index route on the same q, k, v
            index_kw = {key: kw[key] for key in ("causal", "block_q", "block_k")}
            row["index_ms"] = time_ms(lambda: fa.flash_attention(q, k, v, **index_kw), flush)
            row["over_index"] = row["ms"] / row["index_ms"]
            row["over_bound"] = row["ms"] / row["bound_ms"]
        if name == "pos_main":
            row["plain_ms"] = time_ms(lambda: fa.flash_attention_plain(q, k, v, **kw), flush)
            # SDPA takes the position mask as a boolean (B, 1, Sq, Skv) tensor, built outside the timing
            keep = (kw["q_pos"][:, :, None] >= kw["kv_pos"][:, None, :])[:, None]
            sdpa = torch.nn.functional.scaled_dot_product_attention
            row["library_ms"] = time_ms(lambda: sdpa(q, k, v, attn_mask=keep, enable_gqa=True), flush)
            row["library"] = "scaled_dot_product_attention(attn_mask=q_pos >= kv_pos as bool (8,1,512,512), enable_gqa=True)"
            entry["by_position"] = {key: row[key] for key in ("ms", "index_ms", "plain_ms", "library_ms", "bound_ms",
                                                              "bound_by")}
        if name == "pos_f32":
            entry["by_position"].update(f32_ms=row["ms"], f32_index_ms=row["index_ms"])
        if name in ("main", "granite", "musicgen", "yi", "olmo", "h64_kv8", "mla"):
            row["plain_ms"] = time_ms(lambda: fa.flash_attention_plain(q, k, v, **kw), flush)
            if name == "mla":  # SDPA takes v's own 128 dims; its default scale is 1/sqrt(192), as K3's
                v_lib = v[..., :MLA_V_DIM].contiguous()
                row["library_ms"] = time_ms(library_attention(q, k, v_lib, causal), flush)
                row["library"] = f"{LIBRARY_ATTENTION}, on v (8,128,512,128)"
            else:
                row["library_ms"] = time_ms(library_attention(q, k, v, causal), flush)
                row["library"] = LIBRARY_ATTENTION
            row["over_library"] = row["ms"] / row["library_ms"]
            row["over_bound"] = row["ms"] / row["bound_ms"]
        if name in ("granite", "musicgen", "yi", "olmo", "h64_kv8", "mla"):
            entry[name] = {key: row[key] for key in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}
        if name == "musicgen":  # the instance its prefill runs
            instance = f"fa_wgmma_bf16<{hd},{bk},false>"
            row["ptxas"] = entry[name]["ptxas"] = {instance: ptxas.get(instance)}
        if name in ("mla_f32", "mla_block_k64"):
            entry["mla"][f"{name[4:]}_ms"] = row["ms"]
        if name == "main":
            row["wrapper_host_ms"] = host_ms(lambda: fa.flash_attention(q, k, v, **kw), dev)  # four tensor maps encoded
            row["ptxas"] = ptxas  # both kernels, each instantiation
            limit = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
            row["plans"] = {f"hd{d},block_k{n}": fa.wgmma_plan(d, n) for d in fa.TC_HEAD_DIMS for n in fa.TC_BLOCK_KS}
            for plan_name, plan in row["plans"].items():  # the kernel's own plan against the card's limit
                if not plan["smem_bytes"] <= plan["smem_max"] == limit:
                    raise AssertionError(f"flash_attention: plan {plan_name} {plan} against the card's {limit} bytes")
            per_head = k3_tiles(sq, skv, causal, hd, bk)
            staged = b * h * (per_head["kv_stages_loaded"] * 2 * per_head["stage_keys"] * hd + sq * hd) * q.element_size()
            row["tiles"] = {**per_head, "staged_bytes": staged, "staged_tb_per_s": staged / row["ms"] * 1e-9,
                            "note": "per (batch, head): blocks of 128 query rows (two warpgroups of 64), K+V stages "
                                    "of stage_keys keys loaded by TMA (kv_stages_loaded, each K and V) and multiplied "
                                    "by a warpgroup (warpgroup_stages); staged_bytes: q and every K/V tile the blocks "
                                    "copy in, whole call"}
            entry.update({key: row[key] for key in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                                                    "wrapper_host_ms")})
        emit(row)


def ssd_inputs(gen, b, l, h, p, g, n, dtype, dev):
    """The reference sweep's distributions: x ~ N(0, 1), dt = softplus(N(0, 1)),
    a = -exp(N(0, 1) / 2), b and c ~ N(0, 0.3^2); drawn on ``gen``'s device."""
    def normal(shape):
        return torch.randn(shape, generator=gen, device=gen.device)

    x = normal((b, l, h, p)).to(dev, dtype)
    dt = torch.nn.functional.softplus(normal((b, l, h))).to(dev)
    a = (-torch.exp(normal(h) * 0.5)).to(dev)
    bm = (normal((b, l, g, n)) * 0.3).to(dev, dtype)
    cm = (normal((b, l, g, n)) * 0.3).to(dev, dtype)
    return x, dt, a, bm, cm


def ssd_inputs_long_memory(gen, b, l, h, p, g, n, dtype, dev):
    """Heads that keep their state: per head, dt |a| log-uniform on [1e-6,
    1e-1] and a = -U[1, 16] (Mamba2's A init), dt = that over |a| times
    U[0.5, 1.5] a step (so some heads keep over half their state across
    50,000 steps); x ~ N(0, 1), b and c ~ N(0, 0.3^2).  Drawn on ``gen``'s
    device."""
    def uniform(shape):
        return torch.rand(shape, generator=gen, device=gen.device)

    rate = 10.0 ** (-6.0 + 5.0 * uniform(h))  # dt |a| per head
    a = -(1.0 + 15.0 * uniform(h))
    dt = (rate / -a) * (0.5 + uniform((b, l, h)))
    x = torch.randn((b, l, h, p), generator=gen, device=gen.device).to(dev, dtype)
    bm = (torch.randn((b, l, g, n), generator=gen, device=gen.device) * 0.3).to(dev, dtype)
    cm = (torch.randn((b, l, g, n), generator=gen, device=gen.device) * 0.3).to(dev, dtype)
    return x, dt.to(dev), a.to(dev), bm, cm


def ssd_rel(y, want_y, h_final, want_h, chunk: int) -> dict:
    """The scale-aware bars beside SSD_TOL: max |got - want| over max |want|
    of y in each (batch, head, chunk) and of h_final in each (batch, head);
    the largest of each, where, and how many are over ``SSD_CHUNK_REL`` and
    ``SSD_STATE_REL``.  y is taken 2**26 elements at a time."""
    b, l, h, p = y.shape
    step = max(1, (1 << 26) // (b * chunk * h * p)) * chunk
    worst, at, over = 0.0, None, 0
    for l0 in range(0, l, step):
        l1 = min(l, l0 + step)
        g = y[:, l0:l1].float().reshape(b, -1, chunk, h, p)
        w = want_y[:, l0:l1].float().reshape(b, -1, chunk, h, p)
        rel = (g - w).abs().amax(dim=(2, 4)) / w.abs().amax(dim=(2, 4)).clamp_min(1e-30)  # (b, chunks, h)
        k = int(rel.argmax())
        if float(rel.reshape(-1)[k]) > worst:
            bi, ci, hi = np.unravel_index(k, tuple(rel.shape))
            worst, at = float(rel.reshape(-1)[k]), [int(bi), int(ci) + l0 // chunk, int(hi)]
        over += int((rel > SSD_CHUNK_REL).sum())
    srel = (h_final.float() - want_h.float()).abs().amax(dim=(2, 3)) / want_h.float().abs().amax(dim=(2, 3)).clamp_min(1e-30)
    return {"max_chunk_rel_err": worst, "worst_batch_chunk_head": at, "chunk_bar": SSD_CHUNK_REL,
            "over_chunk_bar": over, "max_state_rel_err": float(srel.max()), "state_bar": SSD_STATE_REL,
            "over_state_bar": int((srel > SSD_STATE_REL).sum())}


def k4_blocks(b: int, l: int, h: int, chunk: int, dtype: torch.dtype, dev: torch.device) -> dict:
    """The segments a (batch, head) is split into and each pass's blocks, as
    the wrapper plans them (bf16; the f32 kernel is one block a (batch,
    head))."""
    from repro_torch.kernels import ssd_scan as ks

    sms = torch.cuda.get_device_properties(dev).multi_processor_count if dev.type == "cuda" else 132
    s = ks.segment_plan(b, h, l // chunk, sms) if dtype == torch.bfloat16 else 1
    return {"segments": s, "blocks": {"pass_a": b * h * (s - 1), "pass_b": b * h * s}}


# phase_ssd's cases, in the order they draw from its generator: name, (b, l, h, p, g, n), chunk, dtype, draw
SSD_CASES = [
    ("main", (SERVE_BATCH, SERVE_PROMPT, 48, 64, 1, 128), 256, torch.bfloat16, ssd_inputs),
    ("f32", (SERVE_BATCH, SERVE_PROMPT, 48, 64, 1, 128), 256, torch.float32, ssd_inputs),
    ("g2", (2, 256, 4, 64, 2, 32), 64, torch.bfloat16, ssd_inputs),
    ("g2_f32", (2, 256, 4, 64, 2, 32), 64, torch.float32, ssd_inputs),
    ("g4", (1, 256, 4, 64, 4, 128), 128, torch.bfloat16, ssd_inputs),
    ("g4_f32", (1, 256, 4, 64, 4, 128), 128, torch.float32, ssd_inputs),
    ("ragged_chunk40", (2, 40, 4, 64, 1, 128), 40, torch.bfloat16, ssd_inputs),
    ("ragged_chunk4", (2, 300, 4, 64, 1, 128), 4, torch.bfloat16, ssd_inputs),
    ("p48_n48", (1, 192, 3, 48, 1, 48), 96, torch.bfloat16, ssd_inputs),
    ("p16_n112_g2", (1, 300, 2, 16, 2, 112), 100, torch.bfloat16, ssd_inputs),
    ("jamba", (2, 128, 256, 64, 8, 128), 128, torch.bfloat16, ssd_inputs),  # Jamba's model_check prefill
    ("long_memory_serving", (SERVE_BATCH, SERVE_PROMPT, 48, 64, 1, 128), 256, torch.bfloat16,
     ssd_inputs_long_memory),
    # 100 chunks of 256 in 8 segments of 12-13 on an H100's 132 SMs
    ("long_memory_segments", (1, 25600, 48, 64, 1, 128), 256, torch.bfloat16, ssd_inputs_long_memory),
    # 100 chunks of 40 in 15 segments
    ("long_memory_ragged", (2, 4000, 4, 64, 1, 128), 40, torch.bfloat16, ssd_inputs_long_memory),
    # the same at d_state 64: one state panel, which only the second warpgroup folds and stores
    ("long_memory_n64", (2, 4000, 4, 64, 1, 64), 40, torch.bfloat16, ssd_inputs_long_memory),
]


def ssd_ops(b: int, l: int, h: int, p: int, n: int, chunk: int) -> int:
    """Multiply-adds x 2 of the scan over the lower triangle of each chunk:
    C.B^T and S.x on the i >= j pairs, C.h^T and the state update whole."""
    pairs = chunk * (chunk + 1) // 2
    per_chunk = 2 * pairs * n + 2 * pairs * p + 2 * chunk * n * p + 2 * chunk * p * n
    return b * h * (l // chunk) * per_chunk


def phase_ssd(dev: torch.device, summary: dict, card: str) -> None:
    """K4 against its plain version on the card, each case on the route its
    dtype picks (bf16: the wgmma kernel; f32: the CUDA-core kernel), held to
    SSD_TOL and the scale-aware bars (``ssd_rel``); times at the serving
    shape (Mamba2-780m, batch 8, prompt 512: chunk 256, 48 heads of 64, one
    group of d_state 128) for both routes, with each kernel's ptxas
    registers and spills.  The ragged cases scan in the chunks
    ``models.ssm.scan_chunk`` picks for prompts of 40 and 300 tokens (40 and
    4), neither a multiple of 64.  The ``long_memory_*`` cases draw heads
    that keep their state (``ssd_inputs_long_memory``): at the serving
    shape, at a shape whose chunks the bf16 kernel splits into segments
    that do not divide them, and so in a ragged chunk at d_state 128 and 64.
    Each row carries the
    segments a (batch, head) is split into and each pass's blocks."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import ssd_scan as ks

    gen = torch.Generator(device="cpu").manual_seed(4)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    ptxas = _build.ptxas("ssd_scan")
    entry = summary["ssd_scan"]
    for name, shape, chunk, dtype, draw in SSD_CASES:
        args = draw(gen, *shape, dtype, dev)
        y, h_final = ks.ssd_scan(*args, chunk=chunk)
        want_y, want_h = ks.ssd_scan_plain(*args, chunk=chunk)
        sync(dev)
        on_y, on_h = within_tol(y, want_y, SSD_TOL), within_tol(h_final, want_h, SSD_TOL)
        if dtype == torch.bfloat16:  # near 0 the ulps are many and atol decides: also count them above atol
            big = want_y.float().abs() >= SSD_TOL[dtype]
            on_y["max_bf16_ulps_above_atol"] = int(bf16_ulp_steps(y[big], want_y[big]).max()) if big.any() else 0
        b, l, h, p, g, n = shape
        row = {"phase": "kernels", "kernel": "ssd_scan", "case": name, "b_l_h_p_g_n": list(shape),
               "chunk": chunk, "dtype": str(dtype), "draw": draw.__name__, "route": ks.kernel_route(dtype, p, n),
               **k4_blocks(b, l, h, chunk, dtype, dev), "y": on_y, "h_final": on_h,
               "scale_aware": ssd_rel(y, want_y, h_final, want_h, chunk),
               "max_abs_err": max(on_y["max_abs_err"], on_h["max_abs_err"])}
        entry["max_abs_err"] = max(entry["max_abs_err"], row["max_abs_err"])
        if name.startswith("long_memory_") and name != "long_memory_serving" and (
                row["segments"] < 2 or (l // chunk) % row["segments"] == 0):
            emit(row)
            raise AssertionError(f"ssd_scan {name}: {row['segments']} segments do not split {l // chunk} chunks unevenly")
        if on_y["over_bar"] or on_h["over_bar"] or row["scale_aware"]["over_chunk_bar"] or \
                row["scale_aware"]["over_state_bar"]:
            emit(row)
            raise AssertionError(f"ssd_scan {name}: elements over the bar")
        if name in ("main", "f32"):
            row["ms"] = time_ms(lambda: ks.ssd_scan(*args, chunk=chunk), flush)
            nbytes = sum(t.numel() * t.element_size() for t in (*args, y, h_final))
            ops = ssd_ops(b, l, h, p, n, chunk)
            row.update(bound(nbytes, ops, BF16_TC_OPS_PER_S if dtype == torch.bfloat16 else F32_OPS_PER_S, card))
            row["over_bound"] = row["ms"] / row["bound_ms"]
        if name == "main":
            row["plain_ms"] = time_ms(lambda: ks.ssd_scan_plain(*args, chunk=chunk), flush)
            row["library_ms"] = None
            row["f32_cores_ms"] = ops / F32_OPS_PER_S * 1e3  # where products on the CUDA cores in f32 would stop
            row["ptxas"] = ptxas  # both kernels, each instantiation
            row["wrapper_host_ms"] = host_ms(lambda: ks.ssd_scan(*args, chunk=chunk), dev)
            # batch 1: 48 (batch, head) pairs, fewer than the SMs, so the kernel splits each one's two
            # chunks into two segments (the main case's 384 pairs are 2.9 waves of one block an SM)
            one = tuple(t[:1] if t.dim() > 1 else t for t in args)
            row["batch1_ms"] = time_ms(lambda: ks.ssd_scan(*one, chunk=chunk), flush)
            row["batch1_segments"] = k4_blocks(1, l, h, chunk, dtype, dev)["segments"]
            entry.update({key: row[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by", "segments")})
        emit(row)


def _rel_err(got: torch.Tensor, want: torch.Tensor, what: str) -> float:
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {tuple(got.shape)} vs {tuple(want.shape)}")
    got, want = got.float().cpu(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: non-finite values")
    return float((got - want).abs().max() / want.abs().max())


def condition_attention(cfg, params: dict) -> dict:
    """``params`` with each attention block's ``wq`` and ``wk`` scaled, in
    place, as if drawn at fan-in d_model: by sqrt(heads / d_model) and
    sqrt(kv_heads / d_model); and each MLA block's ``w_uq`` and ``w_uk``
    (the MTP block's too) as if drawn at fan-in over their latent rank: by
    sqrt(heads / q_lora_rank) and sqrt(heads / kv_lora_rank), for
    DeepSeek-V3 sqrt(128/1536) and sqrt(128/512).  The reference's init
    draws them with fan-in over the heads dim (16 and 8 for Granite, 128
    for DeepSeek), so without qk_norm a score has a wide spread (about 90
    for Granite) and attention is nearly one-hot: any rounding moves the
    weights of near-tied keys far, in the card's run and the CPU's alike,
    and a card-against-CPU check then measures that and not the port.  The
    checks compare the port with itself, so they run on weights where it
    is well conditioned."""
    h, kv, d = cfg.num_heads, cfg.num_kv_heads, cfg.d_model
    scale = {"wq": (h / d) ** 0.5, "wk": (kv / d) ** 0.5}
    if cfg.mla is not None:
        scale = {"w_uq": (h / cfg.mla.q_lora_rank) ** 0.5, "w_uk": (h / cfg.mla.kv_lora_rank) ** 0.5}
    mixers = [blk["mixer"] for seg in params["segments"] for blk in seg["blocks"]]
    if "mtp" in params:
        mixers.append(params["mtp"]["block"]["mixer"])
    for mixer in mixers:
        for name, factor in scale.items():
            if name in mixer:
                mixer[name].mul_(factor)
    return params


def draw_zero_leaves(params: dict, seed: int) -> dict:
    """``params`` (on any device) with the leaves the reference initialises
    to zeros drawn in place by ``tests/torch_parity.py``'s
    ``draw_zero_leaves``, the values the CPU tests give both packages; what
    was drawn."""
    import torch_parity
    from repro_torch.tree import tree_items

    torch_parity.draw_zero_leaves(params, seed)
    names = sorted({path.split("'")[-2] for path, _ in tree_items(params)} & set(torch_parity.ZERO_LEAVES))
    return {"leaves": names, "seed": seed, "std": torch_parity.ZERO_LEAF_STD, "by": "torch_parity.draw_zero_leaves"}


def conditioned_weights(cfg) -> str:
    if cfg.mla is not None:
        return "seed 0, w_uq/w_uk at fan-in q_lora_rank/kv_lora_rank (condition_attention)"
    return "seed 0, wq/wk at fan-in d_model (condition_attention)"


def moe_layers(cfg) -> int:
    return sum(is_moe for _, is_moe in cfg.layer_plan())


def prompt_batch(cfg, b: int, s: int, gen: torch.Generator) -> dict:
    """Seeded prefill inputs for ``cfg``: token ids (b, s), or (b, s,
    n_codebooks) codebook ids for MusicGen; a vision-prefix config also
    gets ``vis_embed`` (b, vis_prefix_len, d_model), bf16 N(0, 1), which
    the model splices over the first positions."""
    shape = (b, s, cfg.n_codebooks) if cfg.n_codebooks > 1 else (b, s)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, shape, generator=gen)}
    if cfg.vis_prefix_len:
        batch["vis_embed"] = torch.randn((b, cfg.vis_prefix_len, cfg.d_model), generator=gen).to(torch.bfloat16)
    return batch


def serve_run(model, params, batch: dict, forced, device, vocab: int, replay: list | None = None) -> dict:
    """A prefill of ``batch`` (``tokens``, and ``vis_embed`` for a
    vision-prefix config) then one decode step a row of ``forced`` on
    ``device``: the logits (vocab columns), the prefill cache (a copy), the
    final cache, and each MoE layer's router probabilities and expert
    choices in call order (``replay``: another run's choices to take)."""
    import route_check
    from repro_torch.tree import tree_map

    s, steps = batch["tokens"].shape[1], forced.shape[0]
    with route_check.RouteRecorder(replay) as routes:
        logits, cache = model.prefill(params, {k: v.to(device) for k, v in batch.items()}, seq_cap=s + steps)
        out = {"logits": [logits[..., :vocab]], "prefill_cache": tree_map(lambda t: t.clone(), cache)}
        for t in range(steps):
            logits, cache = model.decode_step(params, cache, forced[t].to(device), s + t)
            out["logits"].append(logits[..., :vocab])
    out["final_cache"], out["probs"], out["idx"] = cache, routes.probs, routes.idx
    return out


def output_errors(got: dict, want: dict) -> dict:
    """Each output of ``serve_run`` (logits, every cache entry), its
    largest |got - want| over the largest |want|."""
    worst: dict[str, float] = {}

    def note(what, g, w):
        worst[what] = max(worst.get(what, 0.0), _rel_err(g, w, what))

    for call, (g, w) in enumerate(zip(got["logits"], want["logits"])):
        note("prefill_logits" if call == 0 else "decode_logits", g, w)
    for when in ("prefill", "final"):
        for seg, want_seg in zip(got[f"{when}_cache"], want[f"{when}_cache"]):
            for blk, want_blk in zip(seg["blocks"], want_seg["blocks"]):
                for name in blk:
                    note(f"{when}_cache_{name}", blk[name], want_blk[name])
    return worst


def route_row(cfg, want: list, got: list, diffs: list | None = None) -> dict:
    """Every (token, MoE layer) whose choice differs between two runs'
    records (``diffs``, default ``route_check.compare`` of them), with the
    gap bar of the runs' dtype, and the largest difference of the two
    runs' router probabilities."""
    import route_check

    diffs = route_check.compare(cfg, want, got) if diffs is None else diffs
    row = route_check.summary(diffs, sum(p.shape[0] * p.shape[1] for p in want))
    row["swap_gap_bar"] = SWAP_GAP_F32 if cfg.dtype == "float32" else SWAP_GAP
    row["probs_max_abs_diff"] = max((float(np.abs(a - b).max()) for a, b in zip(want, got)), default=0.0)
    return row


def phase_model_check(dev: torch.device, arch: str, seq: int, phase: str = "model_check",
                      dtype: str | None = None, conditioned: bool = False, layers: int = 2,
                      restart: bool = False, drawn: int | None = None) -> None:
    """``arch`` at full width, ``layers`` layers (2 by default, for the CPU
    run's sake), in its own dtype or ``dtype``: the port on the card
    against the same model and weights on the CPU, prefill of ``seq``
    tokens (``prompt_batch``: MusicGen's (2, seq, 4) codebook ids,
    InternVL2's vision prefix over the first 256 of them) then 4 forced
    decode steps, logits and every cache entry (k/v of attention blocks, the ssm
    state and conv window of SSD blocks), each within MODEL_REL (bf16) or
    TRAIN_F32_REL (f32, TF32 off) of its largest CPU value.  The card's
    prefill launches one kernel a layer, K3 for attention and K4 for SSD,
    counted (MLA's prefill is K3 too).  With ``conditioned`` the seed-0
    weights go through ``condition_attention`` first, on both sides.

    MoE layers route discretely (``tools/route_check.py``): the CPU runs
    first and records each layer's expert choices, and the card replays
    them, so a near-tie that rounding breaks the other way cannot move
    other tokens' outputs.  The card's own choices are compared with the
    CPU's and every (token, layer) that differs is printed with the CPU's
    gap between its k-th and (k+1)-th probability: a swap at a gap over
    SWAP_GAP (bf16) or SWAP_GAP_F32 (f32) fails.

    With ``restart`` the prompts carry ``restart_positions``, which RoPE
    rotates by and K3 masks by (its position route).  With ``drawn`` the
    leaves the reference initialises to zeros (QKV biases, the SSD block's
    conv bias, A_log and dt_bias, LayerNorm's bias) are drawn from that
    seed by ``tests/torch_parity.py``'s ``draw_zero_leaves``, on both
    sides."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention, ssd_scan
    from repro_torch.models import Model
    from repro_torch.tree import tree_map

    cfg = dataclasses.replace(get_config(arch), num_layers=layers, **({"dtype": dtype} if dtype else {}))
    bar = TRAIN_F32_REL if cfg.dtype == "float32" else MODEL_REL
    model = Model(cfg)
    b, s, steps = 2, seq, 4
    rng = torch.Generator(device="cpu").manual_seed(2)
    batch = prompt_batch(cfg, b, s, rng)
    if restart:
        batch["positions"] = restart_positions(b, s, rng)
    forced = torch.randint(0, cfg.vocab_size, (steps, *batch["tokens"][:, :1].shape), generator=rng)
    t0 = time.monotonic()
    with torch.inference_mode():
        params = model.init(seed=0, device=dev)
        if conditioned:
            condition_attention(cfg, params)
        if drawn is not None:
            drawn_row = draw_zero_leaves(params, drawn)
        host_params = tree_map(lambda t: t.cpu(), params)
        cpu = serve_run(model, host_params, batch, forced, torch.device("cpu"), cfg.vocab_size)
        del host_params
        cpu_s = time.monotonic() - t0
        _zero_kernel_launches()
        card = serve_run(model, params, batch, forced, dev, cfg.vocab_size, cpu["idx"] if moe_layers(cfg) else None)
        sync(dev)
        launches = {"flash_attention": flash_attention.flash_attention.launches,
                    "ssd_scan": ssd_scan.ssd_scan.launches}
        del params
        worst = output_errors(card, cpu)
    row = {"phase": phase, "arch": cfg.name, "layers": cfg.num_layers, "d_model": cfg.d_model,
           "batch": b, "seq": s, "decode_steps": steps, "dtype": cfg.dtype, "prefill_launches": launches,
           "weights": conditioned_weights(cfg) if conditioned else "seed 0",
           **({"drawn": drawn_row} if drawn is not None else {}),
           **({"positions": "restart_positions: two packed prompts a row, the last row repeated"} if restart else {}),
           "params": model.param_count(), "max_rel_err_vs_cpu": worst,
           "bar": f"max |card - cpu| <= {bar} * max |cpu|", "cpu_seconds": cpu_s, "seconds": time.monotonic() - t0}
    if moe_layers(cfg):
        row["routes"] = route_row(cfg, cpu["probs"], card["probs"])
        row["routes"]["note"] = "the card replays the CPU's choices; these are the card's own that differ"
    emit(row)
    over = {k: v for k, v in worst.items() if v > bar}
    if over:
        raise AssertionError(f"{phase} {arch} over the bar: {over}")
    if moe_layers(cfg) and row["routes"]["max_swap_gap"] > row["routes"]["swap_gap_bar"]:
        raise AssertionError(f"{phase} {arch}: a route swapped at a gap of {row['routes']['max_swap_gap']}")
    want_launches = prefill_launches(cfg)
    if launches != want_launches:
        raise AssertionError(f"{phase} {arch}: the prefill launched {launches}, expected {want_launches}")


def moe_grad_check(cfg, host_p: dict, card_p: dict, x: torch.Tensor, routes: list) -> dict:
    """The gradients of sum(y * dy) + aux by x and each expert leaf, the
    card (replaying ``routes``) against the CPU: each leaf's largest
    difference over its largest |CPU value|."""
    import route_check
    from repro_torch.models import moe

    dy = torch.randn(x.shape, generator=torch.Generator().manual_seed(8))
    grads = {}
    for where, p in (("cpu", host_p), ("card", card_p)):
        dev = p["router"].device
        leaves = {"x": x.to(dev).requires_grad_(), **{k: v.detach().requires_grad_() for k, v in p.items()}}
        with route_check.RouteRecorder(routes if where == "card" else None):
            y, aux = moe.apply_moe(cfg, {k: v for k, v in leaves.items() if k != "x"}, leaves["x"])
            g = torch.autograd.grad((y * dy.to(dev)).sum() + aux, list(leaves.values()))
        grads[where] = dict(zip(leaves, g))
    return {k: _rel_err(grads["card"][k], grads["cpu"][k], k) for k in grads["cpu"]}


def phase_moe(dev: torch.device, card: str) -> None:
    """``apply_moe`` at Granite-MoE-1B-A400M's prefill shape (batch 8,
    prompt 512: x (8, 512, 1024), 32 experts, top 8, capacity 160), seeded
    weights and input, on the card against the same call on the CPU, the
    card replaying the CPU's expert choices (``phase_model_check`` says
    why).  f32 with TF32 off: y within TRAIN_F32_REL of its largest value,
    aux within 1e-6 of its value.  bf16: y within MODEL_REL.  Every
    (token) whose own choice on the card differs is printed; a swap at a gap
    over SWAP_GAP_F32 (f32) or SWAP_GAP (bf16) fails.  f32 also holds the
    gradients of x and every expert leaf within TRAIN_F32_REL.
    One prefill-shaped and one decode-shaped (x (8, 1, 1024), capacity 4)
    call run under ``torch.cuda.set_sync_debug_mode("error")``: any host
    sync in the layer fails the phase.  Readings: ms a call, the expert
    products' FLOPs and their bound on the bf16 tensor cores, the dispatch
    buffer's bytes."""
    from repro_torch.configs import get_config
    import route_check
    from repro_torch.models import moe
    from repro_torch.models.params import init_params
    from repro_torch.tree import tree_map

    base = get_config("granite-moe-1b-a400m")
    m = base.moe
    b, s, d = SERVE_BATCH, SERVE_PROMPT, base.d_model
    cap = moe.capacity_per_seq(base, s)
    x32 = torch.randn((b, s, d), generator=torch.Generator().manual_seed(7))
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    row = {"phase": "moe", "arch": base.name, "x": [b, s, d], "experts": m.n_experts, "top_k": m.experts_per_token,
           "d_expert": m.d_expert, "capacity": cap}
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(base, dtype=dtype)
        host_p = init_params(moe.moe_defs(cfg), seed=7, device="cpu")
        card_p = tree_map(lambda t: t.to(dev), host_p)
        x = x32.to(torch.bfloat16 if dtype == "bfloat16" else torch.float32)
        with torch.inference_mode():
            with route_check.RouteRecorder() as want_routes:
                want_y, want_aux = moe.apply_moe(cfg, host_p, x)
            with route_check.RouteRecorder(replay=want_routes.idx) as got_routes:
                y, aux = moe.apply_moe(cfg, card_p, x.to(dev))
        diffs = route_check.differences(cfg, want_routes.probs[0], got_routes.probs[0])
        res = {**route_row(cfg, want_routes.probs, got_routes.probs, diffs), "y_rel_err": _rel_err(y, want_y, "y"),
               "aux": {"card": float(aux), "cpu": float(want_aux)}}
        if dtype == "float32":
            res["grad_rel_err"] = moe_grad_check(cfg, host_p, card_p, x, want_routes.idx)
        row[dtype] = res
        aux_ok = dtype == "bfloat16" or abs(float(aux) - float(want_aux)) <= 1e-6 * abs(float(want_aux))
        if dtype == "float32" and max(res["grad_rel_err"].values()) > TRAIN_F32_REL:
            aux_ok = False
        if (res["y_rel_err"] > (TRAIN_F32_REL if dtype == "float32" else MODEL_REL) or not aux_ok
                or res["max_swap_gap"] > res["swap_gap_bar"]):
            emit(row)
            raise AssertionError(f"moe {dtype}: card against CPU over the bar")
    x = x32.to(dev, torch.bfloat16)
    sync(dev)
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.inference_mode():
            moe.apply_moe(cfg, card_p, x)
            moe.apply_moe(cfg, card_p, x[:, :1])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    row["host_syncs"] = "none: a prefill- and a decode-shaped call under set_sync_debug_mode('error')"
    with torch.inference_mode():
        row["ms"] = time_ms(lambda: moe.apply_moe(cfg, card_p, x), flush)
    flops = 2 * b * m.n_experts * cap * d * m.d_expert * 3
    row["expert_flops"] = flops
    row["expert_tc_bound_ms"] = flops / BF16_TC_OPS_PER_S * 1e3
    row["dispatch_bytes"] = b * m.n_experts * cap * d * x.element_size()
    row.update({"card": card, "peaks_for": PEAKS_FOR,
                "reading": "ms, expert_flops and dispatch_bytes are readings; bf16 is the config's dtype"})
    emit(row)


def serve_prompts(n: int) -> list[str]:
    """n seeded prompts of 400-700 printable ASCII bytes."""
    gen = torch.Generator(device="cpu").manual_seed(3)
    out = []
    for _ in range(n):
        size = int(torch.randint(400, 701, (1,), generator=gen))
        out.append(bytes(torch.randint(32, 127, (size,), generator=gen).tolist()).decode())
    return out


def trace_step(dev: torch.device, fn, *kernel_symbols: str) -> dict:
    """One call of ``fn`` under ``torch.profiler``, the card's activity only:
    the card's busy time (the sum of its kernels' times), the named
    kernels' time and launches together (``kernel_ms``) and each one's with
    its share of the busy time (``by_kernel``; a symbol sums every kernel
    whose name holds it, each listed under ``instances``), and the top
    five."""
    from torch.profiler import ProfilerActivity, profile

    sync(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        sync(dev)
    on_card = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in on_card) / 1e3
    by_kernel = {}
    for symbol in kernel_symbols:
        mine = [e for e in on_card if symbol in e.key]
        ms = sum(e.self_device_time_total for e in mine) / 1e3
        by_kernel[symbol] = {"ms": ms, "launches": sum(e.count for e in mine), "share": ms / busy if busy else 0.0}
        if len(mine) > 1:  # instances under one symbol (K4's two passes): each one's ms and launches
            by_kernel[symbol]["instances"] = {e.key[:80]: [e.self_device_time_total / 1e3, e.count] for e in mine}
    top = sorted(on_card, key=lambda e: -e.self_device_time_total)[:5]
    return {"device_busy_ms": busy, "kernel_ms": sum(k["ms"] for k in by_kernel.values()),
            "kernel_launches": sum(k["launches"] for k in by_kernel.values()), "by_kernel": by_kernel,
            "device_launches": sum(e.count for e in on_card),
            "top_kernels": [[e.key[:80], e.self_device_time_total / 1e3, e.count] for e in top]}


# each hand-written kernel a prefill launches once for every layer of its kinds, and its CUDA name
# (K4's symbol names both of its passes' instances, ssd_wgmma_bf16<NPAN,false> and <NPAN,true>: a trace
# sums them)
PREFILL_KERNELS = {"flash_attention": (("attn", "mla"), "fa_wgmma_bf16"), "ssd_scan": (("ssd",), "ssd_wgmma_bf16")}


def prefill_launches(cfg, tokens: int = 0) -> dict:
    """The launches of each of K3 and K4 that one prefill of ``cfg`` makes:
    K3 once an attention (or MLA) layer, K4 once an SSD layer, each once a
    token window of a prompt of ``tokens`` (``prefill_windows``: one up to
    PREFILL_WINDOW); a decode step launches neither."""
    from repro_torch.models.model import prefill_windows

    kinds = [kind for kind, _ in cfg.layer_plan()]
    windows = len(prefill_windows(cfg, tokens)) if tokens else 1
    return {name: windows * sum(kind in layer_kinds for kind in kinds)
            for name, (layer_kinds, _) in PREFILL_KERNELS.items()}


def window_chunks(cfg, tokens: int) -> list:
    """The scan chunks of a prefill of ``tokens`` tokens, one a token window."""
    from repro_torch.models.model import prefill_windows
    from repro_torch.models.ssm import scan_chunk

    return sorted({scan_chunk(cfg, t1 - t0) for t0, t1 in prefill_windows(cfg, tokens)})


def path_kernel_symbols(cfg) -> list[str]:
    """The CUDA names of the kernels ``cfg``'s prefill launches."""
    return [PREFILL_KERNELS[name][1] for name, n in prefill_launches(cfg).items() if n]


def since(before: dict) -> dict:
    """K3's and K4's launches since ``before`` (a ``_kernel_launches()``)."""
    now = _kernel_launches()
    return {name: now[name] - before[name] for name in PREFILL_KERNELS}


def greedy(prefill, decode, params, batch: dict) -> list[list]:
    """``BatchServer._generate_batch``'s loop on one batch through the step
    functions: a prefill, then SERVE_NEW greedy decode steps (argmax over
    the last dim, first index on ties; a multi-codebook config feeds its
    (B, n_codebooks) ids back as (B, 1, n_codebooks)); each row's ids."""
    logits, cache = prefill(params, batch, seq_cap=SERVE_PROMPT + SERVE_NEW)
    cur = logits.argmax(dim=-1)
    steps = []
    for t in range(SERVE_NEW):
        steps.append(cur)
        logits, cache = decode(params, cache, cur[:, None], SERVE_PROMPT + t)
        cur = logits.argmax(dim=-1)
    return torch.stack(steps, dim=1).cpu().tolist()  # one sync per batch


def server_batches(cfg, prompts: list[str]) -> list[dict]:
    """``prompts`` as ``BatchServer`` batches them: byte ids cut to
    SERVE_PROMPT and left-padded with zeros, SERVE_BATCH rows a batch."""
    from repro_torch.data.tokenizer import ByteTokenizer

    tok, rows = ByteTokenizer(cfg.vocab_size), []
    for p in prompts:
        ids = tok.encode(p, add_eos=False)[:SERVE_PROMPT]
        rows.append(np.zeros(SERVE_PROMPT, np.int32))
        rows[-1][-len(ids):] = ids
    return [{"tokens": torch.from_numpy(np.stack(rows[i:i + SERVE_BATCH]))} for i in range(0, len(rows), SERVE_BATCH)]


def spec_bytes(model, rows: int, cap: int) -> dict:
    """What ``abstract_params`` and ``cache_spec`` say the run holds."""
    from repro_torch.tree import tree_leaves

    params = sum(t.numel() * t.element_size() for t in tree_leaves(model.abstract_params()))
    cache = sum(math.prod(shape) * dt.itemsize for seg in model.cache_spec(rows, cap)
                for blk in seg["blocks"] for shape, dt in blk.values())
    return {"param_bytes": params, "cache_bytes": cache}


def phase_serve(dev: torch.device, summary: dict, arch: str, layers: int | None = None, example=None) -> None:
    """The serving path at full width and depth (or cut to ``layers``),
    seed-initialized on the card, two prefill batches of SERVE_BATCH; every
    batch must launch K3 once an attention (or MLA) layer and K4 once an
    SSD layer (``prefill_launches``), and no decode step either; the
    traced prefill must show each.  ``BatchServer`` serves byte prompts; MusicGen
    (codebook ids) and InternVL2 (a vision prefix), which it cannot take,
    run ``build_prefill_step`` and ``build_decode_step`` in its greedy
    loop (``greedy``) on ``prompt_batch`` inputs of SERVE_PROMPT tokens.
    Each step's host time to enqueue is kept beside its time to finish, the
    peak of ``max_memory_allocated`` while serving beside the bytes
    ``abstract_params`` and ``cache_spec`` give, and one more prefill and
    decode step run under the profiler.

    With ``example`` (``examples_torch/serve_llm.py``) the prompts go
    through its ``serve``, whose ``BatchServer`` is timed the same way, and
    its ids must equal those of ``greedy`` through the step builders on the
    same batches."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.steps import build_decode_step, build_prefill_step
    from repro_torch.models import Model
    from repro_torch.runtime import BatchServer

    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    per_batch, symbols = prefill_launches(cfg), path_kernel_symbols(cfg)
    model = Model(cfg)
    params = model.init(seed=0, device=dev)
    times: dict[str, list[float]] = {"prefill": [], "decode": [], "prefill_enqueue": [], "decode_enqueue": []}
    finite, batch_launches, decode_launches = [], [], dict.fromkeys(per_batch, 0)

    def timed(fn, key):
        def run(*args, **kwargs):
            sync(dev)
            before = _kernel_launches()
            t0 = time.perf_counter()
            logits, cache = fn(*args, **kwargs)
            times[key + "_enqueue"].append((time.perf_counter() - t0) * 1e3)
            sync(dev)
            times[key].append((time.perf_counter() - t0) * 1e3)
            finite.append(bool(torch.isfinite(logits).all()))
            if key == "prefill":
                batch_launches.append(since(before))
            else:
                for name, n in since(before).items():
                    decode_launches[name] += n
            return logits, cache
        return run

    batches = -(-SERVE_PROMPTS // SERVE_BATCH)
    prefill_step = build_prefill_step(cfg, ShapeConfig("serve", SERVE_PROMPT, SERVE_BATCH, "prefill"), dev).fn
    decode_step = build_decode_step(cfg, ShapeConfig("serve_d", SERVE_PROMPT + SERVE_NEW, SERVE_BATCH, "decode"),
                                    dev).fn
    gen = torch.Generator().manual_seed(5)
    by_steps = cfg.n_codebooks > 1 or bool(cfg.vis_prefix_len)
    if by_steps:
        inputs = [prompt_batch(cfg, SERVE_BATCH, SERVE_PROMPT, gen) for _ in range(batches)]
        trace_batch = inputs[0]
        request = {"served_by": "build_prefill_step, build_decode_step in BatchServer's greedy loop",
                   "inputs": {k: [list(v.shape), str(v.dtype)] for k, v in trace_batch.items()}}
        prefill, decode = timed(prefill_step, "prefill"), timed(decode_step, "decode")
        requests = batches * SERVE_BATCH
        generate = lambda: [ids for batch in inputs for ids in greedy(prefill, decode, params, batch)]  # noqa: E731
    else:
        class TimedServer(BatchServer):
            def __init__(self, *args, **kwargs):
                super().__init__(*args, **kwargs)
                self.prefill = timed(self.prefill, "prefill")
                self.decode = timed(self.decode, "decode")

        sizes = {"batch_size": SERVE_BATCH, "prompt_len": SERVE_PROMPT, "max_new": SERVE_NEW}
        prompts = serve_prompts(SERVE_PROMPTS)
        trace_batch = {"tokens": torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT), generator=gen)}
        request = {"served_by": "BatchServer", "prompts": len(prompts),
                   "prompt_bytes": [min(map(len, prompts)), max(map(len, prompts))]}
        requests = len(prompts)
        if example is None:
            generate = lambda: [r.token_ids for r in TimedServer(cfg, params, device=dev, **sizes).generate(prompts)]  # noqa: E731
        else:
            request["served_by"] = "examples_torch/serve_llm.py serve() through BatchServer"

            def generate():
                real, example.BatchServer = example.BatchServer, TimedServer
                try:
                    with contextlib.redirect_stdout(io.StringIO()) as printed:
                        results = example.serve(cfg, params, prompts, device=dev, **sizes)
                finally:
                    example.BatchServer = real
                request["printed_lines"] = len(printed.getvalue().splitlines())
                return [r.token_ids for r in results]
    before = _kernel_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.monotonic()
    results = generate()
    wall = time.monotonic() - t0
    launches = since(before)
    peak = torch.cuda.max_memory_allocated(dev)
    if example is not None:  # the same batches through the step builders' greedy loop
        request["same_ids_as_greedy"] = results == [
            ids for batch in server_batches(cfg, prompts) for ids in greedy(prefill_step, decode_step, params, batch)]
    held = {}

    def prefill_once():
        held["logits"], held["cache"] = prefill_step(params, trace_batch, seq_cap=SERVE_PROMPT + SERVE_NEW)

    prefill_trace = trace_step(dev, prefill_once, *symbols)
    cur = held["logits"].argmax(dim=-1)[:, None]
    decode_trace = trace_step(dev, lambda: decode_step(params, held["cache"], cur, SERVE_PROMPT), *symbols)
    emit({"phase": "serve", "arch": cfg.name, "layers": cfg.num_layers, "d_model": cfg.d_model,
          "params": model.param_count(), "dtype": cfg.dtype, "batch": SERVE_BATCH,
          "prompt_len": SERVE_PROMPT, "max_new": SERVE_NEW, **request, "prefill_batches": batches,
          "kernels": [name for name, n in per_batch.items() if n], "launches": launches,
          "launches_per_batch": batch_launches, "decode_launches": decode_launches, "results": len(results),
          "tokens_per_result": sorted({len(ids) for ids in results}), "all_logits_finite": all(finite),
          "reading": "the timings and bytes below are readings, not gates",
          "prefill_ms_per_batch": times["prefill"], "prefill_enqueue_ms_per_batch": times["prefill_enqueue"],
          "decode_ms_per_token": statistics.median(times["decode"]),
          "decode_enqueue_ms_per_token": statistics.median(times["decode_enqueue"]),
          "prefill_trace": prefill_trace, "decode_trace": decode_trace,
          "trace_note": "one more prefill and decode step under torch.profiler: device_busy_ms sums the card's kernel times",
          "card_busy_share": {"prefill": prefill_trace["device_busy_ms"] / min(times["prefill"]),
                              "decode": decode_trace["device_busy_ms"] / statistics.median(times["decode"]),
                              "note": "traced busy ms over the untraced step's wall ms (prefill: the faster batch)"},
          "generated_tokens_per_s": sum(len(ids) for ids in results) / wall, "wall_s": wall,
          "greedy_ids": {"first": results[0], "last": results[-1]},
          "max_memory_allocated": peak, **spec_bytes(model, SERVE_BATCH, SERVE_PROMPT + SERVE_NEW)})
    if batch_launches != [per_batch] * batches or any(decode_launches.values()):
        raise AssertionError(f"{batches} prefill batches launched {batch_launches} and the decode steps "
                             f"{decode_launches}, not {per_batch} a batch and none a step")
    # the profiler may drop a few of a step's ~2,800 kernel records, so the
    # exact count is the wrapper's (above); the trace must show each kernel
    missing = [k for k, row in prefill_trace["by_kernel"].items() if row["launches"] < 1 or row["ms"] <= 0]
    if missing:
        raise AssertionError(f"the traced prefill shows no launch of {missing}")
    if len(results) != requests or any(len(ids) != SERVE_NEW for ids in results):
        raise AssertionError("a request did not get its tokens")
    if not all(finite):
        raise AssertionError("non-finite logits")
    if example is not None and not request["same_ids_as_greedy"]:
        raise AssertionError(f"serve_llm's ids for {cfg.name} differ from the step builders' greedy loop")
    count_launches(summary, f"serve {cfg.name}", launches)


def long_steps(cfg, name: str, rows: int, dev: torch.device):
    """``build_step``'s prefill and decode steps of the reference's
    ``SHAPES[name]`` at ``rows`` rows; a decode shape's prefill is the same
    shape with kind ``prefill``, its decode step the shape's own."""
    from repro_torch.configs.base import SHAPES
    from repro_torch.launch.steps import build_step

    shape = dataclasses.replace(SHAPES[name], global_batch=rows)
    prefill = build_step(cfg, dataclasses.replace(shape, kind="prefill"), dev)
    decode = build_step(cfg, dataclasses.replace(shape, kind="decode"), dev)
    return shape, prefill.fn, decode.fn


def long_k3(dev: torch.device, summary: dict, card: str, arch: str) -> None:
    """K3 at ``prefill_32k``'s attention of ``arch`` (``LONG_K3[arch]``),
    bf16, seeded on the card, causal, tile 128 (the tile ``_causal_flash``
    picks), at the rows ``LONG_ROWS`` gives its ``prefill_32k``:
    Qwen3-0.6B's q (4,16,32768,128) against k/v (4,8,32768,128);
    DeepSeek-V3's MLA, q/k (2,128,32768,192) and v zero-padded from 128 to
    192 as ``mla_prefill`` pads it; Yi-6B's q (2,32,32768,128) against k/v
    (2,4,32768,128); OLMo-1B's (2,16,32768,128), MHA; Qwen1.5-110B's q
    (2,64,32768,128) against k/v (2,8,32768,128), which is Jamba-1.5-large's
    too (``LAUNCH_KEYS``).  Held to FA_TOL and FA_ROW_REL of
    its plain version (on the rows and q heads ``LONG_K3`` names, with
    their kv heads), timed beside SDPA and its bound.  The bound counts the
    real work, 2 * (qk dims + v dims) operations a causal pair a head, so
    MLA's padding of v shows as a gap; MLA is also timed at ``block_k`` 64,
    its spill-free instance (a reading: the model keeps tile 128)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import SHAPES
    from repro_torch.kernels import flash_attention as fa

    case, key, plain_rows, plain_heads = LONG_K3[arch]
    cfg = get_config(arch)
    b, s = LONG_ROWS[(arch, "prefill_32k")], SHAPES["prefill_32k"].seq_len
    h, hkv, hd, vd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim, cfg.resolved_head_dim
    if cfg.mla is not None:  # the 128 heads as kv groups of 1, q and k of nope + rope dims
        hkv, hd, vd = h, cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim, cfg.mla.v_head_dim
    gen = torch.Generator(device=dev).manual_seed(10)
    q, k, v = (torch.randn(shape, generator=gen, device=dev, dtype=torch.bfloat16)
               for shape in ((b, h, s, hd), (b, hkv, s, hd), (b, hkv, s, hd)))
    v[..., vd:] = 0  # mla_prefill's zero padding of v; nothing elsewhere
    kw = {"causal": True, "block_q": 128, "block_k": 128}
    got = fa.flash_attention(q, k, v, **kw)
    rows, heads = plain_rows or b, plain_heads or h
    group = h // hkv
    want = fa.flash_attention_plain(q[:rows, :heads], k[:rows, :heads // group], v[:rows, :heads // group], **kw)
    sync(dev)
    archs = [get_config(a).name for (a, shape), keys in LAUNCH_KEYS.items()
             if shape == "prefill_32k" and keys.get("flash_attention") == key]
    row = {"phase": "long_shapes", "case": case, "kernel": "flash_attention", "archs": archs, "q": [b, h, s, hd],
           "kv": [b, hkv, s, hd], "v_dims": vd, "dtype": "torch.bfloat16", "block_k": 128,
           "route": fa.kernel_route(torch.bfloat16, hd, 128),
           "held_to_plain": f"rows 0..{rows - 1} of {b}, q heads 0..{heads - 1} of {h} (every element there)",
           **within_tol(got[:rows, :heads], want), **row_rel(got[:rows, :heads], want)}
    del want
    if row["over_bar"] or row["over_row_bar"]:
        emit(row)
        raise AssertionError(f"flash_attention at {cfg.name}'s prefill_32k: {row['over_bar']} elements over "
                             f"FA_TOL, {row['over_row_bar']} rows over FA_ROW_REL")
    if got[..., vd:].any():
        raise AssertionError(f"flash_attention at {cfg.name}'s prefill_32k: the zero-padded v's columns are not zero")
    del got
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    row["ms"] = time_ms(lambda: fa.flash_attention(q, k, v, **kw), flush, runs=LONG_TIMED_RUNS)
    v_lib = v[..., :vd].contiguous() if vd < hd else v
    row["library_ms"] = time_ms(library_attention(q, k, v_lib, True), flush, runs=LONG_TIMED_RUNS)
    row["library"] = f"{LIBRARY_ATTENTION}, on v {list(v_lib.shape)}"
    if arch == "qwen3-0.6b":
        # one timed run (cut from 2 for the time limit): each is about 2.9 s
        row["plain_ms"] = time_ms(lambda: fa.flash_attention_plain(q, k, v, **kw), flush, runs=1, warm=0)
    if cfg.mla is not None:
        row["block_k64_ms"] = time_ms(lambda: fa.flash_attention(q, k, v, causal=True, block_q=64, block_k=64),
                                      flush, runs=LONG_TIMED_RUNS)
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v_lib)) + q[..., :vd].numel() * q.element_size()
    row.update(bound(nbytes, 2 * (hd + vd) * causal_pairs(s, s, True) * b * h, BF16_TC_OPS_PER_S, card))
    row["over_bound"], row["over_library"] = row["ms"] / row["bound_ms"], row["ms"] / row["library_ms"]
    entry = summary["flash_attention"]
    entry["max_abs_err"] = max(entry["max_abs_err"], row["max_abs_err"])
    entry[key] = {name: row[name] for name in (
        "ms", "plain_ms", "block_k64_ms", "library_ms", "bound_ms", "bound_by", "over_bound", "max_abs_err",
        "max_row_rel_err")
        if name in row}
    entry[key]["launches"] = 0  # long_run adds the path's
    emit(row)


def long_k4(dev: torch.device, summary: dict, card: str, arch: str, shape_name: str,
            long_memory: bool = False) -> None:
    """K4 at the scan of ``arch``'s long shape ``shape_name`` (``LONG_K4``),
    bf16, seeded on the card, in the chunk ``scan_chunk`` picks, at the
    shape's rows in ``LONG_ROWS``: Mamba2-780m's ``long_500k``, x
    (1,524288,48,64), one group of d_state 128, chunk 256 (2,048 chunks),
    and its ``prefill_32k``, x (8,32768,48,64), chunk 256 (128 chunks over
    384 (row, head) pairs); Jamba-1.5-large's ``prefill_32k``, x
    (2,32768,256,64), 8 groups of d_state 128, chunk 256.  y and h_final
    within SSD_TOL and the scale-aware bars (``ssd_rel``) of its plain
    version (every row and head), timed beside it and its bound.  Where
    the (row, head) pairs are too few blocks for the card's SMs (Mamba2's
    48 at ``long_500k``) the kernel splits each one's chunks into segments
    (``segments``; ``blocks`` of each pass), and ``batch1_ms`` times the
    first row alone.  With ``long_memory`` the heads keep their state
    (``ssd_inputs_long_memory``), which the segments carry, and the case
    is checked, not timed."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import SHAPES
    from repro_torch.kernels import ssd_scan as ks
    from repro_torch.models.ssm import scan_chunk

    case, key = LONG_K4[arch, shape_name]
    if long_memory:
        case, key = f"{case}_long_memory", f"{key}_long_memory"
    cfg = get_config(arch)
    ssd, l = cfg.ssd, SHAPES[shape_name].seq_len
    rows = LONG_ROWS[(arch, shape_name)]
    shape = (rows, l, ssd.n_heads(cfg.d_model), ssd.head_dim, ssd.n_groups, ssd.d_state)
    chunk = scan_chunk(cfg, l)
    draw = ssd_inputs_long_memory if long_memory else ssd_inputs
    args = draw(torch.Generator(device=dev).manual_seed(11), *shape, torch.bfloat16, dev)
    y, h_final = ks.ssd_scan(*args, chunk=chunk)
    want_y, want_h = ks.ssd_scan_plain(*args, chunk=chunk)
    sync(dev)
    on_y, on_h = within_tol(y, want_y, SSD_TOL), within_tol(h_final, want_h, SSD_TOL)
    scale_aware = ssd_rel(y, want_y, h_final, want_h, chunk)
    del want_y, want_h
    b, l, h, p, _, n = shape
    row = {"phase": "long_shapes", "case": case, "kernel": "ssd_scan", "arch": cfg.name, "b_l_h_p_g_n": list(shape),
           "chunk": chunk, "chunks": shape[1] // chunk, "dtype": "torch.bfloat16", "draw": draw.__name__,
           "route": ks.kernel_route(torch.bfloat16, shape[3], shape[5]),
           **k4_blocks(b, l, h, chunk, torch.bfloat16, dev), "y": on_y, "h_final": on_h,
           "scale_aware": scale_aware, "held_to_plain": "every row and head",
           "max_abs_err": max(on_y["max_abs_err"], on_h["max_abs_err"])}
    if on_y["over_bar"] or on_h["over_bar"] or scale_aware["over_chunk_bar"] or scale_aware["over_state_bar"]:
        emit(row)
        raise AssertionError(f"ssd_scan at {cfg.name}'s {shape_name}: elements over the bar")
    entry = summary["ssd_scan"]
    entry["max_abs_err"] = max(entry["max_abs_err"], row["max_abs_err"])
    if long_memory:
        entry[key] = {name: row[name] for name in ("max_abs_err", "segments")}
        entry[key].update({name: scale_aware[name] for name in ("max_chunk_rel_err", "max_state_rel_err")})
        emit(row)
        return
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    row["ms"] = time_ms(lambda: ks.ssd_scan(*args, chunk=chunk), flush, runs=LONG_TIMED_RUNS)
    if rows == 1:
        row["batch1_ms"] = row["ms"]
    else:
        one = tuple(t[:1] if t.dim() > 1 else t for t in args)
        row["batch1_ms"] = time_ms(lambda: ks.ssd_scan(*one, chunk=chunk), flush, runs=LONG_TIMED_RUNS)
        row["batch1_segments"] = k4_blocks(1, l, h, chunk, torch.bfloat16, dev)["segments"]
    row["ms_per_chunk"] = row["ms"] / row["chunks"]
    row["plain_ms"] = time_ms(lambda: ks.ssd_scan_plain(*args, chunk=chunk), flush, runs=1, warm=0)  # cut from 2
    row["library_ms"] = None
    nbytes = sum(t.numel() * t.element_size() for t in (*args, y, h_final))
    row.update(bound(nbytes, ssd_ops(b, l, h, p, n, chunk), BF16_TC_OPS_PER_S, card))
    row["over_bound"] = row["ms"] / row["bound_ms"]
    row["note"] = (f"{row['segments']} segment(s) a (row, head): {row['blocks']['pass_b']} blocks walk them, "
                   f"{row['blocks']['pass_a']} first scan the states they carry; batch1_ms: the first row alone")
    entry[key] = {name: row[name] for name in (
        "ms", "batch1_ms", "plain_ms", "bound_ms", "bound_by", "over_bound", "max_abs_err", "segments")}
    entry[key]["launches"] = 0  # long_run adds the path's
    emit(row)


def long_run(dev: torch.device, summary: dict, arch: str, name: str, room: int, steps: int,
             prefills: int, trace: str, layers: int | None = None) -> None:
    """``arch`` at full width and depth (or cut to ``layers``) through
    ``build_step`` at the reference's shape ``name`` (``LONG_ROWS[(arch,
    name)]`` rows, the shape's sequence as the cache's capacity):
    ``prefills`` seeded prompts of the shape's sequence less ``room``
    tokens (``prompt_batch``: MusicGen's codebook ids (B, S, 4), InternVL2's
    ``vis_embed`` over the first 256 positions), then ``steps`` greedy
    decode steps after the last one (MusicGen's ids fed back as (B, 1,
    4)).  Each
    prefill must launch K3 once an attention (or MLA) layer and K4 once an
    SSD layer (``prefill_launches``), each decode step neither; every logit
    must be finite.  A prompt past PREFILL_WINDOW tokens runs in token
    windows, each launching both kernels so.  Readings: wall and host enqueue
    ms of each prefill and step, the card's busy ms of one more prefill
    (``trace`` "prefill", with each kernel's share) and of one more decode
    step under the profiler, the peak of ``max_memory_allocated`` beside
    the bytes ``abstract_params`` and ``cache_spec`` give, and the greedy
    ids.  With ``prefills`` 0 and ``trace`` "prefill" the one prefill is
    the traced one, its wall and enqueue the readings (``prefill_timed``:
    "traced"): Jamba's ``long_500k`` prefill is card-bound (99.9% busy),
    and a second 20 s prefill would take the script's time."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.models.model import prefill_windows

    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    rows = LONG_ROWS[(arch, name)]
    shape, prefill, decode = long_steps(cfg, name, rows, dev)
    prompt = shape.seq_len - room
    per_prefill, symbols = prefill_launches(cfg, prompt), path_kernel_symbols(cfg)
    t0 = time.monotonic()
    model = Model(cfg)
    params = model.init(seed=0, device=dev)
    gen = torch.Generator().manual_seed(12)
    times: dict[str, list[float]] = {key: [] for key in (
        "prefill", "prefill_enqueue", "traced", "traced_enqueue", "decode", "decode_enqueue")}
    launches, finite, ids = [], [], {"prefill": [], "traced": [], "decode": []}

    def run(key, fn, *args, **kwargs):
        sync(dev)
        before = _kernel_launches()
        start = time.perf_counter()
        logits, cache = fn(*args, **kwargs)
        times[f"{key}_enqueue"].append((time.perf_counter() - start) * 1e3)
        sync(dev)
        times[key].append((time.perf_counter() - start) * 1e3)
        launches.append((key, since(before)))
        finite.append(bool(torch.isfinite(logits).all()))
        return logits, cache

    def one_prefill(key):
        held.clear()  # the last prefill's cache goes before the next one is made
        held["logits"], held["cache"] = run(key, prefill, params, batch, seq_cap=shape.seq_len)
        ids[key].append(held["logits"].argmax(dim=-1).tolist())

    release_card()
    torch.cuda.reset_peak_memory_stats(dev)
    held: dict = {}
    for _ in range(prefills):
        batch = prompt_batch(cfg, rows, prompt, gen)
        one_prefill("prefill")
    if trace == "prefill":  # one more prefill under the profiler, the timed one where it is the only one
        if not prefills:
            batch = prompt_batch(cfg, rows, prompt, gen)
        prefill_trace = trace_step(dev, lambda: one_prefill("traced" if prefills else "prefill"), *symbols)
    cur = held["logits"].argmax(dim=-1)[:, None]
    for t in range(steps):
        logits, held["cache"] = run("decode", decode, params, held["cache"], cur, prompt + t)
        cur = logits.argmax(dim=-1)[:, None]
        ids["decode"].append(cur[:, 0].tolist())
    peak = torch.cuda.max_memory_allocated(dev)
    row = {"phase": "long_shapes", "case": name, "arch": cfg.name, "layers": cfg.num_layers, "d_model": cfg.d_model,
           "params": model.param_count(), "dtype": cfg.dtype, "shape": dataclasses.asdict(shape),
           "rows": rows, "prompt": prompt, "decode_steps": steps, "kernels": [k for k, n in per_prefill.items() if n],
           "windows": len(prefill_windows(cfg, prompt)), "scan_chunks": window_chunks(cfg, prompt) if cfg.ssd else None,
           "launches_per_prefill": [n for key, n in launches if key == "prefill"],
           "prefill_timed": "untraced" if prefills else "traced",
           "decode_launches": {k: sum(n[k] for key, n in launches if key == "decode") for k in per_prefill},
           "reading": "the timings and bytes are readings, not gates",
           "prefill_ms": times["prefill"], "prefill_enqueue_ms": times["prefill_enqueue"]}
    if steps:
        row.update(decode_ms_per_token=statistics.median(times["decode"]),
                   decode_enqueue_ms_per_token=statistics.median(times["decode_enqueue"]),
                   decode_ms=[min(times["decode"]), max(times["decode"])])
    if trace == "prefill":
        row["prefill_trace"] = prefill_trace
        row["kernel_share"] = {symbol: k["share"] for symbol, k in prefill_trace["by_kernel"].items()}
        row["card_busy_share"] = prefill_trace["device_busy_ms"] / min(times["prefill"])
    if steps:  # one more step under the profiler
        row["decode_trace"] = trace_step(dev, lambda: decode(params, held["cache"], cur, prompt + steps - 1),
                                         *symbols)
        share = row["decode_trace"]["device_busy_ms"] / row["decode_ms_per_token"]
        row["card_busy_share" if trace == "decode" else "decode_busy_share"] = share
    row.update(max_memory_allocated=peak, **spec_bytes(model, rows, shape.seq_len),
               greedy_ids={"prefill": ids["prefill"], "decode_first_row": [i[0] for i in ids["decode"]]},
               all_logits_finite=all(finite), seconds=time.monotonic() - t0)
    emit(row)
    if row["launches_per_prefill"] != [per_prefill] * max(prefills, 1):
        raise AssertionError(f"long_shapes {cfg.name} {name}: {row['launches_per_prefill']} launches in "
                             f"{max(prefills, 1)} prefills, not {per_prefill} each")
    if any(row["decode_launches"].values()):
        raise AssertionError(f"long_shapes {cfg.name} {name}: the decode steps launched {row['decode_launches']}")
    if trace == "prefill":
        missing = [k for k, t in prefill_trace["by_kernel"].items() if t["launches"] < 1 or t["ms"] <= 0]
        if missing:
            raise AssertionError(f"long_shapes {cfg.name} {name}: the traced prefill shows no launch of {missing}")
    if not all(finite):
        raise AssertionError(f"long_shapes {cfg.name} {name}: non-finite logits")
    total = {k: sum(n[k] for key, n in launches if key == "prefill") for k in per_prefill}
    count_launches(summary, f"long_shapes {cfg.name} {name}", total)
    for kernel, key in LAUNCH_KEYS[arch, name].items():  # beside the kernel's times at this path's shapes
        summary[kernel][key]["launches"] += total[kernel]


def cache_errors(got: list, want: list, names: tuple) -> dict:
    """Each layer's ``names`` entries of two caches (those its block holds):
    the largest difference over the layer's largest |want| value, the worst
    layer's."""
    worst: dict[str, float] = {}
    for seg, want_seg in zip(got, want):
        for blk, want_blk in zip(seg["blocks"], want_seg["blocks"]):
            for name in (n for n in names if n in blk):
                for layer in range(blk[name].shape[0]):
                    g, w = blk[name][layer].float(), want_blk[name][layer].float()
                    err = float((g - w).abs().max() / w.abs().max())
                    worst[name] = max(worst.get(name, 0.0), err)
    return worst


def long_decode_check(dev: torch.device, arch: str, layers: int, conditioned: bool = False) -> None:
    """``arch`` at full width, ``layers`` layers, 2 rows, through
    ``decode_32k``'s steps: the logits of the greedy decode step after a
    prefill of 32,704 tokens (``prompt_batch``, into the 32,768-slot cache)
    against the last logits of a prefill of those 32,705 tokens (padded to
    32,768 for K3), within MODEL_REL of the largest value over the real
    vocabulary.  Qwen3 in LONG_CHECK_LAYERS; Yi-6B, MusicGen-medium (its
    four ids a row fed back as (2, 1, 4), logits (2, 4, vocab)) and
    InternVL2-2B (the same ``vis_embed`` in both prefills) so, on
    ``condition_attention``'s wq/wk (``CONDITIONED``), Yi-6B at its
    rope_theta of 5e6 at 32k positions; DeepSeek-V3 in its 3 dense layers, on
    ``condition_attention``'s w_uq/w_uk as its ``model_check`` runs: MoE
    capacity is per sequence (``capacity_per_seq``), so a prefill of
    32,705 tokens may drop a pair at an expert's capacity that a one-token
    step keeps, the reference's semantics and no fault of the absorbed
    decode, which the dense layers hold alone."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model

    cfg = dataclasses.replace(get_config(arch), num_layers=layers)
    if cfg.moe is not None and any(is_moe for _, is_moe in cfg.layer_plan()):
        raise AssertionError(f"long_shapes decode check: {cfg.name} in {layers} layers has MoE layers")
    shape, prefill, decode = long_steps(cfg, "decode_32k", 2, dev)
    s = shape.seq_len - LONG_TAIL
    t0 = time.monotonic()
    params = Model(cfg).init(seed=0, device=dev)
    if conditioned:
        condition_attention(cfg, params)
    batch = prompt_batch(cfg, 2, s, torch.Generator().manual_seed(13))
    logits, cache = prefill(params, batch, seq_cap=shape.seq_len)
    ids = logits.argmax(dim=-1)[:, None]
    step_logits, cache = decode(params, cache, ids, s)
    del cache
    whole, _ = prefill(params, {**batch, "tokens": torch.cat([batch["tokens"], ids.cpu()], dim=1)},
                       seq_cap=shape.seq_len)
    vocab = cfg.vocab_size  # the head's padding columns, where there are any, hold -2**30 in both
    err = _rel_err(step_logits[..., :vocab], whole[..., :vocab].float().cpu(), "decode logits")
    case = "decode_against_prefill_32k" + ("" if arch == "qwen3-0.6b" else f"_{cfg.name}")
    row = {"phase": "long_shapes", "case": case, "arch": cfg.name, "layers": cfg.num_layers,
           "weights": conditioned_weights(cfg) if conditioned else "seed 0",
           "rows": 2, "prompt": s, "cache": shape.seq_len, "max_rel_err": err,
           "same_greedy_ids": bool((step_logits.argmax(-1) == whole.argmax(-1)).all()),
           "bar": f"max |decode - prefill of S+1| <= {MODEL_REL} * max |prefill|, logits[..., :{vocab}]",
           "seconds": time.monotonic() - t0}
    emit(row)
    if err > MODEL_REL:
        raise AssertionError(f"long_shapes decode_32k {cfg.name}: the decode step is {err:.3g} from the prefill of S+1")


def long_moe_decode_check(dev: torch.device, arch: str, dtype: str, shape_name: str = "decode_32k",
                          prompt: int | None = None) -> None:
    """A MoE config at full width in ``dtype``, at capacity factor experts /
    top-k, where ``capacity_per_seq`` reaches the prompt's length and no
    pair is dropped, through ``shape_name``'s steps (``decode_32k``, or
    ``long_500k`` for Jamba with a ``prompt`` of 524,272 tokens, prefilled
    in token windows of 32,768 with the prompt's last 240 in a window of
    their own, the longer prefill's last 241: its windows carry the state
    and the cache as the shorter one's do), as
    ``tests/test_torch_hybrid_long.py`` and
    ``tests/test_torch_long_attention.py`` run the smoke configs on the
    CPU: the greedy decode step after a prefill against the prefill of
    those tokens and the step's id.  Its logits over the real vocabulary
    and the state after it (each attention layer's k and v, each SSD
    layer's ``ssm`` and ``conv``) within MODEL_REL (bf16; the ``ssm`` state
    HYBRID_STATE_REL) or TRAIN_F32_REL (f32, TF32 off) of the largest
    value.  Jamba-1.5-large in JAMBA_LONG_LAYERS layers, 1 row of
    JAMBA_CHECK_PROMPT[dtype] tokens (capacity factor 8): the longer
    prefill scans in chunks of 1 (``scan_chunk`` of an odd length), the
    shorter in 256, K4 on both and the step on neither.  Granite-MoE in
    LONG_CHECK_LAYERS layers, GRANITE_CHECK_ROWS rows of decode_32k's
    32,704 tokens (capacity factor 4).  K3 on each prefill, not on the
    step.  The weights are ``condition_attention``'s, as the DeepSeek-V3
    check's.  The f32 run, at the longest prompt whose f32 weights and
    experts fit the card, holds the step's logic to 1e-4; the bf16 run at
    the config's dtype shows what rounding leaves of it.  A config's own
    capacity factor would not do: a prefill of one token more may keep a
    pair at an expert's capacity that the shorter one dropped.

    Routes are discrete (``phase_model_check`` says why): the prefill and
    the step run first and record each MoE layer's expert choices, and the
    longer prefill replays them, the prefill's for the prompt and the
    step's for its token.  Its own choices that differ are printed with
    the first runs' gap between the k-th and (k+1)-th probability; a swap
    at a gap over SWAP_GAP (bf16) or SWAP_GAP_F32 (f32) fails.  On an H100
    Granite's bf16 k and v read 5.6e-2 and 6.6e-2 of their largest value
    without the replay (logits 4.7e-3, f32 1.6e-6)."""
    import route_check
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.models.model import prefill_windows

    hybrid = arch == "jamba-1.5-large-398b"
    layers, rows = (JAMBA_LONG_LAYERS, 1) if hybrid else (LONG_CHECK_LAYERS, GRANITE_CHECK_ROWS)
    base = dataclasses.replace(get_config(arch), num_layers=layers, dtype=dtype)
    moe = base.moe
    cfg = dataclasses.replace(base, moe=dataclasses.replace(
        moe, capacity_factor=moe.n_experts / moe.experts_per_token))
    names = ("k", "v", "ssm", "conv") if hybrid else ("k", "v")
    bars = dict.fromkeys(("logits", *names), TRAIN_F32_REL if dtype == "float32" else MODEL_REL)
    if dtype == "bfloat16" and hybrid:
        bars["ssm"] = HYBRID_STATE_REL
    shape, prefill, decode = long_steps(cfg, shape_name, rows, dev)
    s = prompt or (JAMBA_CHECK_PROMPT[dtype] if hybrid else shape.seq_len - LONG_TAIL)
    t0 = time.monotonic()
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        params = condition_attention(cfg, Model(cfg).init(seed=0, device=dev))
        tokens = torch.randint(0, cfg.vocab_size, (rows, s), generator=torch.Generator().manual_seed(15))
        with route_check.RouteRecorder() as first:
            before = _kernel_launches()
            logits, cache = prefill(params, {"tokens": tokens}, seq_cap=shape.seq_len)
            ids = logits.argmax(dim=-1)[:, None]
            launches = {"prefill": since(before)}
            before = _kernel_launches()
            step_logits, cache = decode(params, cache, ids, s)
            launches["step"] = since(before)
        del logits
        n = moe_layers(cfg)  # the prefill's records, then the step's, one a MoE layer
        want_idx, want_probs = ([np.concatenate([rec[i], rec[n + i]], axis=1) for i in range(n)]
                                for rec in (first.idx, first.probs))
        with route_check.RouteRecorder(replay=want_idx) as longer:
            before = _kernel_launches()
            whole, whole_cache = prefill(params, {"tokens": torch.cat([tokens, ids.cpu()], dim=1)},
                                         seq_cap=shape.seq_len)
            launches["longer_prefill"] = since(before)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    routes = route_row(cfg, want_probs, longer.probs)
    routes["differences"] = sorted(routes["differences"], key=lambda d: -d["gap"])[:ROUTE_DIFFERENCES_SHOWN]
    routes["note"] = ("the longer prefill replays the prefill's and the step's choices; its own that differ are "
                      f"counted, those at the {ROUTE_DIFFERENCES_SHOWN} largest gaps listed")
    vocab = cfg.vocab_size
    errs = {"logits": _rel_err(step_logits[..., :vocab], whole[..., :vocab].float().cpu(), "decode logits"),
            **cache_errors(cache, whole_cache, names)}
    per_prefill = prefill_launches(cfg, s)
    case = (f"decode_against_prefill_{'32k' if shape_name == 'decode_32k' else shape_name}_"
            f"{'hybrid' if hybrid else cfg.name}_{dtype}")
    row = {"phase": "long_shapes", "case": case, "arch": cfg.name, "dtype": dtype, "layers": cfg.num_layers,
           "kinds": [f"{kind}{' + moe' if is_moe else ''}" for kind, is_moe in cfg.layer_plan()],
           "capacity_factor": cfg.moe.capacity_factor, "weights": conditioned_weights(cfg), "rows": rows,
           "prompt": s, "cache": shape.seq_len, "launches": launches, "max_rel_err": errs, "routes": routes,
           "same_greedy_ids": bool((step_logits.argmax(-1) == whole.argmax(-1)).all()),
           "bar": f"logits[..., :{vocab}] and each layer's {', '.join(names)}: max |decode - prefill of S+1| <= "
                  f"bar * max |prefill's|", "bars": bars,
           **({"chunks": {"prefill": window_chunks(cfg, s), "longer_prefill": window_chunks(cfg, s + 1)}}
              if hybrid else {}),
           "windows": {"prefill": len(prefill_windows(cfg, s)), "longer_prefill": len(prefill_windows(cfg, s + 1))},
           "seconds": time.monotonic() - t0}
    emit(row)
    if launches != {"prefill": per_prefill, "step": dict.fromkeys(per_prefill, 0),
                    "longer_prefill": prefill_launches(cfg, s + 1)}:
        raise AssertionError(f"long_shapes {cfg.name} decode check: launches {launches}")
    if errs.keys() != bars.keys() or any(errs[k] > bars[k] for k in bars):
        raise AssertionError(f"long_shapes {dtype} {cfg.name} decode check over the bar: {errs}")
    if routes["max_swap_gap"] > routes["swap_gap_bar"]:
        raise AssertionError(f"long_shapes {dtype} {cfg.name} decode check: a route swapped at a gap of "
                             f"{routes['max_swap_gap']}")


def long_state_check(dev: torch.device, dtype: str) -> None:
    """Mamba2-780m at full width, LONG_CHECK_LAYERS layers, in ``dtype``,
    through ``long_500k``'s steps: a prefill of 524,288 tokens (16 token
    windows of 32,768, chunk 256, each scan starting from the state the
    window before left) against a prefill of the first 524,224 (17 windows:
    the last 192 tokens in one of their own, scanned in a chunk of 192)
    followed by 64 decode steps on the rest: the last logits over the real
    vocabulary (the head's padding columns hold -2**30 in both) and every
    layer's state ``ssm`` within MODEL_REL (bf16) or TRAIN_F32_REL (f32,
    TF32 off) of their largest value; the conv window's difference is
    printed beside them.  So the windows' carry of the state and the conv
    window is held to the recurrent decode.  The f32 run is the witness that
    the bf16 gap is rounding and not a fault of either prefill's path or of
    the decode."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ssd_scan
    from repro_torch.models import Model
    from repro_torch.models.model import prefill_windows

    cfg = dataclasses.replace(get_config("mamba2-780m"), num_layers=LONG_CHECK_LAYERS, dtype=dtype)
    bar = TRAIN_F32_REL if dtype == "float32" else MODEL_REL
    shape, prefill, decode = long_steps(cfg, "long_500k", 1, dev)
    l, part, vocab = shape.seq_len, shape.seq_len - LONG_TAIL, cfg.vocab_size
    chunks = (window_chunks(cfg, l), window_chunks(cfg, part))
    windows = (len(prefill_windows(cfg, l)), len(prefill_windows(cfg, part)))
    t0 = time.monotonic()
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        params = Model(cfg).init(seed=0, device=dev)
        tokens = torch.randint(0, cfg.vocab_size, (1, l), generator=torch.Generator().manual_seed(14))
        ssd_scan.ssd_scan.launches = 0
        want_logits, want_cache = prefill(params, {"tokens": tokens})
        logits, cache = prefill(params, {"tokens": tokens[:, :part]})
        launches = ssd_scan.ssd_scan.launches
        for t in range(part, l):
            logits, cache = decode(params, cache, tokens[:, t:t + 1], t)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    errs = {"logits": _rel_err(logits[..., :vocab], want_logits[..., :vocab].float().cpu(), "logits"),
            **cache_errors(cache, want_cache, ("ssm", "conv"))}
    row = {"phase": "long_shapes", "case": f"state_over_long_500k_{dtype}", "arch": cfg.name, "dtype": dtype,
           "layers": cfg.num_layers, "tokens": l, "chunks": {"prefill": chunks[0], "prefill_then_decode": chunks[1]},
           "windows": {"prefill": windows[0], "prefill_then_decode": windows[1]},
           "decode_steps": l - part, "k4_launches": launches, "max_rel_err": errs,
           "bar": f"logits[..., :{vocab}] and each layer's ssm: max |diff| <= {bar} * max |prefill's|; conv printed",
           "seconds": time.monotonic() - t0}
    emit(row)
    if (chunks[0] != [cfg.ssd.chunk] or chunks[1] == chunks[0] or windows[0] < 2
            or launches != sum(windows) * cfg.num_layers):
        raise AssertionError(f"long_shapes state check: chunks {chunks}, windows {windows}, {launches} K4 launches")
    if errs["logits"] > bar or errs["ssm"] > bar:
        raise AssertionError(f"long_shapes {dtype} state check over the bar: {errs}")


def largest_divisor(n: int, cap: int) -> int:
    """The largest divisor of ``n`` that is at most ``cap``."""
    return max(d for d in range(1, min(n, cap) + 1) if n % d == 0)


def long_k3_window(dev: torch.device, summary: dict, card: str) -> None:
    """K3 at the last two token windows of Jamba-1.5-large's ``long_500k``
    prefill (``prefill_windows`` of LONG_500K_PROMPT tokens; Qwen1.5-110B's
    heads: 64 of 128 over 8 kv heads), bf16, seeded on the card, through
    ``attention._causal_flash`` as ``attn_prefill`` calls it: the last full
    window, 32,512 queries against 524,032 keys (tile 128, no padding), and
    the prompt's last 240 tokens against 524,272 keys, which
    ``_causal_flash`` pads by 16 rows on q and on k/v to 256 against 524,288
    (the path's one partial tile).  Each is held to FA_TOL and FA_ROW_REL of
    its plain version on the unpadded q, k and v, on the window's last
    LONG_K3_WINDOW_ROWS query rows (the tail's all 240) of the q heads of kv
    head 0 (the rows keep their alignment; key tiles of the largest divisor
    of the keys up to 32,768), and timed at the kernel's own (padded) shape
    beside its bound (its causal pairs at 64 heads) and beside SDPA with the
    causal mask at the bottom right (``library_attention``) on the unpadded
    q, k and v.  The kernels line's entry holds both windows; the path's
    every window counts its launch under it (``LAUNCH_KEYS``)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.attention import FLASH_PAD, _causal_flash
    from repro_torch.models.model import prefill_windows

    case, key = LONG_K3_WINDOW
    cfg = get_config("jamba-1.5-large-398b")
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    group = h // hkv  # the q heads of kv head 0 are 0 .. group - 1
    windows = prefill_windows(cfg, LONG_500K_PROMPT)
    gen = torch.Generator(device=dev).manual_seed(17)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    entry = summary["flash_attention"]
    entry[key] = {"windows": len(windows), "launches": 0}  # long_run adds the path's
    for label, (t0, t1) in (("last_window", windows[-2]), ("tail_window", windows[-1])):
        sq, skv = t1 - t0, t1
        pad = -sq % FLASH_PAD
        if (skv - sq) % FLASH_PAD:
            raise AssertionError(f"{label}: {skv - sq} keys before the window, not a multiple of {FLASH_PAD}")
        # head-major as the kernel takes them, zero rows after the real ones as _causal_flash pads them
        qh, kt, vt = (torch.randn(shape, generator=gen, device=dev, dtype=torch.bfloat16)
                      for shape in ((1, h, sq + pad, hd), (1, hkv, skv + pad, hd), (1, hkv, skv + pad, hd)))
        for t, n in ((qh, sq), (kt, skv), (vt, skv)):
            t[:, :, n:] = 0
        q = qh[:, :, :sq].unflatten(1, (hkv, group)).permute(0, 3, 1, 2, 4)  # (1, sq, K, G, hd)
        k, v = kt[:, :, :skv].transpose(1, 2), vt[:, :, :skv].transpose(1, 2)  # (1, skv, K, hd)
        got = _causal_flash(q, k, v)  # (1, sq, h, hd)
        rows = min(LONG_K3_WINDOW_ROWS, sq)
        want = fa.flash_attention_plain(qh[:, :group, sq - rows:sq], kt[:, :1, :skv], vt[:, :1, :skv], causal=True,
                                        block_q=rows, block_k=largest_divisor(skv, 32_768))
        sync(dev)
        part = got[:, sq - rows:, :group].transpose(1, 2)
        row = {"phase": "long_shapes", "case": f"{case}_{label}", "kernel": "flash_attention", "arch": cfg.name,
               "window": [t0, t1], "q": [1, h, sq, hd], "kv": [1, hkv, skv, hd], "q_offset": skv - sq,
               "padded_rows": pad, "kernel_q": list(qh.shape), "kernel_kv": list(kt.shape),
               "dtype": "torch.bfloat16", "block_k": 128, "route": fa.kernel_route(torch.bfloat16, hd, 128),
               "held_to_plain": f"the last {rows} query rows of q heads 0..{group - 1} (kv head 0), every element "
                                f"there, through _causal_flash",
               **within_tol(part, want), **row_rel(part, want)}
        del want, part
        if row["over_bar"] or row["over_row_bar"] or not torch.isfinite(got.float()).all():
            emit(row)
            raise AssertionError(f"flash_attention at long_500k's {label}: {row['over_bar']} elements over FA_TOL, "
                                 f"{row['over_row_bar']} rows over FA_ROW_REL, or non-finite values")
        del got, q, k, v
        row["ms"] = time_ms(lambda: fa.flash_attention(qh, kt, vt, causal=True, block_q=128, block_k=128), flush,
                            runs=2, warm=1)
        lib = [t[:, :, :n].contiguous() for t, n in ((qh, sq), (kt, skv), (vt, skv))]
        row["library_ms"] = time_ms(library_attention(*lib, True), flush, runs=2, warm=1)
        row["library"] = LIBRARY_ATTENTION_RIGHT
        nbytes = sum(t.numel() * t.element_size() for t in lib) + lib[0].numel() * lib[0].element_size()
        del lib
        row.update(bound(nbytes, 2 * 2 * hd * causal_pairs(sq, skv, True) * h, BF16_TC_OPS_PER_S, card))
        row["over_bound"], row["over_library"] = row["ms"] / row["bound_ms"], row["ms"] / row["library_ms"]
        entry["max_abs_err"] = max(entry["max_abs_err"], row["max_abs_err"])
        entry[key][label] = {name: row[name] for name in (
            "window", "ms", "library_ms", "bound_ms", "bound_by", "over_bound", "max_abs_err", "max_row_rel_err")}
        emit(row)
        del qh, kt, vt


def long_k4_h0(dev: torch.device, summary: dict, card: str, arch: str) -> None:
    """K4 from an initial state at a token window of ``arch``'s ``long_500k``
    prefill (``LONG_K4_H0``), bf16, one row of PREFILL_WINDOW tokens, chunk
    256, seeded on the card: Jamba-1.5-large's x (1,32768,256,64), 8 groups
    of d_state 128, one segment a (row, head); Mamba2-780m's x
    (1,32768,48,64), one group, whose 48 (row, head) pairs split their 128
    chunks into segments, so h0 enters the carry's fold at segment 0 and
    reaches the others through it.  ``ssd_inputs``' draws and h0 ~ N(0, 1)
    f32: y and h_final within SSD_TOL and the scale-aware bars
    (``ssd_rel``) of the plain version from the same h0, timed beside it
    and its bound.  Mamba2's case also splits one scan in two halves of
    16,384 tokens, the first's h_final the second's h0, on
    ``ssd_inputs_long_memory``'s draws (heads that keep their state across
    the halves), and holds both halves' y and the second's h_final to the
    plain version's scan of the whole within SSD_CHUNK_REL and
    SSD_STATE_REL."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ssd_scan as ks
    from repro_torch.models.model import PREFILL_WINDOW

    case, key = LONG_K4_H0[arch]
    cfg = get_config(arch)
    ssd, l, chunk = cfg.ssd, PREFILL_WINDOW, cfg.ssd.chunk
    shape = (1, l, ssd.n_heads(cfg.d_model), ssd.head_dim, ssd.n_groups, ssd.d_state)
    b, _, h, p, _, n = shape
    gen = torch.Generator(device=dev).manual_seed(18)
    args = ssd_inputs(gen, *shape, torch.bfloat16, dev)
    h0 = torch.randn((b, h, p, n), generator=gen, device=dev)
    y, h_final = ks.ssd_scan(*args, chunk=chunk, h0=h0)
    want_y, want_h = ks.ssd_scan_plain(*args, chunk=chunk, h0=h0)
    sync(dev)
    on_y, on_h = within_tol(y, want_y, SSD_TOL), within_tol(h_final, want_h, SSD_TOL)
    scale_aware = ssd_rel(y, want_y, h_final, want_h, chunk)
    del want_y, want_h
    row = {"phase": "long_shapes", "case": case, "kernel": "ssd_scan", "arch": cfg.name, "b_l_h_p_g_n": list(shape),
           "chunk": chunk, "chunks": l // chunk, "dtype": "torch.bfloat16", "draw": "ssd_inputs, h0 ~ N(0, 1)",
           "route": ks.kernel_route(torch.bfloat16, p, n), **k4_blocks(b, l, h, chunk, torch.bfloat16, dev),
           "y": on_y, "h_final": on_h, "scale_aware": scale_aware, "held_to_plain": "every row and head, the same h0",
           "max_abs_err": max(on_y["max_abs_err"], on_h["max_abs_err"])}
    failed = on_y["over_bar"] or on_h["over_bar"] or scale_aware["over_chunk_bar"] or scale_aware["over_state_bar"]
    if arch == "mamba2-780m":
        half = l // 2
        long_args = ssd_inputs_long_memory(gen, *shape, torch.bfloat16, dev)
        first = tuple(t[:, :half].contiguous() if t.dim() > 1 else t for t in long_args)
        second = tuple(t[:, half:].contiguous() if t.dim() > 1 else t for t in long_args)
        y1, h1 = ks.ssd_scan(*first, chunk=chunk)
        y2, h2 = ks.ssd_scan(*second, chunk=chunk, h0=h1)
        want_y, want_h = ks.ssd_scan_plain(*long_args, chunk=chunk)
        split = ssd_rel(torch.cat([y1, y2], dim=1), want_y, h2, want_h, chunk)
        row["split_in_two"] = {"halves": [half, l - half], "draw": "ssd_inputs_long_memory",
                               "segments_a_half": k4_blocks(b, half, h, chunk, torch.bfloat16, dev)["segments"],
                               "held_to": "the plain version's scan of the whole", **split}
        failed = failed or split["over_chunk_bar"] or split["over_state_bar"]
        del want_y, want_h, y1, y2
    if failed:
        emit(row)
        raise AssertionError(f"ssd_scan with h0 at {cfg.name}'s long_500k window: elements over the bar")
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    row["ms"] = time_ms(lambda: ks.ssd_scan(*args, chunk=chunk, h0=h0), flush, runs=LONG_TIMED_RUNS)
    row["plain_ms"] = time_ms(lambda: ks.ssd_scan_plain(*args, chunk=chunk, h0=h0), flush, runs=1, warm=0)
    row["library_ms"] = None
    nbytes = sum(t.numel() * t.element_size() for t in (*args, h0, y, h_final))
    row.update(bound(nbytes, ssd_ops(b, l, h, p, n, chunk), BF16_TC_OPS_PER_S, card))
    row["over_bound"] = row["ms"] / row["bound_ms"]
    entry = summary["ssd_scan"]
    entry["max_abs_err"] = max(entry["max_abs_err"], row["max_abs_err"])
    entry[key] = {name: row[name] for name in (
        "ms", "plain_ms", "bound_ms", "bound_by", "over_bound", "max_abs_err", "segments")}
    entry[key]["launches"] = 0  # long_run adds the path's
    emit(row)


def long_window_check(dev: torch.device, dtype: str) -> None:
    """Jamba-1.5-large in JAMBA_LONG_LAYERS layers at full width in ``dtype``,
    one row: the prefill in token windows against the whole prefill of the
    same prompt on the card, ``WINDOW_CHECK[dtype]`` (bf16: 32,768 tokens in
    4 windows of 8,192; f32, TF32 off: 4,096 in 4 of 1,024), on
    ``condition_attention``'s weights at the config's capacity factor (the
    windowed rule drops the pairs the whole one drops): the last logits over
    the vocabulary and every layer's k, v, ssm and conv within MODEL_REL
    (bf16; ssm HYBRID_STATE_REL) or TRAIN_F32_REL (f32) of the whole
    prefill's largest value.  The whole prefill runs first and records its
    expert choices, and the windowed one replays them: cuBLAS takes other
    algorithms for a window's rows than for the whole prompt's, so bf16
    rounds otherwise, and a near-tied token could route apart; the windowed
    run's own choices that differ are printed, a swap at a gap over SWAP_GAP
    (bf16) or SWAP_GAP_F32 (f32) fails.  K3 launches once and K4 twice in the
    whole prefill, once and twice a window in the windowed one."""
    import route_check
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.models.model import prefill_windows
    from repro_torch.models.ssm import scan_chunk

    cfg = dataclasses.replace(get_config("jamba-1.5-large-398b"), num_layers=JAMBA_LONG_LAYERS, dtype=dtype)
    s, window = WINDOW_CHECK[dtype]
    names = ("k", "v", "ssm", "conv")
    bars = dict.fromkeys(("logits", *names), TRAIN_F32_REL if dtype == "float32" else MODEL_REL)
    if dtype == "bfloat16":
        bars["ssm"] = HYBRID_STATE_REL
    shape, prefill, _ = long_steps(cfg, "prefill_32k", 1, dev)
    t0 = time.monotonic()
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        params = condition_attention(cfg, Model(cfg).init(seed=0, device=dev))
        tokens = torch.randint(0, cfg.vocab_size, (1, s), generator=torch.Generator().manual_seed(16))
        launches = {}
        with route_check.RouteRecorder() as whole_routes:
            before = _kernel_launches()
            logits, cache = prefill(params, {"tokens": tokens})
            launches["whole"] = since(before)
        with route_check.RouteRecorder(replay=whole_routes.idx) as windowed_routes:
            before = _kernel_launches()
            got_logits, got_cache = prefill(params, {"tokens": tokens}, window=window)
            launches["windowed"] = since(before)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    routes = route_row(cfg, whole_routes.probs, windowed_routes.probs)
    routes["differences"] = sorted(routes["differences"], key=lambda d: -d["gap"])[:ROUTE_DIFFERENCES_SHOWN]
    routes["note"] = "the windowed prefill replays the whole one's choices; its own that differ are counted"
    vocab = cfg.vocab_size
    errs = {"logits": _rel_err(got_logits[..., :vocab], logits[..., :vocab].float().cpu(), "windowed logits"),
            **cache_errors(got_cache, cache, names)}
    windows = len(prefill_windows(cfg, s, window))
    want = {"whole": prefill_launches(cfg), "windowed": {k: windows * n for k, n in prefill_launches(cfg).items()}}
    row = {"phase": "long_shapes", "case": f"windowed_against_whole_{dtype}", "arch": cfg.name, "dtype": dtype,
           "layers": cfg.num_layers, "capacity_factor": cfg.moe.capacity_factor,
           "weights": conditioned_weights(cfg), "rows": 1, "tokens": s, "window": window, "windows": windows,
           "scan_chunks": {"whole": scan_chunk(cfg, s), "windowed": sorted(
               {scan_chunk(cfg, t1 - t0) for t0, t1 in prefill_windows(cfg, s, window)})},
           "launches": launches, "max_rel_err": errs, "routes": routes,
           "bar": "logits[..., :vocab] and each layer's k, v, ssm, conv: max |windowed - whole| <= bar * max |whole|",
           "bars": bars, "seconds": time.monotonic() - t0}
    emit(row)
    if launches != want:
        raise AssertionError(f"long_shapes windowed check {dtype}: launches {launches}, not {want}")
    if errs.keys() != bars.keys() or any(errs[k] > bars[k] for k in bars):
        raise AssertionError(f"long_shapes windowed check {dtype} over the bar: {errs}")
    if routes["max_swap_gap"] > routes["swap_gap_bar"]:
        raise AssertionError(f"long_shapes windowed check {dtype}: a route swapped at a gap of {routes['max_swap_gap']}")


def phase_long_shapes(dev: torch.device, summary: dict, card: str) -> None:
    """The reference's long shapes at full width and depth on one card
    (``long_shapes``), a ``seconds`` line after each case: K3 at
    ``prefill_32k``'s attention of Qwen3-0.6B (InternVL2-2B's too),
    DeepSeek-V3 (MLA), Yi-6B, OLMo-1B, Qwen1.5-110B (Jamba-1.5-large's
    too), Granite-MoE and MusicGen, and K4 at Mamba2's ``long_500k`` and
    ``prefill_32k`` scans and Jamba's ``prefill_32k`` scan, against their
    plain versions;
    Qwen3-0.6B at ``prefill_32k`` (4 rows of 32,768) and ``decode_32k`` (8
    rows: a prefill of 32,704 tokens into the 32,768-slot cache, then 64
    greedy decode steps to its last slot); the decode step after a 32k
    prompt against the prefill of one token more; DeepSeek-V3 in 4 layers
    at ``prefill_32k`` and ``decode_32k`` (2 rows each, 64 absorbed decode
    steps over the 32,768-slot latent cache) and its decode check in its 3
    dense layers; Yi-6B and OLMo-1B at ``prefill_32k`` and ``decode_32k``
    (2 rows) and Yi-6B's decode check in 4 layers; Jamba in
    3 layers (attention + dense, SSD + MoE, SSD + dense: K3 and K4 in one
    prefill) at ``prefill_32k`` and ``decode_32k`` (2 rows) and its decode
    step against the prefill of one token more (``long_moe_decode_check``);
    Qwen1.5-110B in 4 layers at ``prefill_32k`` and ``decode_32k`` (2
    rows); Granite-MoE (4 rows), MusicGen (2 rows, four codebooks),
    InternVL2 (4 rows, its vision prefix) and Mamba2-780m (8 rows) at
    ``prefill_32k`` and ``decode_32k``, MusicGen's and InternVL2's decode
    checks in 4 layers and Granite's at the capacity that drops no pair;
    Mamba2-780m at ``long_500k`` (a prefill of 524,288 tokens in 16 token
    windows, then 16 decode steps from its state); the state after 524,288
    tokens against a prefill of 64 fewer and the recurrent decode, in bf16
    and, as its witness, in f32; K3 at the last two windows of Jamba's
    ``long_500k`` prefill (``long_k3_window``) and K4 from an initial
    state at Jamba's and Mamba2's windows (``long_k4_h0``) against their
    plain versions;
    Jamba's windowed prefill against its whole one at 32,768 tokens
    (``long_window_check``, bf16 and an f32 witness); Jamba in 3 layers at
    ``long_500k`` (a prefill of 524,272 tokens in 17 windows, then 16 decode
    steps to the cache's last slot) and its decode step there against the
    windowed prefill of one token more.  Each ``prefill_32k`` runs one
    timed prefill beside the traced one (cut from 2 for the time limit;
    each ``decode_32k`` runs the prefill of 32,704 tokens once more)."""
    cases = [(f"k3 {arch}", long_k3, (dev, summary, card, arch), {}) for arch in LONG_K3]
    cases += [("k3 jamba-1.5-large-398b long_500k windows", long_k3_window, (dev, summary, card), {})]
    cases += [(f"k4 {arch} {shape}", long_k4, (dev, summary, card, arch, shape), {}) for arch, shape in LONG_K4]
    cases += [("k4 mamba2-780m long_500k long_memory", long_k4, (dev, summary, card, "mamba2-780m", "long_500k"),
               {"long_memory": True})]
    cases += [(f"k4 h0 {arch} long_500k window", long_k4_h0, (dev, summary, card, arch), {}) for arch in LONG_K4_H0]
    jamba, qwen15, granite = "jamba-1.5-large-398b", "qwen1.5-110b", "granite-moe-1b-a400m"

    def prefill_32k(arch, layers=None):
        return f"{arch} prefill_32k", long_run, (dev, summary, arch, "prefill_32k", 0, 0, 1, "prefill"), {
            "layers": layers}

    def decode_32k(arch, layers=None):
        return (f"{arch} decode_32k", long_run, (dev, summary, arch, "decode_32k", LONG_TAIL, LONG_TAIL, 1, "decode"),
                {"layers": layers})

    cases += [
        prefill_32k("qwen3-0.6b"), decode_32k("qwen3-0.6b"),
        ("qwen3-0.6b decode check", long_decode_check, (dev, "qwen3-0.6b", LONG_CHECK_LAYERS), {}),
        prefill_32k("deepseek-v3-671b", LONG_MLA_LAYERS), decode_32k("deepseek-v3-671b", LONG_MLA_LAYERS),
        ("deepseek-v3-671b decode check", long_decode_check,
         (dev, "deepseek-v3-671b", LONG_MLA_CHECK_LAYERS), {"conditioned": True}),
        prefill_32k("yi-6b"), prefill_32k("olmo-1b"),
        decode_32k("yi-6b"), decode_32k("olmo-1b"), decode_32k(qwen15, QWEN15_LAYERS),
        # Yi-6B's rope_theta of 5e6 at 32k positions, on condition_attention's weights (CONDITIONED)
        ("yi-6b decode check", long_decode_check, (dev, "yi-6b", LONG_CHECK_LAYERS),
         {"conditioned": CONDITIONED["yi-6b", "bfloat16"]}),
        prefill_32k(jamba, JAMBA_LONG_LAYERS), decode_32k(jamba, JAMBA_LONG_LAYERS),
        *((f"{arch} decode check {dtype}", long_moe_decode_check, (dev, arch, dtype), {})
          for arch in (jamba, granite) for dtype in ("bfloat16", "float32")),
        prefill_32k(qwen15, QWEN15_LAYERS),
        prefill_32k(granite), decode_32k(granite),
        *(case for arch in ("musicgen-medium", "internvl2-2b") for case in (
            prefill_32k(arch), decode_32k(arch),
            (f"{arch} decode check", long_decode_check, (dev, arch, LONG_CHECK_LAYERS),
             {"conditioned": CONDITIONED[arch, "bfloat16"]}))),
        prefill_32k("mamba2-780m"), decode_32k("mamba2-780m"),
        ("mamba2-780m long_500k", long_run,
         (dev, summary, "mamba2-780m", "long_500k", 0, LONG_500K_STEPS, 1, "prefill"), {}),
        ("state check bfloat16", long_state_check, (dev, "bfloat16"), {}),
        ("state check float32", long_state_check, (dev, "float32"), {}),
        *((f"{jamba} windowed check {dtype}", long_window_check, (dev, dtype), {})
          for dtype in ("bfloat16", "float32")),
        (f"{jamba} long_500k", long_run,  # one prefill, traced and timed
         (dev, summary, jamba, "long_500k", LONG_500K_ROOM, LONG_500K_STEPS, 0, "prefill"),
         {"layers": JAMBA_LONG_LAYERS}),
        (f"{jamba} long_500k decode check", long_moe_decode_check,
         (dev, jamba, "bfloat16", "long_500k", LONG_500K_PROMPT), {}),
    ]
    for label, fn, args, kwargs in cases:
        timed(f"long_shapes {label}", fn, *args, **kwargs)
        release_card()


def _kernel_launches() -> dict:
    from repro_torch.kernels import dequant_normalize, flash_attention, ssd_scan

    return {"dequant_normalize_augment": dequant_normalize.dequant_normalize_augment.launches,
            "dequant_normalize": dequant_normalize.dequant_normalize.launches,
            "flash_attention": flash_attention.flash_attention.launches,
            "ssd_scan": ssd_scan.ssd_scan.launches}


def _zero_kernel_launches() -> None:
    from repro_torch.kernels import dequant_normalize, flash_attention, ssd_scan

    for wrapper in (dequant_normalize.dequant_normalize_augment, dequant_normalize.dequant_normalize,
                    flash_attention.flash_attention, ssd_scan.ssd_scan):
        wrapper.launches = 0


def packed_batch(vocab: int, b: int, s: int, seed: int) -> dict:
    """b packed rows of s tokens from seeded documents of 64-400 tokens:
    positions restart and segment ids count per document."""
    from repro_torch.data.packing import SequencePacker, collate

    rng = np.random.default_rng(seed)
    packer, rows = SequencePacker(s), []
    while len(rows) < b:
        rows += packer.add(rng.integers(0, vocab, int(rng.integers(64, 401)), dtype=np.int32))
    return collate(rows[:b])


def train_batch(cfg, b: int, s: int, seed: int) -> dict:
    """``packed_batch`` for ``cfg``.  MusicGen: tokens and labels (b, s, 4),
    the packed ids in codebook 0 beside seeded ids in the other three,
    whose labels are the next position's ids, masked where the packed
    labels are.  InternVL2: ``vis_embed`` (b, 256, d_model), bf16 N(0, 1),
    with the labels over the prefix masked, as ``tests/test_arch_smoke.py``
    does."""
    batch = packed_batch(cfg.vocab_size, b, s, seed)
    if cfg.n_codebooks > 1:
        rng = np.random.default_rng(seed + 1)
        tokens, labels = batch["tokens"][..., None], batch["labels"][..., None]
        more = rng.integers(0, cfg.vocab_size, (b, s, cfg.n_codebooks - 1), dtype=tokens.dtype)
        batch["tokens"] = np.concatenate([tokens, more], axis=-1)
        batch["labels"] = np.concatenate([labels, np.where(labels >= 0, np.roll(more, -1, axis=1), -1)], axis=-1)
    if cfg.vis_prefix_len:
        gen = torch.Generator().manual_seed(seed + 1)
        batch["vis_embed"] = torch.randn((b, cfg.vis_prefix_len, cfg.d_model), generator=gen).to(torch.bfloat16)
        batch["labels"][:, :cfg.vis_prefix_len] = -1
    return batch


def one_train_step(cfg, dev: torch.device, params: dict, batch: dict, replay: list | None = None):
    """One ``build_train_step`` step of ``cfg`` on ``dev`` from ``params``,
    as far as the checks read it: its metrics, the gradient leaves it hands
    ``apply_update`` (where they were computed: ``leaf_errors`` compares on
    the card) and its MoE
    layers' route records in call order (the forward pass, then each
    layer's recompute in the backward pass), taking the expert choices of
    ``replay`` if given.  ``apply_update`` is replaced by its first lines,
    the metrics it returns (the gradients' global norm and the learning
    rate, by ``optim.global_norm`` and ``optim.lr_schedule``); the update
    after them, which no check reads, is not run, and the optimizer
    moments it would write are not made.  On the CPU the update and the
    zeroed moments of DeepSeek-V3's 3.12 B parameters were most of each
    step's 82-113 s (``probes_torch/train_step_cpu_profile.py``, the 8 host
    cores beside an NVIDIA H100 80GB HBM3, 700.00 W); the optimizer is
    held to the reference in ``tests/test_torch_optim_ckpt.py`` and runs
    on the card in ``train``."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import steps
    import route_check
    from repro_torch.optim import global_norm, lr_schedule
    from repro_torch.tree import tree_leaves

    rows, seq = batch["tokens"].shape[:2]
    bundle = steps.build_train_step(cfg, ShapeConfig("check", seq, rows, "train"), grad_accum=1, device=dev)
    seen = []
    real_update = steps.apply_update

    def update(opt_cfg, params, grads, state):
        seen.extend(g.detach() for g in tree_leaves(grads))
        return params, state, {"grad_norm": global_norm(grads), "lr": lr_schedule(opt_cfg, state["step"] + 1)}

    steps.apply_update = update
    try:
        with route_check.RouteRecorder(replay) as routes:
            _, _, metrics = bundle.fn(params, {"step": torch.zeros((), dtype=torch.int32, device=dev)}, batch)
    finally:
        steps.apply_update = real_update
    return {k: float(v) for k, v in metrics.items()}, seen, routes


def train_route_differences(cfg, want: list, got: list) -> list[dict]:
    """The forward pass's (token, layer) pairs whose own expert choice
    differs between two steps' records, with the experts (and so the expert
    weight leaves) they would have touched differently."""
    import route_check
    from repro_torch.models import moe

    moe_layers = [i for i, (_, is_moe) in enumerate(cfg.layer_plan()) if is_moe]
    out = []
    for pw, pg, layer in zip(want, got, moe_layers):  # the forward pass's records come first
        cap, k = moe.capacity_per_seq(cfg, pw.shape[1]), cfg.moe.experts_per_token
        kw, kg = route_check.kept_experts(pw, k, cap), route_check.kept_experts(pg, k, cap)
        for diff in route_check.differences(cfg, pw, pg, layer=layer):
            experts = np.nonzero(kw[diff.row, diff.token] != kg[diff.row, diff.token])[0].tolist()
            out.append({**dataclasses.asdict(diff), "experts": experts,
                        "leaves": f"layer {layer} ffn w_gate, w_up, w_down [experts {experts}]"})
    return out


def leaf_errors(dev: torch.device, name: str, g, want, w32, g32) -> dict:
    """One gradient leaf of ``train_check``, compared on the card (a CPU pass
    over DeepSeek's 3.12 B took 61-79 s): the card's bf16 leaf ``g`` against
    the CPU's bf16 ``want`` (``rel_err``) and f32 ``w32`` (``vs_cpu_f32``),
    ``want`` against ``w32`` (``cpu_bf16_vs_f32``) and the card's f32 leaf
    ``g32`` against ``w32`` (``f32``); each the largest difference over the
    largest |value| of the second, as ``_rel_err``."""
    if not g.shape == want.shape == w32.shape == g32.shape:
        raise AssertionError(f"{name}: shapes {[tuple(t.shape) for t in (g, want, w32, g32)]}")
    g, want, w32, g32 = (t.to(dev).float() for t in (g, want, w32, g32))
    if not (torch.isfinite(g).all() and torch.isfinite(g32).all()):
        raise AssertionError(f"{name}: non-finite values")
    top, top32 = want.abs().max(), w32.abs().max()
    errs = torch.stack([(g - want).abs().max() / top, (g - w32).abs().max() / top32,
                        (want - w32).abs().max() / top32, (g32 - w32).abs().max() / top32]).tolist()
    return dict(zip(("rel_err", "vs_cpu_f32", "cpu_bf16_vs_f32", "f32"), errs))


def phase_train_check(dev: torch.device, arch: str, conditioned: bool = False,
                      seq: int = CHECK_SEQ, rows: int = CHECK_BATCH, layers: int = 2) -> None:
    """One training step of ``arch`` at full width, ``layers`` layers (and the MTP
    block where the config has one), up to the optimizer's update
    (``one_train_step``), on the card against the same step on the CPU
    from the same parameters (``Model.init(0)`` on the card, copied to the
    host; with ``conditioned`` through ``condition_attention`` first) and one
    seeded packed batch of ``rows`` rows of ``seq`` tokens (``train_batch``:
    MusicGen's four codebooks, InternVL2's vision prefix): the loss (and the
    MTP loss beside it), the global gradient norm and each gradient leaf's
    largest difference over its largest |value|, in two checks.

    f32 (the config at ``dtype="float32"``, TF32 off): every one of them
    within 1e-4, the bar the CPU tests hold the port's f32 gradients to
    against the reference.  A wrong rounding or a dropped term fails here.

    bf16 (the config as it trains): loss and grad norm within 2e-2.  A bf16
    gradient is only as good as bf16's rounding, which moves the CPU's own
    bf16 gradient 1-4% of the largest value off its f32 one; two bf16 runs
    differ by about 1.4x that.  So a leaf is held, on the card, to the CPU's
    f32 gradient of the same step: within 2e-2 or within 1.5x the CPU's own
    bf16 rounding of that leaf, whichever is larger; its difference from the
    CPU's bf16 leaf is reported beside it.  None of the steps launches any
    of K1-K4.

    MoE configs: the CPU's bf16 step runs first and records each layer's
    expert choices, and the CPU's f32 step and both card steps replay them
    (``phase_model_check`` says why), so every gradient compared, the f32
    one that bf16 leaves are held to included, is taken on the same
    routes; each step's own choices that differ from the CPU's in its dtype
    are printed with the expert leaves they would reach, a swap at a gap
    over SWAP_GAP (bf16) or SWAP_GAP_F32 (f32) fails, and the f32 aux loss
    must be non-zero and within 1e-4 of the CPU's."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.tree import tree_items, tree_map

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("train_check needs TF32 off: torch.backends.cuda.matmul.allow_tf32 is set")
    cfg = dataclasses.replace(get_config(arch), num_layers=layers)
    f32 = dataclasses.replace(cfg, dtype="float32")
    t0 = time.monotonic()
    marks = [t0]

    def mark():
        marks.append(time.monotonic())

    # drawn on the card and copied over: DeepSeek-V3's 3.12 B took 26.2 s to draw on the CPU, 3.5 s so
    # (probes_torch/train_step_cpu_profile.py, NVIDIA H100 80GB HBM3, 700.00 W)
    host = tree_map(lambda t: t.cpu(), Model(cfg).init(seed=0, device=dev))
    if conditioned:
        condition_attention(cfg, host)
    batch = train_batch(cfg, rows, seq, seed=6)
    has_moe = moe_layers(cfg) > 0
    mark()
    cpu_m, cpu_g, cpu_r = one_train_step(cfg, torch.device("cpu"), tree_map(lambda t: t.clone(), host), batch)
    routes = cpu_r.idx if has_moe else None  # the CPU bf16 step's expert choices, replayed by the other three
    mark()
    cpu32_m, f32_g, cpu32_r = one_train_step(
        f32, torch.device("cpu"), tree_map(lambda t: t.to(torch.float32, copy=True), host), batch, routes)
    mark()
    cpu_s = time.monotonic() - t0
    _zero_kernel_launches()
    card_m, card_g, card_r = one_train_step(cfg, dev, tree_map(lambda t: t.to(dev, copy=True), host), batch, routes)
    mark()
    card32_m, card32_g, card32_r = one_train_step(
        f32, dev, tree_map(lambda t: t.to(dev, torch.float32, copy=True), host), batch, routes)
    sync(dev)
    mark()
    launches = _kernel_launches()
    release_card()  # what the card steps left in reference cycles, before the leaves come over
    names = [k for k, _ in tree_items(host)]
    leaves, leaves32, over = {}, {}, {}
    for name, *four in zip(names, card_g, cpu_g, f32_g, card32_g):
        errs = leaf_errors(dev, name, *four)
        leaves[name], leaves32[name] = {k: errs[k] for k in ("rel_err", "vs_cpu_f32", "cpu_bf16_vs_f32")}, errs["f32"]
        if leaves[name]["vs_cpu_f32"] > max(MODEL_REL, OWN_ROUNDING * leaves[name]["cpu_bf16_vs_f32"]):
            over[name] = leaves[name]
    mtp = ("loss_mtp",) if cfg.mtp else ()
    scalars = {k: abs(card_m[k] - cpu_m[k]) / abs(cpu_m[k]) for k in ("loss", "grad_norm", *mtp)}
    scalar_names = ("loss", "grad_norm", *mtp, *(("aux",) if has_moe else ()))
    scalars32 = {k: abs(card32_m[k] - cpu32_m[k]) / abs(cpu32_m[k]) for k in scalar_names}
    over.update({f"f32 {k}": v for k, v in leaves32.items() if v > TRAIN_F32_REL})
    moe_row = {}
    if has_moe:  # the aux loss, and every route the two steps took differently
        moe_row = {"aux": {"card": card_m["aux"], "cpu": cpu_m["aux"], "card_f32": card32_m["aux"],
                           "cpu_f32": cpu32_m["aux"]},
                   "routes": {"bf16": train_route_differences(cfg, cpu_r.probs, card_r.probs),
                              "f32": train_route_differences(f32, cpu32_r.probs, card32_r.probs),
                              "records": len(card_r.probs), "pairs_a_record": rows * seq,
                              "f32_probs_max_abs_diff": max(float(np.abs(a - b).max())
                                                            for a, b in zip(cpu32_r.probs, card32_r.probs)),
                              "note": "every step replays the CPU bf16 step's choices; these are the forward "
                                      "pass's own choices on the card that differ from the CPU's in its dtype, "
                                      "with the expert leaves they would reach"}}
        if not card32_m["aux"] > 0:
            over["f32 aux"] = moe_row["aux"]
        for name, gap_bar in (("bf16", SWAP_GAP), ("f32", SWAP_GAP_F32)):
            if max((r["gap"] for r in moe_row["routes"][name] if r["kind"] == "swap"), default=0.0) > gap_bar:
                over[f"{name} route swapped at a gap over {gap_bar}"] = moe_row["routes"][name]
    emit({"phase": "train_check", "arch": cfg.name, "layers": cfg.num_layers, "mtp": cfg.mtp, "d_model": cfg.d_model,
          "params": Model(cfg).param_count(), "batch": rows, "seq": seq, "dtype": cfg.dtype,
          "weights": conditioned_weights(cfg) if conditioned else "seed 0",
          "documents_in_batch": int(batch["segment_ids"].max()) + 1,
          **{k: {"card": card_m[k], "cpu": cpu_m[k]} for k in ("loss", "grad_norm", *mtp)},
          "rel_err": scalars, "max_leaf_rel_err": max(v["rel_err"] for v in leaves.values()),
          "leaves": leaves, "bar": f"loss, grad_norm (loss_mtp): card vs cpu <= {MODEL_REL}; a leaf: vs_cpu_f32 <= "
          f"max({MODEL_REL}, {OWN_ROUNDING} x cpu_bf16_vs_f32), of the largest |cpu value|",
          "f32": {**{k: {"card": card32_m[k], "cpu": cpu32_m[k]} for k in ("loss", "grad_norm", *mtp)},
                  "rel_err": scalars32, "max_leaf_rel_err": max(leaves32.values()), "leaves": leaves32,
                  "bar": f"loss, grad_norm (loss_mtp, aux) and every leaf: card vs cpu <= {TRAIN_F32_REL} of "
                  "the largest |cpu value|, TF32 off"},
          **moe_row, "kernel_launches": launches, "cpu_seconds": cpu_s, "seconds": time.monotonic() - t0,
          "seconds_by_part": dict(zip(("init_and_copy", "cpu_bf16_step", "cpu_f32_step", "card_bf16_step",
                                       "card_f32_step", "compare"),
                                      np.diff([*marks, time.monotonic()]).tolist())),
          "parts_note": "each step's seconds include copying the parameters over; each step's gradients stay "
                        "where they were computed"})
    if any(v > MODEL_REL for v in scalars.values()) or any(v > TRAIN_F32_REL for v in scalars32.values()) or over:
        raise AssertionError(f"train_check {arch} over the bar: {scalars} {scalars32} {over}")
    if any(launches.values()):
        raise AssertionError(f"train_check {arch} launched a kernel: {launches}")


# the parts of a dense QKV-bias model's parameter tree (keystr -> the part of a leaf) that the AdamW update
# check holds: every layer's QKV biases, layer 0's wq, and the first ADAMW_CHECK_ROWS rows of layer 0's
# w_down and of the embedding
_BLOCK0 = "['segments'][0]['blocks'][0]"
ADAMW_CHECK_PICKS = {
    **{f"{_BLOCK0}['mixer']['{b}']": lambda t: t for b in ("bq", "bk", "bv")},
    f"{_BLOCK0}['mixer']['wq']": lambda t: t[0],
    f"{_BLOCK0}['ffn']['w_down']": lambda t: t[0, :ADAMW_CHECK_ROWS],
    "['embed']['tok']": lambda t: t[:, :ADAMW_CHECK_ROWS],
}


class UpdateCapture:
    """Inside the block, the first call of ``launch.steps.apply_update`` (a
    train step's update, after its gradients are summed) runs ``update``
    (the optimizer's own unless given) and keeps on the host the ``picks``
    (``ADAMW_CHECK_PICKS``) of the parameters, gradients and both moments
    before it and of the parameters and moments after it, with the step,
    the optimizer's config and the update's metrics (the card's global
    gradient norm and learning rate).  Later calls run ``update`` alone."""

    def __init__(self, picks: dict, update=None):
        self.picks, self.update = picks, update
        self.before = self.after = self.metrics = self.opt_cfg = self.step = self.peak_before_update = None

    def __enter__(self):
        from repro_torch.launch import steps

        self._steps, self._real = steps, steps.apply_update
        steps.apply_update = self._apply
        return self

    def __exit__(self, *exc) -> None:
        self._steps.apply_update = self._real

    def _take(self, trees: dict) -> dict:
        from repro_torch.tree import tree_items

        flat = {k: dict(tree_items(tree)) for k, tree in trees.items()}
        return {name: {k: pick(flat[k][name]).detach().to("cpu", copy=True) for k in trees}
                for name, pick in self.picks.items()}

    def _apply(self, opt_cfg, params, grads, state):
        update = self.update or self._real
        if self.before is not None:
            return update(opt_cfg, params, grads, state)
        self.opt_cfg, self.step = opt_cfg, int(state["step"]) + 1
        dev = state["step"].device
        if dev.type == "cuda":  # the forward and backward passes' peak, before the update's temporaries
            self.peak_before_update = torch.cuda.max_memory_allocated(dev)
        self.before = self._take({"p": params, "g": grads, "m": state["m"], "v": state["v"]})
        params, state, metrics = update(opt_cfg, params, grads, state)
        self.after = self._take({"p": params, "m": state["m"], "v": state["v"]})
        self.metrics = {k: float(v) for k, v in metrics.items()}
        return params, state, metrics


def adamw_host_update(opt_cfg, p, g, m, v, step: int, lr: float, grad_norm: float) -> tuple:
    """``optim.apply_update``'s AdamW arithmetic for one leaf, written out
    here and run where the tensors lie (the host), op for op in f32: the
    gradient scaled by the clip from ``grad_norm`` (the whole tree's global
    norm, not this leaf's), the moments, the bias corrections of ``step``,
    weight decay, and ``lr``.  Returns the parameter and both moments after
    the step, each cast to its dtype."""
    f32 = torch.float32
    gnorm = torch.tensor(grad_norm, dtype=f32)
    scale = torch.clamp(opt_cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0) if opt_cfg.clip_norm else 1.0
    t = torch.tensor(step, dtype=f32)
    bc1, bc2 = 1.0 - opt_cfg.b1 ** t, 1.0 - opt_cfg.b2 ** t
    g = g.float() * scale
    m32 = opt_cfg.b1 * m.float() + (1 - opt_cfg.b1) * g
    v32 = opt_cfg.b2 * v.float() + (1 - opt_cfg.b2) * g * g
    delta = (m32 / bc1) / (torch.sqrt(v32 / bc2) + opt_cfg.eps)
    delta = delta + opt_cfg.weight_decay * p.float()
    return (p.float() - torch.tensor(lr, dtype=f32) * delta).to(p.dtype), m32.to(m.dtype), v32.to(v.dtype)


def adamw_update_check(cap: UpdateCapture, grad_norm: float | None = None) -> dict:
    """The ``adamw_bf16`` update of the captured parts (``cap``) held to
    ``adamw_host_update`` on the host from the same parameters, gradients
    and moments: the parameters and both moments after the step within one
    bf16 ulp an element.  The moments must be bf16, and so must the
    parameters held.  The clip takes ``grad_norm``, by default the norm the
    update reported (the whole tree's); ``clip_active`` says whether it
    scaled the gradients.  The host takes each part in pieces of
    ADAMW_CHECK_PIECE elements, which its caches hold.  ``over`` names each
    part over the bar."""
    opt = cap.opt_cfg
    gnorm = cap.metrics["grad_norm"] if grad_norm is None else grad_norm
    leaves, over = {}, {}
    for name, b in cap.before.items():
        a = cap.after[name]
        dtypes = {f"{when} {k}": t.dtype for when, d in (("before", b), ("after", a)) for k, t in d.items() if k != "g"}
        if set(dtypes.values()) != {torch.bfloat16}:
            raise AssertionError(f"adamw update check {name}: the moments and parameters must be bf16: {dtypes}")
        b, a = ({k: t.reshape(-1) for k, t in d.items()} for d in (b, a))
        # at warmup's first lr (3e-6) an update under half a bf16 ulp leaves a parameter as it was
        row = {"shape": list(cap.before[name]["p"].shape), "params_changed": 0,
               **{k: {"max_ulps": 0, "at_one_ulp": 0} for k in ("p", "m", "v")}}
        for i in range(0, b["p"].numel(), ADAMW_CHECK_PIECE):
            piece = slice(i, i + ADAMW_CHECK_PIECE)
            want = adamw_host_update(opt, *(b[k][piece] for k in ("p", "g", "m", "v")), cap.step,
                                     cap.metrics["lr"], gnorm)
            row["params_changed"] += int((a["p"][piece] != b["p"][piece]).sum())
            for key, w in zip(("p", "m", "v"), want):
                got = a[key][piece]
                differ = got.view(torch.int16) != w.view(torch.int16)
                if differ.any():
                    ulps = bf16_ulp_steps(got[differ], w[differ])
                    row[key]["max_ulps"] = max(row[key]["max_ulps"], int(ulps.max()))
                    row[key]["at_one_ulp"] += int((ulps == 1).sum())
        leaves[name] = row
        if max(row[k]["max_ulps"] for k in ("p", "m", "v")) > 1:
            over[name] = row
    return {"kind": opt.kind, "step": cap.step, "grad_norm": gnorm, "clip_norm": opt.clip_norm,
            "clip_active": bool(opt.clip_norm and gnorm > opt.clip_norm), "lr": cap.metrics["lr"],
            "moments": "bfloat16", "leaves": leaves, "over": over,
            "bar": "params, m and v after the step: host vs card <= 1 bf16 ulp an element"}


def phase_train(dev: torch.device, arch: str, steps: int, resume: bool, layers: int | None = None,
                drawn: int | None = None, update_check: bool = False) -> None:
    """The training path at full width and depth (or cut to ``layers``):
    ``build_lm_loader`` on the card feeding ``Trainer.fit`` on ``arch``,
    seed-0 weights, seq 4096, global batch 8 at the config's own
    ``grad_accum["train_4k"]``.  Each step's time runs to its end on the
    card.  With ``resume`` a checkpoint is saved at step ``TRAIN_CKPT_AT``,
    and a fresh ``Trainer.from_checkpoint`` must restore the parameters and
    optimizer state bit for bit, the step and the sampler (``check_resume``),
    then take the steps after it in place of the trainer that saved it
    (``data_wait_frac`` is the resumed trainer's).  No step runs under the
    profiler: at 130-280 K
    kernel launches a step that took 40-80 s, and PERF.md §5 keeps the
    traces of PRs 19-23.  With ``drawn`` the leaves the reference
    initialises to zeros (QKV biases) are drawn from that seed
    (``draw_zero_leaves``).  With ``update_check`` step 1's update is
    captured (``UpdateCapture``: its seconds count in step 1's time) and
    held to the host's (``adamw_update_check``).  The moments must be in
    the dtype the config's optimizer names (bf16 for ``adamw_bf16``); an
    MTP config's LM and MTP losses are read apart and must be finite.
    K1-K4 must not launch."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import CheckpointableSampler, SyntheticTokenDataset, build_lm_loader
    from repro_torch.runtime import Trainer, TrainerConfig
    from repro_torch.tree import tree_items, tree_map

    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    shape = ShapeConfig("train_4k", TRAIN_SEQ, TRAIN_BATCH, "train")
    accum = cfg.grad_accum["train_4k"]
    step_ms: list[float] = []
    row: dict = {"phase": "train", "arch": cfg.name, "layers": cfg.num_layers, "d_model": cfg.d_model,
                 "vocab": cfg.vocab_size, "dtype": cfg.dtype, "seq": TRAIN_SEQ, "global_batch": TRAIN_BATCH,
                 "grad_accum": accum, "microbatch": TRAIN_BATCH // accum, "steps": steps, "remat": cfg.remat}

    def loader():
        ds = SyntheticTokenDataset(10_000, vocab=cfg.vocab_size)
        sampler = CheckpointableSampler(len(ds), batch_size=8, seed=0)
        return build_lm_loader(ds, seq_len=TRAIN_SEQ, batch_size=TRAIN_BATCH, sampler=sampler, device=dev)

    def timed(fn):
        def run(*args):
            sync(dev)
            t0 = time.perf_counter()
            out = fn(*args)
            sync(dev)
            step_ms.append((time.perf_counter() - t0) * 1e3)
            return out
        return run

    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as d:
        tcfg = TrainerConfig(ckpt_dir=d, ckpt_every=TRAIN_CKPT_AT if resume else 10**9, ckpt_keep=1, log_every=1)
        t0 = time.monotonic()
        trainer = Trainer(cfg, shape, tcfg=tcfg, device=dev)
        row["params"] = trainer.model.param_count()
        if drawn is not None:
            row["drawn"] = draw_zero_leaves(trainer.params, drawn)
        row["state_bytes"] = sum(t.numel() * t.element_size()
                                 for _, t in tree_items({"p": trainer.params, "o": trainer.opt_state}))
        row["optimizer"] = trainer.opt_cfg.kind
        row["moments"] = sorted({str(t.dtype) for _, t in tree_items({"m": trainer.opt_state["m"],
                                                                     "v": trainer.opt_state["v"]})})
        trainer.bundle.fn = timed(trainer.bundle.fn)
        pipe, sampler = loader()
        _zero_kernel_launches()
        history, peaks = [], []
        first = TRAIN_CKPT_AT if resume else steps
        capture = UpdateCapture(ADAMW_CHECK_PICKS) if update_check else contextlib.nullcontext()
        with pipe.auto_stop():
            torch.cuda.reset_peak_memory_stats(dev)
            with capture:
                history += trainer.fit(pipe, steps=first, sampler=sampler)["history"]
            peaks.append(torch.cuda.max_memory_allocated(dev))
        if resume:
            row["resume"], trainer, pipe, sampler = check_resume(dev, cfg, shape, tcfg, trainer, loader)
            trainer.manager.every = 10**9  # the one checkpoint is step TRAIN_CKPT_AT's
            trainer.bundle.fn = timed(trainer.bundle.fn)
            release_card()  # the trainer that saved the checkpoint
            torch.cuda.reset_peak_memory_stats(dev)
            with pipe.auto_stop():
                history += trainer.fit(pipe, steps=steps - first, sampler=sampler)["history"]
            peaks.append(torch.cuda.max_memory_allocated(dev))
        health = {**trainer.health(), "data_wait_s": trainer.data_wait_s, "step_s": trainer.step_s}
        launches = _kernel_launches()
    tokens = TRAIN_BATCH * TRAIN_SEQ
    step_ms, history = step_ms[:steps], history[:steps]
    steady = statistics.median(step_ms[1:])
    row.update({
        "step_ms": step_ms, "first_step_ms": step_ms[0], "step_ms_median_2_on": steady,
        "tokens_per_step": tokens, "tokens_per_s": tokens / steady * 1e3,
        **health,
        "loss": {h["step"]: h["loss"] for h in history if h["step"] in (1, steps)},
        "grad_norm": {h["step"]: h["grad_norm"] for h in history if h["step"] in (1, steps)},
        "losses": [h["loss"] for h in history],
        **({"loss_lm": [h["loss_lm"] for h in history], "aux": [h["aux"] for h in history]}
           if moe_layers(cfg) else {}),
        **({"loss_lm": [h["loss_lm"] for h in history], "loss_mtp": [h["loss_mtp"] for h in history]}
           if cfg.mtp else {}),
        "max_memory_allocated_gb": max(peaks) / 1e9, "kernel_launches": launches,
        "reading": "the timings and bytes are readings, not gates", "seconds": time.monotonic() - t0,
    })
    if update_check:
        t_check = time.monotonic()
        row["adamw_update_check"] = adamw_update_check(capture)
        row["adamw_update_check"]["seconds"] = time.monotonic() - t_check
        peak = capture.peak_before_update
        row["max_memory_allocated_before_update_gb"] = None if peak is None else peak / 1e9
    emit(row)
    if update_check and row["adamw_update_check"]["over"]:
        raise AssertionError(f"train {arch}: the update is over the bar: {row['adamw_update_check']['over']}")
    if len(history) != steps or not all(math.isfinite(h["loss"]) for h in history):
        raise AssertionError(f"train {arch}: {len(history)} of {steps} steps, losses {row['losses']}")
    if cfg.mtp and not all(math.isfinite(x) for x in row["loss_lm"] + row["loss_mtp"]):
        raise AssertionError(f"train {arch}: LM losses {row['loss_lm']}, MTP losses {row['loss_mtp']}")
    want_moments = ["torch.bfloat16"] if row["optimizer"] == "adamw_bf16" else ["torch.float32"]
    if row["moments"] != want_moments:
        raise AssertionError(f"train {arch}: {row['optimizer']} moments in {row['moments']}, not {want_moments}")
    if any(launches.values()):
        raise AssertionError(f"train {arch} launched a kernel: {launches}")


def phase_train_steps(dev: torch.device, arch: str, steps: int, layers: int | None = None) -> None:
    """MusicGen-medium (codebook labels) and InternVL2-2B (a vision prefix)
    at ``train_4k``'s sequence, full width (cut to ``layers``): the step
    ``build_step`` builds for ``train_4k``'s shape cut to TRAIN_BATCH rows,
    at the config's own ``grad_accum["train_4k"]``, seed-0 weights, fed
    ``train_batch`` (seed = the step), which is what ``train_check`` feeds
    them at 2 layers; each step's time runs to its end on the card.  Not
    ``Trainer.fit`` on ``build_lm_loader``: the reference's training loop
    feeds that loader's plain token rows to every arch, and a loader of
    codebooks or vision embeddings is a feature the reference lacks.
    Readings: each step's ms, positions a second, the losses (which must be
    finite), the gradients' norm, the peak of ``max_memory_allocated``
    beside the parameters' and moments' bytes.  K1-K4 must not launch."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import SHAPES
    from repro_torch.launch.steps import build_step
    from repro_torch.optim import init_opt_state
    from repro_torch.tree import tree_items

    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    shape = dataclasses.replace(SHAPES["train_4k"], global_batch=TRAIN_BATCH)
    accum = cfg.grad_accum["train_4k"]
    t0 = time.monotonic()
    release_card()
    torch.cuda.reset_peak_memory_stats(dev)
    bundle = build_step(cfg, shape, dev)
    params = bundle.model.init(seed=0, device=dev)
    opt_state = init_opt_state(bundle.opt_cfg, params)
    state_bytes = sum(t.numel() * t.element_size() for _, t in tree_items({"p": params, "o": opt_state}))
    _zero_kernel_launches()
    step_ms, metrics = [], []
    for step in range(steps):
        batch = train_batch(cfg, TRAIN_BATCH, shape.seq_len, seed=step)
        sync(dev)
        start = time.perf_counter()
        params, opt_state, m = bundle.fn(params, opt_state, batch)
        sync(dev)
        step_ms.append((time.perf_counter() - start) * 1e3)
        metrics.append({k: float(v) for k, v in m.items()})
    launches = _kernel_launches()
    positions = TRAIN_BATCH * shape.seq_len
    steady = statistics.median(step_ms[1:])
    row = {"phase": "train", "arch": cfg.name, "layers": cfg.num_layers, "d_model": cfg.d_model,
           "vocab": cfg.vocab_size, "dtype": cfg.dtype, "seq": shape.seq_len, "global_batch": TRAIN_BATCH,
           "grad_accum": accum, "microbatch": TRAIN_BATCH // accum, "steps": steps, "remat": cfg.remat,
           "fed_by": "build_step(train_4k cut to 8 rows) on train_batch, the step's seed",
           **({"codebooks": cfg.n_codebooks} if cfg.n_codebooks > 1 else {}),
           **({"vision_prefix": cfg.vis_prefix_len} if cfg.vis_prefix_len else {}),
           "params": bundle.model.param_count(), "state_bytes": state_bytes,
           "step_ms": step_ms, "first_step_ms": step_ms[0], "step_ms_median_2_on": steady,
           "positions_per_step": positions, "positions_per_s": positions / steady * 1e3,
           "losses": [m["loss"] for m in metrics], "grad_norm": [m["grad_norm"] for m in metrics],
           "max_memory_allocated_gb": torch.cuda.max_memory_allocated(dev) / 1e9, "kernel_launches": launches,
           "reading": "the timings and bytes are readings, not gates", "seconds": time.monotonic() - t0}
    emit(row)
    if len(metrics) != steps or not all(math.isfinite(x) for x in row["losses"]):
        raise AssertionError(f"train {arch}: losses {row['losses']}")
    if any(launches.values()):
        raise AssertionError(f"train {arch} launched a kernel: {launches}")


def check_resume(dev, cfg, shape, tcfg, trainer, loader) -> tuple:
    """A fresh ``Trainer.from_checkpoint`` in the trainer's directory must hold
    the trainer's state bit for bit (it took no step since its save), the
    saved step and the saved sampler state.  Returns its row, the resumed
    trainer and its loader (pipeline and sampler), to take the later steps."""
    from repro_torch.runtime import Trainer
    from repro_torch.tree import tree_items

    ckpt = pathlib.Path(tcfg.ckpt_dir) / f"step_{TRAIN_CKPT_AT:08d}"
    saved_sampler = json.loads((ckpt / "meta.json").read_text())["sampler"]
    pipe, sampler = loader()
    t0 = time.monotonic()
    resumed = Trainer.from_checkpoint(cfg, shape, sampler=sampler, tcfg=tcfg, device=dev)
    restore_s = time.monotonic() - t0
    want = dict(tree_items({"p": trainer.params, "o": trainer.opt_state}))
    got = dict(tree_items({"p": resumed.params, "o": resumed.opt_state}))
    unequal = [k for k in want if not (got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]))]
    out = {"step": resumed.step, "leaves": len(want), "unequal_leaves": unequal,
           "sampler_restored": sampler.state_dict() == saved_sampler, "restore_s": restore_s,
           "ckpt_bytes": (ckpt / "arrays.npz").stat().st_size,
           "snapshot_ms": trainer.manager.snapshot_ms,
           "later_steps": f"steps {TRAIN_CKPT_AT + 1}.. are the resumed trainer's"}
    if out["step"] != TRAIN_CKPT_AT or unequal or not out["sampler_restored"]:
        raise AssertionError(f"resume: {out}")
    return out, resumed, pipe, sampler


def example_module(name: str):
    """``examples_torch/<name>.py``, the torch twin of ``examples/<name>.py``."""
    spec = importlib.util.spec_from_file_location(f"examples_torch_{name}", ROOT / "examples_torch" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def quiet(fn, *args, **kwargs):
    """``fn``'s result and the lines it printed, kept out of this script's
    output (one JSON object a line)."""
    with contextlib.redirect_stdout(io.StringIO()) as printed:
        out = fn(*args, **kwargs)
    return out, printed.getvalue().splitlines()


def count_launches(summary: dict, path: str, launches: dict) -> None:
    for name, n in launches.items():
        if n:
            summary[name]["launches"] += n
            by_path = summary[name].setdefault("launches_by_path", {})
            by_path[path] = by_path.get(path, 0) + n


def phase_example_quickstart(dev: torch.device) -> None:
    """(a) Paper Listing 1 on the card: every batch (16, 64, 64, 3) uint8
    there, equal to the twin's CPU run bit for bit."""
    example = example_module("quickstart")
    t0 = time.monotonic()
    card, printed = quiet(example.main, ["--device", str(dev)])
    seconds = time.monotonic() - t0
    cpu, _ = quiet(example.main, ["--device", "cpu"])
    shapes = sorted({(tuple(b.shape), str(b.dtype), b.device.type) for b in card})
    equal = len(card) == len(cpu) and all(torch.equal(c.cpu(), h) for c, h in zip(card, cpu))
    emit({"phase": "examples", "example": "quickstart", "batches": len(card), "batch_shapes": shapes,
          "equal_to_cpu_run": equal, "seconds": seconds, "last_line": printed[-1] if printed else None})
    if len(card) != 4 or shapes != [((16, 64, 64, 3), "torch.uint8", dev.type)] or not equal:
        raise AssertionError("quickstart: a batch is not (16, 64, 64, 3) uint8 on the card or differs from the CPU's")


def held_to_plain_and_oracle(calls: list, augment: bool) -> dict:
    """The recorded kernel calls' outputs against the plain version and the
    ``ref.py`` oracle on the same inputs: the worst ``compare`` of each."""
    from repro_torch.kernels import dequant_normalize as dn
    from repro_torch.kernels import ref

    worst: dict[str, dict] = {}
    for x, args, kwargs, y in calls:
        if augment:
            mean, std, flip, crop = (*args, None, None)[:4]
            plain = dn.dequant_normalize_augment_plain(x, mean, std, flip, crop, **kwargs)
            oracle = ref.dequant_normalize_augment_ref(x, mean, std, flip=flip, crop=crop, **kwargs)
        else:
            plain = dn.dequant_normalize_plain(x, *args, **kwargs)
            oracle = ref.dequant_normalize_ref(x, *args, **kwargs)
        for key, want in (("vs_plain", plain), ("vs_oracle", oracle)):
            row = compare(y, want)
            if key not in worst or (row["over_bar"], row["max_abs_err"]) > (worst[key]["over_bar"], worst[key]["max_abs_err"]):
                worst[key] = row
    return worst


# the kernel each section of the imagenet twin decodes its batches with
IMAGENET_DECODER = {"hot_path": "dequant_normalize_augment",
                    **dict.fromkeys(("local", "remote", "http", "peers", "projection", "per_file"), "dequant_normalize")}


def phase_example_imagenet(dev: torch.device, summary: dict) -> None:
    """(b) Every section of the imagenet twin on the card at its sizes (96
    frames of 128x128 resized to 112x112, batch 16), its trace written under
    a temporary directory; one line a section: images/s, the K1 and K2
    launches and, for the traced section, its span count.  Every K1 and K2
    output is held against its plain version and its ``ref.py`` oracle
    (1 bf16 ulp), and each kernel launches once a decoded batch; the hot
    path's warm-up call, as in the reference, is one K1 launch more."""
    from repro_torch.kernels import ops

    example = example_module("imagenet_pipeline")
    k1, k2 = [], []

    def recorded(fn, log):
        def call(x, *args, **kwargs):
            y = fn(x, *args, **kwargs)
            log.append((x, args, kwargs, y))
            return y
        return call

    real_k2, real_k1 = example.dequant_normalize, ops.dequant_normalize_augment
    example.dequant_normalize = recorded(real_k2, k2)
    ops.dequant_normalize_augment = recorded(real_k1, k1)  # DeviceTransfer's device_decode calls it through ops
    trace_before = os.environ.get("REPRO_TRACE_PATH")
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_imagenet_") as d:
            os.environ["REPRO_TRACE_PATH"] = str(pathlib.Path(d) / "imagenet_trace.json")
            _zero_kernel_launches()
            sections = example.run(d, dev)
            while True:
                report, printed = quiet(next, sections, None)
                if report is None:
                    break
                sync(dev)
                launches = _kernel_launches()
                _zero_kernel_launches()
                section = report["section"]
                row = {"phase": "examples", "example": "imagenet_pipeline", **report, "printed_lines": len(printed),
                       "k1_launches": launches["dequant_normalize_augment"], "k2_launches": launches["dequant_normalize"]}
                if "seconds" in report:
                    row["images_per_s"] = report["images"] / report["seconds"]
                for key, worst in held_to_plain_and_oracle(k1, True).items():
                    row[f"k1_{key}"] = worst
                for key, worst in held_to_plain_and_oracle(k2, False).items():
                    row[f"k2_{key}"] = worst
                emit(row)
                decoded = {"dequant_normalize_augment": len(k1) - (section == "hot_path"), "dequant_normalize": len(k2)}
                expect = dict.fromkeys(decoded, 0)
                if section in IMAGENET_DECODER:
                    expect[IMAGENET_DECODER[section]] = example.FRAMES // example.BATCH
                calls = {"dequant_normalize_augment": len(k1), "dequant_normalize": len(k2), "flash_attention": 0,
                         "ssd_scan": 0}
                if decoded != expect or launches != calls:
                    raise AssertionError(f"imagenet_pipeline {section}: {launches} launches for {decoded} batches")
                if report.get("images", example.FRAMES) != example.FRAMES:
                    raise AssertionError(f"imagenet_pipeline {section}: {report['images']} images")
                if any(row[key]["over_bar"] for key in row if key.endswith(("vs_plain", "vs_oracle"))):
                    raise AssertionError(f"imagenet_pipeline {section}: a decoded batch over the bar")
                for name, key in (("dequant_normalize_augment", "k1_vs_plain"), ("dequant_normalize", "k2_vs_plain")):
                    if key in row:
                        summary[name]["max_abs_err"] = max(summary[name]["max_abs_err"], row[key]["max_abs_err"])
                count_launches(summary, "examples imagenet_pipeline", launches)
                k1.clear()
                k2.clear()
    finally:
        example.dequant_normalize, ops.dequant_normalize_augment = real_k2, real_k1
        if trace_before is None:
            os.environ.pop("REPRO_TRACE_PATH", None)
        else:
            os.environ["REPRO_TRACE_PATH"] = trace_before


def phase_example_serve(dev: torch.device, summary: dict) -> None:
    """(c) The serve_llm twin as it stands (smoke Yi-6B on the card, its
    five prompts), then its ``serve`` at Yi-6B's and OLMo-1B's full width
    and depth (``phase_serve``)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import flash_attention as fa

    example = example_module("serve_llm")
    fa.flash_attention.launches = 0
    t0 = time.monotonic()
    results, printed = quiet(example.main, ["--device", str(dev)])
    seconds = time.monotonic() - t0
    launches = fa.flash_attention.launches
    layers = get_smoke_config("yi-6b").num_layers
    batches = -(-len(example.PROMPTS) // 4)
    emit({"phase": "examples", "example": "serve_llm", "config": "yi-6b smoke", "results": len(results),
          "tokens_per_result": sorted({len(r.token_ids) for r in results}), "k3_launches": launches,
          "printed_lines": len(printed), "seconds": seconds})
    if len(results) != len(example.PROMPTS) or any(len(r.token_ids) != 8 for r in results):
        raise AssertionError("serve_llm: a prompt did not get its 8 tokens")
    if launches != layers * batches:
        raise AssertionError(f"serve_llm: K3 launched {launches} times, not {layers} in each of {batches} prefills")
    count_launches(summary, "examples serve_llm (smoke)", {"flash_attention": launches})
    for arch in ("yi-6b", "olmo-1b"):
        for dtype in ("float32", "bfloat16"):
            phase_model_check(dev, arch, CHECK_SEQ_DENSE, dtype=dtype, conditioned=CONDITIONED[arch, dtype])
        phase_serve(dev, summary, arch, example=example)
        release_card()


def phase_example_train(dev: torch.device) -> None:
    """(d) The train_lm twin at its defaults on the card (qwen3 widened to
    d_model 512, 8 layers, vocab 50304; seq 128, batch 8, a checkpoint
    every 100) for TRAIN_LM_FIRST_STEPS steps into a temporary directory, then a second run on
    the same directory, which must start at the saved step with the
    checkpoint's parameters bit for bit, and train TRAIN_LM_RESUMED_STEPS
    more."""
    from repro_torch.ckpt import load_checkpoint
    from repro_torch.tree import tree_items

    example = example_module("train_lm")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_lm_") as d:
        argv = ["--ckpt-dir", d, "--device", str(dev)]
        rows = []
        for call, args in (("first", example.parse_args([*argv, "--steps", str(TRAIN_LM_FIRST_STEPS)])),
                           ("second", example.parse_args([*argv, "--steps", str(TRAIN_LM_RESUMED_STEPS)]))):
            (trainer, pipe, sampler), printed = quiet(example.build, args)
            start = trainer.step
            row = {"phase": "examples", "example": "train_lm", "call": call, "start_step": start,
                   "params": trainer.model.param_count(), "header": printed[-1]}
            if call == "second":
                saved = load_checkpoint(d, trainer.params, trainer.opt_state)
                for key, want in (("checkpoint", saved["params"]), ("first_run", rows[0]["trainer"].params)):
                    want = dict(tree_items(want))
                    row[f"unequal_to_{key}"] = [k for k, t in tree_items(trainer.params) if not torch.equal(t, want[k])]
                row["checkpoint_step"] = saved["step"]
                del saved, want
            t0 = time.monotonic()
            out, printed = quiet(example.train, trainer, pipe, sampler, args.steps)
            row.update({"steps": trainer.step - start, "seconds": time.monotonic() - t0,
                        "step_ms": trainer.step_s / (trainer.step - start) * 1e3,
                        "data_wait_frac": out["data_wait_frac"], "starved": out["starved"],
                        "losses": {h["step"]: h["loss"] for h in out["history"]},
                        "last_line": printed[-1]})
            emit(row)
            rows.append({**row, "trainer": trainer})
            if trainer.step != start + args.steps or not all(math.isfinite(h["loss"]) for h in out["history"]):
                raise AssertionError(f"train_lm {call}: {row}")
        first, second = rows
        if second["start_step"] != first["steps"] or second["checkpoint_step"] != first["steps"] \
                or second["unequal_to_checkpoint"] or second["unequal_to_first_run"]:
            raise AssertionError(f"train_lm: the second run did not resume the first's checkpoint: {second}")
        first_loss = list(first["losses"].values())
        if not first_loss[-1] < first_loss[0]:
            raise AssertionError(f"train_lm: the loss did not fall: {first_loss}")


def phase_oracles(dev: torch.device) -> None:
    """(e) K3 on both routes at the ``ragged_rows`` shape and K4 on both
    routes at Jamba's shape (G 8) against the ``ref.py`` oracles: dense
    softmax attention, and the step-by-step SSD recurrence in f32; bars
    FA_TOL and SSD_TOL of the kernel's dtype."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as ks

    gen = torch.Generator(device="cpu").manual_seed(6)
    for dtype in (torch.bfloat16, torch.float32):
        b, h, hkv, sq, skv, hd = 1, 4, 2, 96, 192, 128
        q, k, v = (torch.randn(shape, generator=gen).to(dev, dtype)
                   for shape in ((b, h, sq, hd), (b, hkv, skv, hd), (b, hkv, skv, hd)))
        got = fa.flash_attention(q, k, v, causal=True, block_q=32, block_k=64)
        row = {"phase": "examples", "example": "oracles", "kernel": "flash_attention", "case": "ragged_rows",
               "route": fa.kernel_route(dtype, hd, 64), "q": [b, h, sq, hd], "kv": [b, hkv, skv, hd],
               "dtype": str(dtype), "oracle": "flash_attention_ref", **within_tol(got, ref.flash_attention_ref(q, k, v))}
        emit(row)
        if row["over_bar"]:
            raise AssertionError(f"flash_attention {dtype} over the bar against its oracle")
    for dtype in (torch.bfloat16, torch.float32):
        shape = (2, 128, 256, 64, 8, 128)
        x, dt, a, bb, cc = ssd_inputs(gen, *shape, dtype, dev)
        y, h_final = ks.ssd_scan(x, dt, a, bb, cc, chunk=128)
        want_y, want_h = ref.ssd_ref(x.float(), dt, a, bb.float(), cc.float())
        on_y = within_tol(y, want_y.to(dtype), SSD_TOL)
        on_h = within_tol(h_final, want_h, SSD_TOL)
        row = {"phase": "examples", "example": "oracles", "kernel": "ssd_scan", "case": "jamba",
               "route": ks.kernel_route(dtype, 64, 128), "b_l_h_p_g_n": list(shape), "chunk": 128,
               "dtype": str(dtype), "oracle": "ssd_ref (f32)", "y": on_y, "h_final": on_h}
        emit(row)
        if on_y["over_bar"] or on_h["over_bar"]:
            raise AssertionError(f"ssd_scan {dtype} over the bar against its oracle")


def phase_examples(dev: torch.device, summary: dict) -> None:
    """The four twins of examples/ on the card, (a)-(d), and (e) K3 and K4
    against the ``ref.py`` oracles (K1 and K2 are held to theirs in (b))."""
    timed("example_quickstart", phase_example_quickstart, dev)
    timed("example_imagenet", phase_example_imagenet, dev, summary)
    timed("example_serve", phase_example_serve, dev, summary)
    timed("example_train", phase_example_train, dev)
    release_card()
    timed("oracles", phase_oracles, dev)


def kernel_summary() -> dict:
    """The ``kernels`` line's entries, one a kernel, before any phase fills them."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ks

    summary = {
        name: {"name": name, "route": "cuda", "source": "src/repro_torch/kernels/csrc/dequant_normalize.cu",
               "replaces": f"src/repro/kernels/dequant_normalize.py:{line}", "launches": 0,
               "max_abs_err": 0.0, "ms": None, "plain_ms": None, "bound_ms": None, "bound_by": None,
               "library_ms": None, "library_note": f"no single PyTorch call computes {what} to NCHW"}
        for name, line, what in (
            ("dequant_normalize_augment", 89, "crop, flip, dequant and normalize"),
            ("dequant_normalize", 44, "dequant and normalize"),
        )
    }
    summary["flash_attention"] = {
        "name": "flash_attention", "route": "cuda", "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:88", "launches": 0, "max_abs_err": 0.0,
        "ms": None, "plain_ms": None, "bound_ms": None, "bound_by": None, "library_ms": None,
        # the main path's (bf16) kernel at its serving shape; f32 runs fa_cuda_f32
        "cuda_route": fa.kernel_route(torch.bfloat16, 128, 128),
    }
    summary["ssd_scan"] = {
        "name": "ssd_scan", "route": "cuda", "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:91", "launches": 0, "max_abs_err": 0.0,
        "ms": None, "plain_ms": None, "bound_ms": None, "bound_by": None, "library_ms": None,
        "library_note": "no single PyTorch call computes the SSD chunked scan",
        # the main path's (bf16) kernel, ssd_wgmma_bf16 (two passes where it splits the chunks); f32 runs ssd_cuda_f32
        "cuda_route": ks.kernel_route(torch.bfloat16, 64, 128),
    }
    return summary


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; nothing was run", file=sys.stderr)
        return 2
    try:
        from repro_torch.data import SyntheticImageDataset
    except ImportError as e:
        print(f"chip_smoke: the port is not importable from {ROOT / 'src'}: {e}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    summary = kernel_summary()
    try:
        dev = torch.device("cuda", 0)
        smi = phase_device()
        phase_build()
        timed("kernels", phase_kernels, dev, summary, smi)
        timed("flash", phase_flash, dev, summary, smi)
        timed("ssd", phase_ssd, dev, summary, smi)
        timed("model_check qwen3-0.6b 256", phase_model_check, dev, "qwen3-0.6b", 256)
        timed("model_check qwen3-0.6b 20 prefill_ragged",
              phase_model_check, dev, "qwen3-0.6b", 20, "prefill_ragged")  # padded to 64 for K3
        timed("model_check qwen3-0.6b 256 prefill_restart restart=True",
              phase_model_check, dev, "qwen3-0.6b", 256, "prefill_restart", restart=True)  # K3's position route
        timed("model_check mamba2-780m 512", phase_model_check, dev, "mamba2-780m", 512)  # two chunks of 256
        timed("model_check mamba2-780m 20 prefill_ragged_ssd",
              phase_model_check, dev, "mamba2-780m", 20, "prefill_ragged_ssd")  # one chunk of 20 for K4
        timed("moe", phase_moe, dev, smi)
        timed("model_check granite-moe-1b-a400m 256 dtype=float32 conditioned=True",
              phase_model_check, dev, "granite-moe-1b-a400m", 256, dtype="float32", conditioned=True)
        timed("model_check granite-moe-1b-a400m 256 conditioned=True",
              phase_model_check, dev, "granite-moe-1b-a400m", 256, conditioned=True)
        timed("model_check jamba-1.5-large-398b 128",
              phase_model_check, dev, "jamba-1.5-large-398b", 128)  # 1 K3 and 1 K4 launch; 23.8 GB of weights
        release_card()
        # QKV biases drawn (the reference initialises them to zeros); 10.4 GB of weights, 20.8 in f32
        for dtype in ("float32", "bfloat16"):
            timed(f"model_check qwen1.5-110b {QWEN15_CHECK_SEQ} dtype={dtype} drawn=3", phase_model_check, dev,
                  "qwen1.5-110b", QWEN15_CHECK_SEQ, dtype=dtype, conditioned=CONDITIONED["qwen1.5-110b", dtype],
                  drawn=3)
            release_card()
        timed("model_check deepseek-v3-671b 256 dtype=float32",
              phase_model_check, dev, "deepseek-v3-671b", 256, dtype="float32")  # 2 dense MLA layers; 14.8 GB
        release_card()
        # 3 dense layers, 1 MoE layer; 31.6 GB.  On the seed-0 weights the bf16 outputs sit 4.2-5.1e-2
        # from the CPU's on an H100: w_uq/w_uk drawn at fan-in over the heads make attention peaked
        timed("model_check deepseek-v3-671b 128 layers=4 conditioned=True",
              phase_model_check, dev, "deepseek-v3-671b", 128, layers=4, conditioned=True)
        release_card()
        # MusicGen: MHA, 24 heads of 64 (K3 at kv groups of 1), LayerNorm and GELU, four codebooks.
        # InternVL2: 256 vision rows, then 256 tokens; the head masks 119 padding columns of 92,672.
        # Neither has qk_norm: wq/wk drawn at fan-in over the heads make attention peaked (CONDITIONED)
        for arch, seq in (("musicgen-medium", 256), ("internvl2-2b", 512)):
            timed(f"model_check {arch} {seq} dtype=float32 conditioned=True", phase_model_check, dev, arch, seq,
                  dtype="float32", conditioned=CONDITIONED[arch, "float32"])
            timed(f"model_check {arch} {seq} conditioned=True", phase_model_check, dev, arch, seq,
                  conditioned=CONDITIONED[arch, "bfloat16"])
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as d:
            t0 = time.monotonic()
            ds = SyntheticImageDataset.materialize(d, FRAMES, hw=FRAME, seed=0)
            emit({"phase": "dataset", "frames": FRAMES, "hw": list(FRAME), "seconds": time.monotonic() - t0})
            timed("main", phase_main, ds, dev, summary)
            timed("loader_holes", phase_loader_holes, ds, dev, summary)
            timed("example", phase_example, ds, dev, summary)
            timed("shards", phase_shards, ds, pathlib.Path(d), dev, summary)
        timed("serve qwen3-0.6b", phase_serve, dev, summary, "qwen3-0.6b")  # K3
        timed("serve mamba2-780m", phase_serve, dev, summary, "mamba2-780m")  # K4
        timed("serve granite-moe-1b-a400m", phase_serve, dev, summary, "granite-moe-1b-a400m")
        release_card()
        timed("serve deepseek-v3-671b layers=4", phase_serve, dev, summary, "deepseek-v3-671b", layers=4)
        release_card()
        # K3 on the attention layer and K4 on the 3 SSD layers of each prefill; 46.1 GB of weights
        timed(f"serve jamba-1.5-large-398b layers={JAMBA_SERVE_LAYERS}",
              phase_serve, dev, summary, "jamba-1.5-large-398b", layers=JAMBA_SERVE_LAYERS)
        release_card()
        timed(f"serve qwen1.5-110b layers={QWEN15_LAYERS}", phase_serve, dev, summary, "qwen1.5-110b",
              layers=QWEN15_LAYERS)
        release_card()
        timed("serve musicgen-medium", phase_serve, dev, summary, "musicgen-medium")  # through the step builders
        timed("serve internvl2-2b", phase_serve, dev, summary, "internvl2-2b")
        release_card()
        timed("long_shapes", phase_long_shapes, dev, summary, smi)
        timed("train_check qwen3-0.6b", phase_train_check, dev, "qwen3-0.6b")
        timed("train_check mamba2-780m", phase_train_check, dev, "mamba2-780m")
        timed("train_check granite-moe-1b-a400m conditioned=True",
              phase_train_check, dev, "granite-moe-1b-a400m", conditioned=True)
        timed(f"train_check deepseek-v3-671b seq={DEEPSEEK_CHECK_SEQ} rows=1 layers={DEEPSEEK_CHECK_LAYERS}",
              phase_train_check, dev, "deepseek-v3-671b", seq=DEEPSEEK_CHECK_SEQ, rows=1,
              layers=DEEPSEEK_CHECK_LAYERS)  # a dense MLA layer + MTP
        # on the seed-0 weights an H100's f32 leaves read 1.20e-3 (MusicGen) and 6.85e-3 (InternVL2)
        timed("train_check musicgen-medium conditioned=True",
              phase_train_check, dev, "musicgen-medium", conditioned=True)
        timed("train_check internvl2-2b conditioned=True", phase_train_check, dev, "internvl2-2b", conditioned=True)
        release_card()
        # OLMo-1B: non-parametric LayerNorm and a tied head, 0.2 B in 2 layers; Yi-6B: 32 q heads over 4 kv
        # heads at d_model 4,096, 0.87 B in 2 layers, one row as DeepSeek-V3's.  Both on condition_attention's
        # weights, OLMo's f32 step too (CONDITIONED keeps seed 0 for its f32 model_check): on the seed-0
        # weights an H100's f32 OLMo leaves read up to 3.1e-3 of the CPU's, over TRAIN_F32_REL, and one f32
        # ulp in the weights moves them by up to 3.9e-3 on the card (5.3e-6 on the conditioned weights;
        # probes_torch/train_conditioning.py, NVIDIA H100 80GB HBM3, 700.00 W): the weights' conditioning
        for arch, kw in (("olmo-1b", {}), ("yi-6b", {"seq": YI_CHECK_SEQ, "rows": 1})):
            timed(f"train_check {arch} conditioned=True {kw}", phase_train_check, dev, arch, conditioned=True, **kw)
            release_card()
        timed(f"train qwen3-0.6b {TRAIN_STEPS} resume=True layers={QWEN3_TRAIN_LAYERS}", phase_train, dev,
              "qwen3-0.6b", TRAIN_STEPS, resume=True, layers=QWEN3_TRAIN_LAYERS)
        timed(f"train mamba2-780m 2 resume=False layers={MAMBA2_TRAIN_LAYERS}",
              phase_train, dev, "mamba2-780m", 2, resume=False, layers=MAMBA2_TRAIN_LAYERS)
        timed("train granite-moe-1b-a400m 2 resume=False", phase_train, dev, "granite-moe-1b-a400m", 2, resume=False)
        release_card()
        timed("train olmo-1b 2 resume=False", phase_train, dev, "olmo-1b", 2, resume=False)
        release_card()
        # adamw_bf16: step 1's update of a few leaves held to the host's; the QKV biases drawn, as its model_check
        timed(f"train qwen1.5-110b 2 resume=False layers={QWEN15_TRAIN_LAYERS} drawn=3 update_check=True",
              phase_train, dev, "qwen1.5-110b", 2, resume=False, layers=QWEN15_TRAIN_LAYERS, drawn=3,
              update_check=True)
        release_card()
        # codebook labels and a vision prefix at train_4k's sequence, through build_step on train_batch
        # the 3 dense MLA layers and the MTP block on adamw_bf16; Yi-6B on f32 moments at the depth that fits
        timed(f"train deepseek-v3-671b 2 resume=False layers={DEEPSEEK_TRAIN_LAYERS}", phase_train, dev,
              "deepseek-v3-671b", 2, resume=False, layers=DEEPSEEK_TRAIN_LAYERS)
        release_card()
        timed(f"train yi-6b 2 resume=False layers={YI_TRAIN_LAYERS}", phase_train, dev, "yi-6b", 2, resume=False,
              layers=YI_TRAIN_LAYERS)
        release_card()
        timed(f"train musicgen-medium 2 layers={MUSICGEN_TRAIN_LAYERS}", phase_train_steps, dev, "musicgen-medium", 2,
              layers=MUSICGEN_TRAIN_LAYERS)
        release_card()
        timed("train internvl2-2b 2", phase_train_steps, dev, "internvl2-2b", 2)
        release_card()
        timed("examples", phase_examples, dev, summary)
    except Exception:
        traceback.print_exc()
        return 1
    emit({"kernels": list(summary.values())})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
