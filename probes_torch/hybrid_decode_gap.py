"""Where the gap of ``chip_smoke.py``'s hybrid decode check comes from:
Jamba-1.5-large in 3 layers (attention + dense, SSD + MoE, SSD + dense),
1 row, capacity factor 8, the decode step after a prefill of S tokens
against the prefill of S + 1, each layer's k, v, ssm and conv (and the
logits) as a share of the largest value; in bf16 at 8,192 tokens and in
f32 (TF32 off) at 2,048, on the seed-0 weights and on
``condition_attention``'s.  Then K4 alone at Jamba's heads (1, 8192, 256,
64), G 8, N 128: the kernel at chunks 256, 16 and 1 and the plain version
at chunk 1 against the plain version at chunk 256.

    python3 probes_torch/hybrid_decode_gap.py

Needs a CUDA card.  Prints one JSON line a run."""

import dataclasses
import json
import pathlib
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402


def rel(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / want.abs().max())


def gap(dev, dtype: str, s: int, conditioned: bool) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.models import Model

    base = dataclasses.replace(get_config("jamba-1.5-large-398b"), num_layers=cs.JAMBA_LONG_LAYERS, dtype=dtype)
    moe = base.moe
    cfg = dataclasses.replace(base, moe=dataclasses.replace(moe, capacity_factor=moe.n_experts / moe.experts_per_token))
    shape, prefill, decode = cs.long_steps(cfg, "decode_32k", 1, dev)
    params = Model(cfg).init(seed=0, device=dev)
    if conditioned:
        cs.condition_attention(cfg, params)
    tokens = torch.randint(0, cfg.vocab_size, (1, s), generator=torch.Generator().manual_seed(15))
    logits, cache = prefill(params, {"tokens": tokens}, seq_cap=shape.seq_len)
    ids = logits.argmax(dim=-1)[:, None]
    step_logits, cache = decode(params, cache, ids, s)
    whole, whole_cache = prefill(params, {"tokens": torch.cat([tokens, ids.cpu()], dim=1)}, seq_cap=shape.seq_len)
    out = {"dtype": dtype, "prompt": s, "weights": "condition_attention" if conditioned else "seed 0",
           "logits": rel(step_logits[..., :cfg.vocab_size], whole[..., :cfg.vocab_size])}
    for i, (blk, want) in enumerate(zip(cache[0]["blocks"], whole_cache[0]["blocks"])):
        for name in blk:
            out[f"layer {i} {name}"] = rel(blk[name], want[name])
    return out


def k4_chunks(dev) -> dict:
    from repro_torch.kernels import ssd_scan as ks

    shape = (1, 8192, 256, 64, 8, 128)
    args = cs.ssd_inputs(torch.Generator(device=dev).manual_seed(11), *shape, torch.bfloat16, dev)
    want_y, want_h = ks.ssd_scan_plain(*args, chunk=256)
    out = {"shape": list(shape), "against": "ssd_scan_plain at chunk 256"}
    for label, fn, chunk in (("kernel chunk 256", ks.ssd_scan, 256), ("kernel chunk 16", ks.ssd_scan, 16),
                             ("kernel chunk 1", ks.ssd_scan, 1), ("plain chunk 1", ks.ssd_scan_plain, 1)):
        y, h = fn(*args, chunk=chunk)
        out[label] = {"y": rel(y, want_y), "h_final": rel(h, want_h)}
    return out


def main() -> None:
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    cs.phase_build()
    print(json.dumps({"card": cs.phase_device()}))
    print(json.dumps({"k4": k4_chunks(dev)}))
    cs.release_card()
    for conditioned in (False, True):
        for dtype, s in (("bfloat16", 8192), ("float32", 2048)):
            print(json.dumps({"gap": gap(dev, dtype, s, conditioned)}))
            cs.release_card()


if __name__ == "__main__":
    main()
