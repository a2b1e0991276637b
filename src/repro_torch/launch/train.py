"""Training launcher on one device:
``python -m repro_torch.launch.train --arch <id> [--smoke] [--device cuda]``.

``--smoke`` trains the reduced config at ``--seq-len``/``--batch``; without
it the full config trains at that shape, with the config's own
``grad_accum["train_4k"]`` when the sequence is 4096 tokens long.  The
production mesh waits for the distributed launcher (ROADMAP §1).
"""

from __future__ import annotations

import argparse
import logging


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--smoke", action="store_true", help="use the reduced config")
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default="checkpoints")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()
    logging.basicConfig(level=logging.INFO)

    from ..configs import get_config, get_smoke_config
    from ..configs.base import ShapeConfig
    from ..data import CheckpointableSampler, SyntheticTokenDataset, build_lm_loader
    from ..runtime import Trainer, TrainerConfig

    if args.smoke:
        cfg = get_smoke_config(args.arch)
        shape = ShapeConfig("train_smoke", args.seq_len, args.batch, "train")
    else:
        cfg = get_config(args.arch)
        name = "train_4k" if args.seq_len == 4096 else f"train_{args.seq_len}"
        shape = ShapeConfig(name, args.seq_len, args.batch, "train")

    ds = SyntheticTokenDataset(10_000, vocab=cfg.vocab_size)
    sampler = CheckpointableSampler(len(ds), batch_size=8)
    pipe, sampler = build_lm_loader(
        ds, seq_len=shape.seq_len, batch_size=shape.global_batch, sampler=sampler,
        device=args.device,
    )
    trainer = Trainer.from_checkpoint(
        cfg, shape, sampler=sampler, tcfg=TrainerConfig(ckpt_dir=args.ckpt_dir),
        device=args.device,
    )
    with pipe.auto_stop():
        out = trainer.fit(pipe, steps=args.steps, sampler=sampler)
        print(trainer.tuning_hint(pipe))
    print(out["history"][-1] if out["history"] else out)


if __name__ == "__main__":
    main()
