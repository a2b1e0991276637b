"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> [--smoke] [--device cuda]``."""

from __future__ import annotations

import argparse


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--prompts", nargs="*", default=["hello world", "data loading is"])
    args = ap.parse_args()

    from ..configs import get_config, get_smoke_config
    from ..models import Model
    from ..runtime import BatchServer

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    params = Model(cfg).init(seed=0, device=args.device)
    server = BatchServer(cfg, params, batch_size=args.batch, max_new=args.max_new, device=args.device)
    for res in server.generate(list(args.prompts)):
        print(f"{res.prompt!r} -> {res.token_ids}")


if __name__ == "__main__":
    main()
