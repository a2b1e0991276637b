"""Batched serving example: SPDL request pipeline → prefill → greedy decode.

The twin of ``examples/serve_llm.py``: the smoke Yi-6B config, its
weights drawn from seed 0, served by the port's ``BatchServer`` on the
CUDA card (or the CPU with ``--device cpu``).  ``serve`` holds the body,
so that any config and parameters go through the same lines.

Run: PYTHONPATH=src python examples_torch/serve_llm.py [--device cpu]
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ModelConfig
from repro_torch.models import Model
from repro_torch.runtime import BatchServer
from repro_torch.runtime.server import ServeResult

PROMPTS = [
    "the paper shows that",
    "data loading is",
    "thread pools scale when",
    "the GIL prevents",
    "free-threaded python will",
]


def serve(
    cfg: ModelConfig,
    params,
    prompts: list[str],
    *,
    batch_size: int,
    prompt_len: int,
    max_new: int,
    device: torch.device | str | None = None,  # None = the card
) -> list[ServeResult]:
    """Greedy completions of ``prompts`` by ``BatchServer``, one line
    printed per result, in the prompts' order."""
    server = BatchServer(cfg, params, batch_size=batch_size, prompt_len=prompt_len, max_new=max_new,
                         device=device)
    results = server.generate(prompts)
    for res in results:
        print(f"{res.prompt!r} -> tokens {res.token_ids}")
    return results


def main(argv: list[str] | None = None) -> list[ServeResult]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    cfg = get_smoke_config("yi-6b")
    params = Model(cfg).init(0, args.device)
    return serve(cfg, params, PROMPTS, batch_size=4, prompt_len=16, max_new=8, device=args.device)


if __name__ == "__main__":
    main()
