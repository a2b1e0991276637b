"""Quickstart: build an SPDL pipeline from plain functions (paper Listing 1).

The twin of ``examples/quickstart.py``: the same stages, with the port's
``DeviceTransfer`` copying each batch to the CUDA card (or, with
``--device cpu``, handing it over on the host).

Run: PYTHONPATH=src python examples_torch/quickstart.py [--device cpu]
"""

from __future__ import annotations

import argparse
import asyncio
import time

import numpy as np
import torch

from repro_torch.core import Pipeline, PipelineBuilder
from repro_torch.data.codec import decode_sample, encode_sample, resize_nearest
from repro_torch.data.transfer import DeviceTransfer


def source():
    """Yield 'URLs' (here: encoded in-memory samples)."""
    rng = np.random.default_rng(0)
    for i in range(64):
        yield encode_sample(rng.integers(0, 256, (128, 128, 3), dtype=np.uint8))


async def download(data: bytes) -> bytes:
    await asyncio.sleep(0.002)  # network latency (coroutine: never holds the GIL)
    return data


def decode(data: bytes) -> np.ndarray:
    return resize_nearest(decode_sample(data), (64, 64))  # zlib+numpy release the GIL


def build_pipeline(device: torch.device | str | None = None) -> Pipeline:
    """source → async download → decode → aggregate(16) → copy to
    ``device`` (``None`` = the card) → sink."""
    transfer = DeviceTransfer(device)

    def batch_transfer(imgs: list[np.ndarray]):
        return transfer({"images": np.stack(imgs)})

    return (
        PipelineBuilder()
        .add_source(source())
        .pipe(download, concurrency=8, name="download")
        .pipe(decode, concurrency=4, name="decode")
        .aggregate(16)
        .pipe(batch_transfer, concurrency=1, name="transfer")
        .add_sink(buffer_size=3)
        .build(num_threads=8)
    )


def main(argv: list[str] | None = None) -> list[torch.Tensor]:
    """Runs the pipeline, printing each batch and the stage stats; returns
    the image batches."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    pipeline = build_pipeline(args.device)
    batches = []
    t0 = time.monotonic()
    with pipeline.auto_stop():
        for i, batch in enumerate(pipeline):
            batches.append(batch["images"])
            print(f"batch {i}: images {tuple(batch['images'].shape)} on {batch['images'].device}")
    print(f"done in {time.monotonic() - t0:.2f}s")
    print("\nper-stage visibility (paper §5.4):")
    print(pipeline.format_stats())
    return batches


if __name__ == "__main__":
    main()
