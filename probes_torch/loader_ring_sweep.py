"""The least slab ring with which the port's zero-copy image loader ends,
beside the floor ``_ring_size`` sets (ROADMAP F-ref-5).

For each (batch, chunk) and failed read (none, sample 7, sample 30) the
loader runs on the CPU over 64 synthetic 16x16 frames in order, with the
ring forced to each size from the transfer's hold + 1 upward, until a run
delivers every batch within a few seconds.  A run that does not is a ring
the loader blocks in; it is stopped and the next size tried.

    PYTHONPATH=src python probes_torch/loader_ring_sweep.py   # about 3 min on the CPU

One JSON line a case: the least ring that ran, the floor ``_ring_size``
gives by default, and the batches delivered there."""

import json
import sys
import tempfile
import threading

from repro_torch.data import CheckpointableSampler, SyntheticImageDataset, build_image_loader
from repro_torch.data import loader as loader_module
from repro_torch.data.transfer import DeviceTransfer

N, HW, LIMIT_S = 64, (16, 16), 3.0
CASES = [(4, 16), (2, 16), (3, 16), (5, 16), (8, 16), (1, 16), (4, 8), (4, 1)]
# the loader's transfer at its defaults: sink buffer 3, transfer chunk 2
TRANSFER = DeviceTransfer("cpu", consumer_window=3, dispatch_chunk=2)


def run(ds, batch: int, chunk: int, failed: int | None, slabs: int | None) -> int | None:
    """Batches delivered, or None where the loader blocked."""
    read = ds.read_bytes

    class Failing:
        def __len__(self):
            return len(ds)

        def read_bytes(self, i):
            if i == failed:
                raise OSError(f"planted failed read of sample {i}")
            return read(i)

    ring = loader_module._ring_size
    if slabs is not None:
        loader_module._ring_size = lambda *a, **k: slabs
    try:
        pipe = build_image_loader(
            Failing(), batch_size=batch, hw=HW, chunk=chunk, device="cpu", num_threads=4,
            read_concurrency=2, decode_concurrency=2,
            sampler=CheckpointableSampler(N, batch_size=1, shuffle=False))
    finally:
        loader_module._ring_size = ring
    got = []

    def drain():
        with pipe.auto_stop():
            for _ in pipe:
                got.append(1)

    reader = threading.Thread(target=drain, daemon=True)
    reader.start()
    reader.join(timeout=LIMIT_S)
    if reader.is_alive():
        pipe.stop()
        return None
    return len(got)


def main() -> int:
    with tempfile.TemporaryDirectory() as d:
        ds = SyntheticImageDataset.materialize(d, N, hw=HW, seed=0)
        for batch, chunk in CASES:
            floor = loader_module._ring_size(None, TRANSFER, 2, batch_size=batch, bind_chunk=chunk)
            for failed in (None, 7, 30):
                least = next((n for n in range(TRANSFER.hold_slabs + 1, floor + 1)
                              if run(ds, batch, chunk, failed, n) is not None), None)
                print(json.dumps({"batch": batch, "chunk": chunk, "failed_sample": failed,
                                  "least_ring_that_ran": least, "floor": floor,
                                  "batches_at_floor": run(ds, batch, chunk, failed, None)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
