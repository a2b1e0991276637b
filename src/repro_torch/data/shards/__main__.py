"""CLI migration tool: pack a dataset directory into shards.

Usage::

    PYTHONPATH=src python -m repro.data.shards SRC_DIR DST_DIR \
        [--samples-per-shard 1024] [--max-shard-bytes N] \
        [--format-version {1,2}] [--fields image,caption]

``SRC_DIR`` is an ``ArrayDataset`` directory (index.txt + *.rpr) — or an
existing shard directory (manifest.json), which makes this the v1→v2
migration path::

    python -m repro.data.shards old_shards/ new_shards/ \
        --format-version 2 --fields image

``--format-version 2`` writes columnar shards (per-field column regions
with projection support, see ``format.py``); ``--fields`` selects which
fields survive the migration (all of them by default for columnar
sources; a one-blob source's single payload column is named by the one
``--fields`` entry, default ``data``).
"""

from __future__ import annotations

import argparse
import pathlib

from ..dataset import ArrayDataset
from .dataset import MANIFEST_NAME, ShardDataset, pack


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument(
        "src",
        help="ArrayDataset directory (index.txt + *.rpr), or a shard "
        "directory (manifest.json) to re-pack/migrate",
    )
    parser.add_argument("dst", help="output directory for shards + manifest")
    parser.add_argument("--samples-per-shard", type=int, default=1024)
    parser.add_argument(
        "--max-shard-bytes",
        type=int,
        default=None,
        help="also roll a shard when its payload exceeds this many bytes",
    )
    parser.add_argument(
        "--format-version",
        type=int,
        choices=(1, 2),
        default=1,
        help="shard layout: 1 = one blob per sample, 2 = columnar fields "
        "with projection support",
    )
    parser.add_argument(
        "--fields",
        default=None,
        help="comma-separated field names (format v2): subset to keep from "
        "a columnar source, or the column name for a one-blob source",
    )
    args = parser.parse_args(argv)
    fields = (
        tuple(f.strip() for f in args.fields.split(",") if f.strip())
        if args.fields
        else None
    )
    src_path = pathlib.Path(args.src)
    if (src_path / MANIFEST_NAME).is_file():
        source = ShardDataset(src_path)  # re-pack / migrate existing shards
    else:
        source = ArrayDataset(args.src)
    try:
        ds = pack(
            source,
            args.dst,
            samples_per_shard=args.samples_per_shard,
            max_shard_bytes=args.max_shard_bytes,
            format_version=args.format_version,
            fields=fields,
        )
    finally:
        if isinstance(source, ShardDataset):
            source.close()
    print(
        f"packed {len(ds)} samples into {ds.num_shards} shard(s) under {ds.root}"
        + (
            f" (format v2, fields: {', '.join(ds.schema_fields or ())})"
            if args.format_version == 2
            else ""
        )
    )


if __name__ == "__main__":
    main()
