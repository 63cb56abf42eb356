"""Corpus builder — SQLite corpus databases for hsbench.

Reference analogue: tools/hsbench/scripts/*.py, which build the corpus
format consumed by hsbench (a `chunk` table of (id, stream_id, data)
rows; reference reader: tools/hsbench/data_corpus.cpp:42-86). This tool
writes the same schema, so corpora built here run under both this
project's hsbench and the reference's.

Sources:
  - a flat file split into fixed-size blocks (default), or line blocks
  - random printable noise (--random BYTES) with a seed

Blocks are grouped into streams round-robin (--blocks-per-stream).

Usage:
  python -m hyperscan_tpu_torch.tools.corpus out.db --from-file corpus.bin \
      [--block-size 65536] [--blocks-per-stream 16] [--line-mode]
  python -m hyperscan_tpu_torch.tools.corpus out.db --random 1048576 --seed 7
"""

from __future__ import annotations

import argparse
import os
import sqlite3
import sys


def write_corpus(path: str, blocks, blocks_per_stream: int) -> None:
    if os.path.exists(path):
        os.unlink(path)
    con = sqlite3.connect(path)
    try:
        con.execute(
            "CREATE TABLE chunk (id INTEGER PRIMARY KEY, "
            "stream_id INTEGER NOT NULL, data BLOB);"
        )
        rows = [
            (i, i // max(1, blocks_per_stream), sqlite3.Binary(b))
            for i, b in enumerate(blocks)
        ]
        con.executemany("INSERT INTO chunk VALUES (?, ?, ?);", rows)
        con.commit()
    finally:
        con.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("output")
    ap.add_argument("--from-file")
    ap.add_argument("--random", type=int, metavar="BYTES")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--block-size", type=int, default=1 << 16)
    ap.add_argument("--blocks-per-stream", type=int, default=16)
    ap.add_argument("--line-mode", action="store_true")
    args = ap.parse_args(argv)

    if bool(args.from_file) == bool(args.random):
        print("exactly one of --from-file / --random is required")
        return 2
    if args.from_file:
        with open(args.from_file, "rb") as f:
            blob = f.read()
    else:
        import numpy as np

        rng = np.random.default_rng(args.seed)
        blob = (32 + rng.integers(0, 95, size=args.random)) \
            .astype(np.uint8).tobytes()
    if args.line_mode:
        blocks = blob.splitlines(keepends=True)
    else:
        bs = args.block_size
        blocks = [blob[i : i + bs] for i in range(0, len(blob), bs)]
    write_corpus(args.output, blocks, args.blocks_per_stream)
    n_streams = -(-len(blocks) // max(1, args.blocks_per_stream))
    print(f"{args.output}: {len(blocks)} blocks, {n_streams} streams, "
          f"{len(blob)} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
