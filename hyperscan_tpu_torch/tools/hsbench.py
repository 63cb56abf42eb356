"""hsbench — throughput benchmark harness (reference: tools/hsbench), on
the PyTorch/CUDA port.

Scans a corpus repeatedly with a compiled pattern database and reports
throughput, match counts, and database statistics, mirroring the
reference's output fields (doc/dev-reference/tools.rst:56-73).

Usage:
  python -m hyperscan_tpu_torch.tools.hsbench -e patterns.txt -c corpus.bin
      [--mode block|stream|vectored] [--repeats N] [--block-size BYTES]
      [--device cuda|cpu] [--profile DIR]

Scans run on the CUDA card unless --device names another torch device.

The corpus file is split into blocks (one per line with --line-mode, else
fixed --block-size chunks grouped into streams of --blocks-per-stream).
SQLite corpus databases in the reference's format (a `chunk` table with
id/stream_id/data, built by tools/hsbench/scripts) are detected by file
magic and loaded with their stream grouping intact.
"""

from __future__ import annotations

import argparse
import sys
import time

import hyperscan_tpu_torch as hs

from .hscheck import MODES, parse_line


def load_sqlite_corpus(path):
    """Blocks + stream grouping from the reference's SQLite corpus
    format: `SELECT id, stream_id, data FROM chunk ORDER BY id`
    (reference: tools/hsbench/data_corpus.cpp:86)."""
    import sqlite3

    con = sqlite3.connect(path)
    try:
        rows = con.execute(
            "SELECT id, stream_id, data FROM chunk ORDER BY id;"
        ).fetchall()
    finally:
        con.close()
    blocks = []
    groups = {}
    for (_cid, stream_id, data) in rows:
        if isinstance(data, str):
            data = data.encode("latin-1", "replace")
        groups.setdefault(stream_id, []).append(len(blocks))
        blocks.append(bytes(data))
    return blocks, [groups[k] for k in sorted(groups)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-e", "--expressions", required=True)
    ap.add_argument("-c", "--corpus", required=True)
    ap.add_argument("--mode", choices=sorted(MODES), default="block")
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--block-size", type=int, default=1 << 16)
    ap.add_argument("--blocks-per-stream", type=int, default=16)
    ap.add_argument("--line-mode", action="store_true")
    ap.add_argument("-T", "--threads", type=int, default=1,
                    help="host threads for batch scans (reference: hsbench -T, one scratch per thread)")
    ap.add_argument("--device", default="cuda",
                    help="torch device the scans run on (default: the "
                         "CUDA card)")
    ap.add_argument("--profile", metavar="DIR",
                    help="wrap the timed scans in a torch.profiler trace "
                         "written to DIR as a Chrome trace "
                         "(hsbench_trace.json; chrome://tracing, Perfetto)")
    args = ap.parse_args(argv)

    entries = []
    with open(args.expressions, "r", errors="replace") as f:
        for line in f:
            parsed = parse_line(line)
            if parsed:
                entries.append(parsed)
    if not entries:
        print("no patterns")
        return 2

    t0 = time.perf_counter()
    db = hs.compile_multi(
        [p for (_i, p, _f) in entries],
        flags=[f for (_i, _p, f) in entries],
        ids=[i for (i, _p, _f) in entries],
        mode=MODES[args.mode],
    )
    compile_s = time.perf_counter() - t0

    with open(args.corpus, "rb") as f:
        magic = f.read(16)
    stream_groups = None
    if magic.startswith(b"SQLite format 3"):
        # reference corpus format (tools/hsbench/data_corpus.cpp:42-86)
        blocks, stream_groups = load_sqlite_corpus(args.corpus)
    else:
        with open(args.corpus, "rb") as f:
            blob = f.read()
        if args.line_mode:
            blocks = blob.splitlines(keepends=True)
        else:
            bs = args.block_size
            blocks = [blob[i : i + bs] for i in range(0, len(blob), bs)]
    total_bytes = sum(len(b) for b in blocks)

    import contextlib

    dev = args.device
    prof = contextlib.nullcontext()
    if args.profile:
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.device(dev).type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
    nmatches = 0
    t0 = time.perf_counter()
    with prof:
      for _ in range(args.repeats):
        if args.mode == "block":
            for ms in hs.scan_batch(db, blocks, threads=args.threads,
                                    device=dev):
                nmatches += len(ms)
        elif args.mode == "vectored":
            if stream_groups is not None:
                for g in stream_groups:
                    nmatches += len(hs.scan_vector(
                        db, [blocks[j] for j in g], device=dev))
            else:
                k = args.blocks_per_stream
                for i in range(0, len(blocks), k):
                    nmatches += len(hs.scan_vector(db, blocks[i : i + k],
                                                   device=dev))
        else:
            if stream_groups is not None:
                groups = [[blocks[j] for j in g] for g in stream_groups]
            else:
                k = args.blocks_per_stream
                groups = [blocks[i : i + k]
                          for i in range(0, len(blocks), k)]
            streams = [hs.open_stream(db, device=dev) for _ in groups]
            for j in range(max(len(g) for g in groups)):
                live = [(st, g[j]) for st, g in zip(streams, groups)
                        if j < len(g)]
                res = hs.scan_streams(db, [s for s, _c in live],
                                      [c for _s, c in live],
                                      threads=args.threads)
                nmatches += sum(len(r) for r in res)
            for st in streams:
                nmatches += len(hs.close_stream(st))
    dt = time.perf_counter() - t0
    if args.profile:
        import os

        os.makedirs(args.profile, exist_ok=True)
        prof.export_chrome_trace(
            os.path.join(args.profile, "hsbench_trace.json"))

    scanned = total_bytes * args.repeats
    print(f"Expression count:     {len(entries)}")
    blob = hs.serialize_database(db)
    print(f"Bytecode size:        {hs.database_size(db)} bytes")
    # the serialized header embeds the payload CRC at bytes 8:12
    # (database.serialize); report it like the reference's hsbench
    print(f"Database CRC:         "
          f"0x{int.from_bytes(blob[8:12], 'little'):08x}")
    print(f"Scratch size:         {hs.scratch_size(hs.alloc_scratch(db))} bytes")
    print(f"Compile time:         {compile_s:.3f} seconds")
    print(f"Corpus size:          {total_bytes} bytes "
          f"({len(blocks)} blocks)")
    print(f"Matches:              {nmatches} "
          f"({nmatches / max(1, scanned) * 1024:.3f} matches/kilobyte)")
    print(f"Overall block rate:   {len(blocks) * args.repeats / dt:,.2f} "
          f"blocks/sec")
    print(f"Overall throughput:   {scanned * 8 / dt / 1e6:,.2f} Mbit/sec "
          f"({scanned / dt / 1e9:.3f} GB/s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
