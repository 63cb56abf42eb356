"""patbench — pattern-set performance bisection on the PyTorch/CUDA port
(hyperscan_tpu_torch).

Counterpart of examples/patbench.py (reference: examples/patbench.cc,
examples/README.md:38-45). Finds the patterns that cost the most scan
throughput: repeatedly splits the pattern set in half, times each half
over the corpus, and descends into the slower half until a single
expensive pattern remains. Repeat with `--top N` to list several
offenders (each found pattern is removed before the next pass). Scans run
on the CUDA card unless --device names another torch device; a timing
taken with --device cpu is the plain PyTorch versions' on the host.

Usage:
  python examples/torch/patbench.py patterns.txt corpus.bin [--top N]
      [--repeats R] [--block-size B] [--device D]
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

import hyperscan_tpu_torch as ht  # noqa: E402
from hyperscan_tpu_torch.tools.hscheck import parse_line  # noqa: E402


def _sync(device) -> None:
    """Wait for the card, so that a timing holds the device's work."""
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _time_scan(entries, blocks, repeats: int, device) -> float:
    try:
        db = ht.compile_multi(
            [p for (_i, p, _f) in entries],
            flags=[f for (_i, _p, f) in entries],
            ids=[i for (i, _p, _f) in entries],
        )
    except ht.CompileError:
        return float("inf")
    ht.scan_batch(db, blocks, device=device)  # warm
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(repeats):
        ht.scan_batch(db, blocks, device=device)
    _sync(device)
    return time.perf_counter() - t0


def bisect_worst(entries, blocks, repeats: int, device):
    cur = list(entries)
    while len(cur) > 1:
        mid = len(cur) // 2
        a, b = cur[:mid], cur[mid:]
        ta = _time_scan(a, blocks, repeats, device)
        tb = _time_scan(b, blocks, repeats, device)
        cur = a if ta >= tb else b
        print(f"  halves of {len(a) + len(b)}: "
              f"{ta * 1000:.1f} ms vs {tb * 1000:.1f} ms -> keep "
              f"{len(cur)}", file=sys.stderr)
    return cur[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("patterns")
    ap.add_argument("corpus")
    ap.add_argument("--top", type=int, default=1)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--block-size", type=int, default=1 << 16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    entries = []
    with open(args.patterns, "r", errors="replace") as f:
        for line in f:
            e = parse_line(line)
            if e:
                entries.append(e)
    with open(args.corpus, "rb") as f:
        blob = f.read()
    blocks = [blob[i : i + args.block_size]
              for i in range(0, len(blob), args.block_size)]

    base = _time_scan(entries, blocks, args.repeats, args.device)
    print(f"full set: {len(entries)} patterns, {base * 1000:.1f} ms")
    remaining = list(entries)
    for k in range(min(args.top, len(entries) - 1)):
        worst = bisect_worst(remaining, blocks, args.repeats, args.device)
        remaining = [e for e in remaining if e is not worst]
        t_without = _time_scan(remaining, blocks, args.repeats, args.device)
        print(f"#{k + 1} costliest: id {worst[0]} pattern {worst[1]!r} "
              f"(set without it: {t_without * 1000:.1f} ms, "
              f"{base - t_without:+.3f} s)")
        base = t_without
    return 0


if __name__ == "__main__":
    sys.exit(main())
