"""massflow — thousands of concurrent streams through the StreamSet bulk
API, on the PyTorch/CUDA port (hyperscan_tpu_torch).

Counterpart of examples/massflow.py (reference analogue: a
high-stream-count hsbench STREAM run, the docs' 8,891-stream sample
corpus, doc/dev-reference/tools.rst:70-73). Every round, ALL streams'
history + write extents are filtered in one device dispatch; rounds
pipeline (round k+1 is dispatched before round k is finished), so the
host work of one round overlaps the card's work on the next. The
streams live on the CUDA card unless --device names another torch
device.

flowscan.py is the small-scale sibling (per-stream scan_streams calls).

Usage: python examples/torch/massflow.py <pattern_file> [streams]
           [rounds] [--device D]
  pattern_file: one `id:/pattern/flags` per line (hscheck format)
  streams:      concurrent stream count (default 1024)
  rounds:       write rounds of 4 KiB per stream (default 8)
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

import numpy as np  # noqa: E402

import hyperscan_tpu_torch as ht  # noqa: E402
from hyperscan_tpu_torch.runtime.streamset import (  # noqa: E402
    close_streamset,
    open_streamset,
    streamset_write_finish,
    streamset_write_start,
)
from hyperscan_tpu_torch.tools.hscheck import parse_line  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("pattern_file")
    ap.add_argument("streams", type=int, nargs="?", default=1024)
    ap.add_argument("rounds", type=int, nargs="?", default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    S, rounds = args.streams, args.rounds
    W = 4096

    pats, ids, flags = [], [], []
    for line in pathlib.Path(args.pattern_file).read_text().splitlines():
        parsed = parse_line(line)
        if parsed is None:
            continue
        i, p, f = parsed
        pats.append(p)
        ids.append(i)
        flags.append(f)
    db = ht.compile_multi(pats, ids=ids, flags=flags,
                          mode=ht.HS_MODE_STREAM)

    # plantable witnesses: the pure-literal patterns' own text (regex
    # patterns would need a synthesized witness — out of scope here)
    lits = [p.encode() for p in pats
            if p.isascii() and all(c.isalnum() or c in " _-" for c in p)]
    rng = np.random.default_rng(0)
    ss = open_streamset(db, S, device=args.device)
    total = 0
    # pipeline: dispatch every round's device work before finishing the
    # first — finish MUST run in write order (it advances carried state)
    pending = []
    for r in range(rounds):
        writes = []
        for s in range(S):
            buf = (32 + rng.integers(0, 95, size=W)).astype(np.uint8)
            if (r * S + s) % 97 == 0 and lits:
                lit = lits[s % len(lits)]
                buf[100:100 + len(lit)] = np.frombuffer(lit, np.uint8)
            writes.append(buf.tobytes())
        pending.append(streamset_write_start(db, ss, writes))
        if len(pending) >= 2:  # keep one round in flight
            total += sum(len(m) for m in
                         streamset_write_finish(db, ss, pending.pop(0)))
    for h in pending:
        total += sum(len(m) for m in streamset_write_finish(db, ss, h))
    total += sum(len(m) for m in close_streamset(db, ss))
    print(f"{S} streams x {rounds} x {W} B: {total} matches")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
