"""hsbench of the PyTorch/CUDA port over the bench ruleset and a corpus
with planted matches, in block, stream and vectored mode.

Writes the first N patterns of the bench ruleset
(hyperscan_tpu_torch/tools/benchdata.py) as `id:/pattern/` lines, and a
SQLite corpus (hyperscan_tpu_torch/tools/corpus.py) of the bench corpus
formula (`gen_corpus`, structured) in 8 KiB blocks, 16 blocks a stream,
with the 4 KiB region of planted matches spliced into the first block of
every stream. Then runs hsbench (hyperscan_tpu_torch/tools/hsbench.py) in
each mode, the stream mode under --profile, sums the trace's kernel
events, and prints the card's name and power limit.

Usage, from the root of the repository on a machine with a CUDA card:

    python3 tools_torch_hsbench.py [--mib 64] [--patterns 1000]
        [--device cuda] [--out hsbench_out]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

BLOCK = 8 * 1024
BLOCKS_PER_STREAM = 16


def write_inputs(out: str, mib: int, n_patterns: int):
    """The pattern file and the SQLite corpus; returns their paths and the
    number of streams."""
    from hyperscan_tpu_torch.tools.benchdata import (PLANT_AT, gen_corpus,
                                                     patterns, plant_region)
    from hyperscan_tpu_torch.tools.corpus import write_corpus

    os.makedirs(out, exist_ok=True)
    pats, ids = patterns(n_patterns)
    patfile = os.path.join(out, "patterns.txt")
    with open(patfile, "w") as f:
        f.writelines(f"{i}:/{p}/\n" for i, p in zip(ids, pats))
    corpus = gen_corpus(mib << 20, 1, "structured")
    region = plant_region()
    stride = BLOCK * BLOCKS_PER_STREAM
    for s in range(0, len(corpus) - PLANT_AT - len(region) + 1, stride):
        corpus[s + PLANT_AT:s + PLANT_AT + len(region)] = region
    blocks = [corpus[i:i + BLOCK].tobytes()
              for i in range(0, len(corpus), BLOCK)]
    dbfile = os.path.join(out, "corpus.db")
    write_corpus(dbfile, blocks, BLOCKS_PER_STREAM)
    return patfile, dbfile, -(-len(blocks) // BLOCKS_PER_STREAM)


def card(device: str) -> str:
    if not device.startswith("cuda"):
        return device
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def kernel_events(trace_file: str):
    """(kernel events, their device microseconds) of a Chrome trace."""
    with open(trace_file) as f:
        events = json.load(f)["traceEvents"]
    kern = [e for e in events if e.get("cat") == "kernel"]
    return len(kern), sum(float(e.get("dur", 0)) for e in kern)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--mib", type=int, default=64)
    ap.add_argument("--patterns", type=int, default=1000)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="hsbench_out")
    args = ap.parse_args(argv)

    from hyperscan_tpu_torch.tools import hsbench

    patfile, dbfile, n_streams = write_inputs(args.out, args.mib,
                                              args.patterns)
    print(f"{args.patterns} bench patterns; corpus {args.mib} MiB, "
          f"{BLOCK} B blocks, {n_streams} streams of {BLOCKS_PER_STREAM} "
          f"blocks, planted matches in each stream's first block",
          flush=True)
    prof = os.path.join(args.out, "prof")
    for mode in ("block", "stream", "vectored"):
        print(f"== hsbench {mode}", flush=True)
        extra = ["--profile", prof] if mode == "stream" else []
        rc = hsbench.main(["-e", patfile, "-c", dbfile, "--mode", mode,
                           "--repeats", "1", "--device",
                           args.device] + extra)
        if rc:
            return rc
        sys.stdout.flush()
    n, us = kernel_events(os.path.join(prof, "hsbench_trace.json"))
    print(f"stream-mode trace: {n} kernel events, {us:.0f} us of device "
          f"time", flush=True)
    print(card(args.device), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
