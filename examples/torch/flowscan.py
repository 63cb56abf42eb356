"""flowscan — streaming scan with one stream per flow, batched writes, on
the PyTorch/CUDA port (hyperscan_tpu_torch).

Counterpart of examples/flowscan.py (reference: examples/pcapscan.cc,
stream-per-flow over packet payloads), without the pcap dependency: the
input is a text file where each line is `<flow_id> <payload>`; payloads
of the same flow form one logical stream, and each "round" of packets is
scanned as one batched write (ht.scan_streams). The streams live on the
CUDA card unless --device names another torch device.

Usage: python examples/torch/flowscan.py <pattern_file> <flows.txt>
           [--device D]
"""

import argparse
import pathlib
import sys
from collections import defaultdict

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

import hyperscan_tpu_torch as ht  # noqa: E402
from hyperscan_tpu_torch.tools.hscheck import parse_line  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("pattern_file")
    ap.add_argument("flows")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    entries = []
    with open(args.pattern_file) as f:
        for line in f:
            p = parse_line(line)
            if p:
                entries.append(p)
    db = ht.compile_multi(
        [p for (_i, p, _f) in entries],
        flags=[f for (_i, _p, f) in entries],
        ids=[i for (i, _p, _f) in entries],
        mode=ht.HS_MODE_STREAM,
    )

    flows = defaultdict(list)
    order = []
    with open(args.flows, "rb") as f:
        for line in f:
            if not line.strip():
                continue
            fid, _, payload = line.partition(b" ")
            if fid not in flows:
                order.append(fid)
            flows[fid].append(payload.rstrip(b"\n"))

    streams = {fid: ht.open_stream(db, device=args.device) for fid in order}
    nmatches = 0
    round_no = 0
    while True:
        batch = [(fid, flows[fid][round_no]) for fid in order
                 if round_no < len(flows[fid])]
        if not batch:
            break
        results = ht.scan_streams(
            db, [streams[fid] for (fid, _c) in batch],
            [c for (_f, c) in batch],
        )
        for (fid, _c), ms in zip(batch, results):
            for (pid, _frm, to) in ms:
                print(f"flow {fid.decode()} pattern {pid} @ {to}")
                nmatches += 1
        round_no += 1
    for fid in order:
        for (pid, _frm, to) in ht.close_stream(streams[fid]):
            print(f"flow {fid.decode()} pattern {pid} @ {to} (EOD)")
            nmatches += 1
    print(f"{nmatches} matches across {len(order)} flows")
    return 0


if __name__ == "__main__":
    sys.exit(main())
