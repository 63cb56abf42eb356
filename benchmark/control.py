#!/usr/bin/env python3
"""Readings of a cell's comparison for the program and for its control.

    python3 benchmark/control.py --workload <cell> --seeds <n> ...
        [--seconds S] [--calls N] [--device cuda|cpu]

For each seed, one line of JSON on standard output: the numbers that a
run compares (`missing`, `extra`; limit 0 each) read over the sample a
run draws, for the program and for the control of the cell's
configuration (`cfg["control"]`, one of the `CONTROLS` of the reference
that `cfg["reference"]` names: the reference with one stated guarantee
broken; `harness/control.py`). The program runs in this one process,
loaded once, with a short window of `--seconds` per seed at the cell's
own load.
With `--calls N` the program does not run: the sample is that of a run
of N calls (rounds, for flows), and only the control is read; that is
how a cell on four cards gets its control's readings on one.

The benchmark's runs never run this; it sets the limits that they hold
(PERF.md gives the readings).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

BENCH = pathlib.Path(__file__).resolve().parent
for _p in (str(BENCH), str(BENCH.parent)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from harness import control, dbcache, spec  # noqa: E402
from harness import traffic as T  # noqa: E402
from harness.loops import Agree, BlockLoop, FlowLoop, run_phase  # noqa: E402


def _reading(ck) -> dict:
    return {"missing": ck.missing, "extra": ck.extra,
            "answers": ck.answers, "compared": ck.compared}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--calls", type=int)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = spec.cell(args.workload)
    cfg = spec.config(cell["config"])
    mix = spec.traffic(cell["traffic"])
    flows = mix["kind"] == "flows"
    ht = db = None
    if args.calls is None:
        import hyperscan_tpu_torch as ht

        db = dbcache.load(ht, cfg, lambda m: print(m, file=sys.stderr))
    for seed in args.seeds:
        tr = T.make(mix, seed, cfg["ruleset"], cell["chips"])
        loop = (FlowLoop if flows else BlockLoop)(ht, db, tr, seed,
                                                   device=args.device)
        line = {"workload": args.workload, "seed": seed}
        if db is None:
            if flows:
                loop.r = args.calls
            for _ in range(0 if flows else args.calls):
                loop.record(None)
        else:
            loop.warm(Agree(), lambda m: print(m, file=sys.stderr))
            ph = run_phase(loop, Agree(), args.seconds)
            loop.close()
            line["calls"] = ph.calls
            line["program"] = _reading(loop.check(cfg))
        line["control"] = _reading(control.check(loop, cfg))
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
