"""The port's hscollider (hyperscan_tpu_torch/tools/hscollider.py) over a
whole pattern file, by default the conformance battery
conformance/signatures.txt, with where its time goes.

Runs the collider as `python -m hyperscan_tpu_torch.tools.hscollider`
does, every scan on `--device` (the CUDA card by default; the collider
compiles with Grey(host_scan_limit=0), so every non-empty scan takes the
device branch), with the calls it makes wrapped in timers: the compiles,
the parses, each oracle (AST and `re`, ends and leftmost starts), the
corpus generation, and each scan entry point (block, stream, vectored,
the stream state codec, serialization). Prints the buckets (calls,
seconds) every `--every` seconds and at the end, beside the card's name
and power limit, so a run cut by a time limit still shows how far it
got; `corpora` counts the corpora whose stream checks began. Exits with
the collider's code (0: no diff).

Usage, from the root of the repository on a machine with a CUDA card:

    python3 tools_torch_collider.py [conformance/signatures.txt]
        [--seed 0] [--device cuda] [--every 60]
"""

import argparse
import collections
import json
import sys
import time


class _Timers:
    """Seconds and calls of named functions, reported every `every`
    seconds."""

    def __init__(self, every: float, card: str):
        self.t0 = time.perf_counter()
        self.last = self.t0
        self.every, self.card = every, card
        self.secs = collections.defaultdict(float)
        self.calls = collections.defaultdict(int)

    def wrap(self, name, fn):
        def timed(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                now = time.perf_counter()
                self.secs[name] += now - t
                self.calls[name] += 1
                if now - self.last >= self.every:
                    self.last = now
                    self.report("progress")
        return timed

    def report(self, what: str) -> None:
        wall = time.perf_counter() - self.t0
        print(f"[collider +{wall:8.1f}s] {what} [{self.card}] " + json.dumps(
            {k: [self.calls[k], round(self.secs[k], 3)]
             for k in sorted(self.secs, key=self.secs.get, reverse=True)}),
            flush=True)


class _TimedModule:
    """A module whose functions `names` are timed."""

    def __init__(self, mod, names, timers: _Timers):
        self._mod = mod
        self._timed = {n: timers.wrap(n, getattr(mod, n)) for n in names}

    def __getattr__(self, name):
        return self._timed.get(name) or getattr(self._mod, name)


SCAN_CALLS = ("scan", "open_stream", "scan_stream", "close_stream",
              "copy_stream", "compress_stream", "expand_stream",
              "scan_vector", "serialize_database", "deserialize_database")
ORACLES = ("ast_match_ends", "re_match_ends", "ast_leftmost_som",
           "re_leftmost_som", "parse")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("patterns", nargs="?",
                    default="conformance/signatures.txt")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--every", type=float, default=60.0,
                    help="seconds between progress lines")
    args = ap.parse_args(argv)

    from hyperscan_tpu_torch.runtime.scan import resolve_device
    from hyperscan_tpu_torch.tools import hscollider as HC
    from hyperscan_tpu_torch.tools.bench import card_name

    timers = _Timers(args.every, card_name(resolve_device(args.device)))
    names = ORACLES + ("compile_on_device", "_gen_corpora", "_splits", "hs")
    saved = {n: getattr(HC, n) for n in names}
    HC.hs = _TimedModule(HC.hs, SCAN_CALLS, timers)
    for name in ORACLES + ("compile_on_device", "_gen_corpora"):
        setattr(HC, name, timers.wrap(name, saved[name]))
    HC._splits = timers.wrap("corpora", saved["_splits"])
    try:
        rc = HC.main([args.patterns, "--seed", str(args.seed), "--device",
                      args.device])
    finally:
        for n, v in saved.items():
            setattr(HC, n, v)
    timers.report(f"done rc={rc}")
    return rc


if __name__ == "__main__":
    sys.exit(main())
