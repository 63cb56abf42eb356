"""A cell of the benchmark run on the CPU at a small size, for the tests.

The harness's look for a card is skipped (`run.run_cell` is called with
device "cpu"), the ruleset is cut to its first `PATTERNS` rules, the
traffic to a few small batches or a few thousand flows, and the database
cache goes to a directory of the test's own. `FAULTS` break the timed
path underneath the harness, to see that the reference check catches
them. Run as a script it is one rank of a cell on several processes
(gloo), which is how the tests drive the four-card path here.
"""

from __future__ import annotations

import importlib.util
import json
import pathlib
import sys

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for _p in (str(BENCH), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import numpy as np  # noqa: E402

from harness import dbcache, spec  # noqa: E402

PATTERNS = 300


def load_run():
    """benchmark/run.py as a module."""
    s = importlib.util.spec_from_file_location("bench_run", BENCH / "run.py")
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod


def small_traffic(t: dict) -> dict:
    t = json.loads(json.dumps(t))
    if t["kind"] == "blocks":
        t["blocks_per_chip"] = min(t["blocks_per_chip"], 256)
        t["sizes"] = [[min(s, 1 << 16), w] for s, w in t["sizes"]]
        t["pool"] = 2
        t["check"]["calls"] = 3
    else:
        t["flows"] = 4096
        t["write"] = 512  # room for the plants clear of the boundaries
        t["check"]["flows"] = 8
    return t


def shrink(cache_dir) -> None:
    """Cut every configuration and mix to the CPU's size."""
    cfg, traffic = spec.config, spec.traffic

    def small_cfg(name):
        c = cfg(name)
        c["ruleset"]["patterns"] = PATTERNS
        return c

    spec.config = small_cfg
    spec.traffic = lambda name: small_traffic(traffic(name))
    spec.cell = cell
    dbcache.CACHE = pathlib.Path(cache_dir)


def cell(name: str) -> dict:
    """The cell of BENCHMARK.json by that name, or else the one that
    "<config>.<traffic>" names from the data files (a mix kept for a later
    cell), on the configuration's chips."""
    for w in spec.benchmark()["workloads"]:
        if w["name"] == name:
            return w
    config, traffic = name.split(".", 1)
    chips = 4 if config.endswith("_x4") else 1
    return {"name": name, "config": config, "traffic": traffic,
            "chips": chips}


# --- faults planted in the program's timed path ---------------------------


def _half_batch():
    """scan_batch scans the first half of the batch and answers nothing
    for the rest."""
    import hyperscan_tpu_torch as ht

    orig = ht.scan_batch

    def scan_batch(db, blocks, *a, **kw):
        half = len(blocks) // 2
        return orig(db, blocks[:half], *a, **kw) + [[]] * (len(blocks) - half)

    ht.scan_batch = scan_batch


def _first_4k():
    """scan_batch scans the first 4 KiB of each block and no further."""
    import hyperscan_tpu_torch as ht

    orig = ht.scan_batch

    def scan_batch(db, blocks, *a, **kw):
        return orig(db, [bytes(b[:4096]) for b in blocks], *a, **kw)

    ht.scan_batch = scan_batch


def _swapped():
    """scan_batch answers each block with the next block's matches."""
    import hyperscan_tpu_torch as ht

    orig = ht.scan_batch

    def scan_batch(db, blocks, *a, **kw):
        out = orig(db, blocks, *a, **kw)
        return out[1:] + out[:1]

    ht.scan_batch = scan_batch


def _altered():
    """The last match of each answer has its end moved by one, where the
    answers are made: a block's reports, a write round's delivery."""
    from hyperscan_tpu_torch.runtime import scan as S
    from hyperscan_tpu_torch.runtime import streamset as SS

    def moved(ms):
        if not ms:
            return ms
        i, f, to = ms[-1]
        return ms[:-1] + [(i, f, to + 1)]

    reports = S.finalize_reports

    def finalize_reports(*a, **kw):
        out, term = reports(*a, **kw)
        return moved(out), term

    finish = SS.streamset_write_finish

    def streamset_write_finish(*a, **kw):
        return [moved(ms) for ms in finish(*a, **kw)]

    S.finalize_reports = finalize_reports
    SS.streamset_write_finish = streamset_write_finish


def _state_unchanged():
    """A write round leaves the StreamSet's history as it found it."""
    from hyperscan_tpu_torch.runtime import streamset as SS

    orig = SS.streamset_write_start

    def streamset_write_start(db, ss, *a, **kw):
        hist = ss.hist
        h = orig(db, ss, *a, **kw)
        ss.hist = hist
        return h

    SS.streamset_write_start = streamset_write_start


def _chains_reset():
    """Each write round's host stages start from no carried regex state:
    the chains' evidence and the engines' states of the writes before
    are dropped (the history bytes are kept)."""
    from hyperscan_tpu_torch.runtime import streamset as SS

    orig = SS.streamset_write_finish

    def streamset_write_finish(db, ss, *a, **kw):
        ss.chain_state = {}
        ss.engine_states = [[e.start_state] * ss.size for e in db.engines]
        return orig(db, ss, *a, **kw)

    SS.streamset_write_finish = streamset_write_finish


def _no_exchange():
    """The shards' pairs are not exchanged between the processes: each
    process keeps its own shards' pairs and none of the others'."""
    from hyperscan_tpu_torch.parallel import sharded

    def gather(local, mesh):
        empty = (np.zeros(0, np.int64), np.zeros(0, np.int64))
        out = [empty] * mesh.ranks.size
        for j, d in enumerate(mesh.local):
            out[d] = local[j]
        return out

    sharded._gather_pairs = gather


FAULTS = {"half_batch": _half_batch, "first_4k": _first_4k,
          "swapped": _swapped, "altered": _altered,
          "state_unchanged": _state_unchanged,
          "chains_reset": _chains_reset, "no_exchange": _no_exchange}


class Args:
    def __init__(self, workload, seed, seconds, trace=0):
        self.workload, self.seed = workload, seed
        self.seconds, self.trace = seconds, trace


def run(workload, seed, seconds, cache_dir, trace=0, rank=0, port=None,
        fault=None):
    """One rank's run on the CPU; rank 0's (result, check lines)."""
    shrink(cache_dir)
    if fault:
        FAULTS[fault]()
    return load_run().run_cell(Args(workload, seed, seconds, trace), rank,
                               port, device_kind="cpu")


if __name__ == "__main__":
    # cpu_cell.py workload seed seconds cache_dir trace rank port [fault]
    w, seed, secs, cache, trace, rank, port = sys.argv[1:8]
    fault = sys.argv[8] if len(sys.argv) > 8 else None
    res = run(w, int(seed), float(secs), cache, int(trace), int(rank),
              int(port), fault)
    if res is not None:
        print(json.dumps(res[0]))
