"""The closed loops that drive the program, one caller each, and the
sample of their answers that the reference checks after the window.

- `BlockLoop`: each call is `scan_batch(db, batch)` (with `mesh=` on a
  mesh) over the next batch of the traffic's pool; a call's latency is
  the call's own time, which ends with the matches on the host.
- `FlowLoop`: each step starts the next write round of one StreamSet
  (`streamset_write_start` with `chunks`) and finishes the oldest round
  while more than `in_flight` are started; a round's latency runs from
  its start to the return of its finish. After the window the streams
  are closed (`close_streamset`) and their EOD matches join the answers.

The check holds the sample to the configuration's plain reference, the
module that `cfg["reference"]` names (spec.py), over its ruleset.

A phase runs steps until its deadline, then drains what is in flight,
so every call counted in a phase started and ended in it. With a
process group, every rank takes the same number of steps: after each
step the ranks agree whether any has reached its deadline.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import time
from typing import Dict, List

import numpy as np
import torch

from . import spec
from .traffic import Blocks, Flows, rng_for


@dataclasses.dataclass
class Phase:
    calls: int = 0
    bytes: int = 0
    seconds: float = 0.0
    latencies: List[float] = dataclasses.field(default_factory=list)
    ends: List[float] = dataclasses.field(default_factory=list)  # clock
    sizes: List[int] = dataclasses.field(default_factory=list)

    def rates(self, every: float = 5.0) -> List[float]:
        """Bytes per second of the calls that ended in each `every`
        seconds of the phase (for the log: how the rate moves in a run)."""
        if not self.ends:
            return []
        t0 = self.ends[0] - self.latencies[0]
        n = int((self.ends[-1] - t0) // every) + 1
        acc = [0] * n
        for e, b in zip(self.ends, self.sizes):
            acc[min(n - 1, int((e - t0) // every))] += b
        return [a / every for a in acc]


class Agree:
    """Whether a condition holds on any rank: this process alone, or every
    process, through one all-reduce a step over `group`, a gloo group of
    the harness's own (so that no collective of the harness runs on the
    cards, beside the program's)."""

    def __init__(self, group=None):
        self.group = group

    def any(self, flag: bool) -> bool:
        if self.group is None:
            return flag
        import torch.distributed as dist

        t = torch.tensor([int(flag)], dtype=torch.int32)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return bool(t.item())


def _span(name: str):
    return torch.profiler.record_function(name)


def run_phase(loop, agree: Agree, seconds: float) -> Phase:
    ph = Phase()
    t0 = time.perf_counter()
    deadline = t0 + seconds
    def take(done):
        now = time.perf_counter()
        for lat, nbytes in done:
            ph.latencies.append(lat)
            ph.ends.append(now)
            ph.sizes.append(nbytes)
            ph.bytes += nbytes

    while True:
        take(loop.step())
        if agree.any(time.perf_counter() >= deadline):
            break
    take(loop.drain())
    ph.seconds = time.perf_counter() - t0
    ph.calls = len(ph.latencies)
    return ph


class Reservoir:
    """K items drawn uniformly from a sequence of unknown length, by a
    generator of the seed (Algorithm R)."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k, self.rng, self.seen = k, rng, 0
        self.items: list = []

    def offer(self, item) -> None:
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                self.items[j] = item
        self.seen += 1


def families(db) -> Dict[str, int]:
    """The program's count of dispatches by literal family so far."""
    from hyperscan_tpu_torch.ops import teddy_families as F

    return dict(F.family_state(db.lit).dispatches) if db.lit else {}


def _ran(before: Dict[str, int], after: Dict[str, int]) -> List[str]:
    return sorted(f for f in after if after[f] > before.get(f, 0))


@dataclasses.dataclass
class Check:
    """The comparison of the sampled answers with the reference: matches
    missing from the program's answer and matches it gave that the
    reference does not (both as multisets), over `answers` answers."""

    answers: int = 0
    compared: int = 0
    missing: int = 0
    extra: int = 0

    def add(self, got, want) -> None:
        g, w = collections.Counter(got), collections.Counter(want)
        self.answers += 1
        self.compared += sum(w.values())
        self.missing += sum((w - g).values())
        self.extra += sum((g - w).values())


class BlockLoop:
    kind = "block"

    def __init__(self, ht, db, traffic: Blocks, seed: int, device=None,
                 mesh=None, digest: bool = False):
        self.ht, self.db, self.t = ht, db, traffic
        self.kw = {"mesh": mesh} if mesh is not None else {"device": device}
        self.i = 0
        self.sample = Reservoir(traffic.check["calls"],
                                rng_for(seed, "sample"))
        self.seed = seed
        self.digest = hashlib.sha256() if digest else None

    def call(self):
        batch = self.t.pool[self.i % len(self.t.pool)]
        with _span("bench.scan_batch"):
            out = self.ht.scan_batch(self.db, batch, **self.kw)
        return out

    def warm(self, agree: Agree, log, max_passes: int = 4) -> None:
        """Passes over the pool: at least two (the first learns the
        capacities and the gate's survival rate), more while a pass ran
        other literal families than the one before, at most max_passes."""
        passes = []
        while True:
            before = families(self.db)
            for _ in self.t.pool:
                self.record(self.call())
            passes.append(_ran(before, families(self.db)))
            settled = len(passes) >= 2 and passes[-1] == passes[-2]
            if not agree.any(not settled and len(passes) < max_passes):
                break
        log(f"warm-up: {len(passes)} passes over {len(self.t.pool)} "
            f"batches, families {passes}")

    def record(self, out) -> None:
        self.sample.offer((self.i, out))
        if self.digest is not None:
            self.digest.update(repr(out).encode())
        self.i += 1

    def step(self):
        batch_bytes = self.t.batch_bytes[self.i % len(self.t.pool)]
        t0 = time.perf_counter()
        out = self.call()
        lat = time.perf_counter() - t0
        self.record(out)
        return [(lat, batch_bytes)]

    def drain(self):
        return []

    def close(self) -> None:
        pass

    def check(self, cfg: dict, answer=None) -> Check:
        """The sampled calls' answers against the reference: in each
        sampled call, `blocks_per_call` blocks drawn from the seed.
        `answer(data, rs)`, if given, stands in for the program's answer
        (the control)."""
        R, rs = spec.reference(cfg), cfg["ruleset"]
        rng = rng_for(self.seed, "blocks")
        per = self.t.check["blocks_per_call"]
        memo: Dict[tuple, tuple] = {}
        ck = Check()
        for i, out in sorted(self.sample.items, key=lambda x: x[0]):
            b = i % len(self.t.pool)
            batch = self.t.pool[b]
            picks = (range(len(batch)) if per >= len(batch) else
                     sorted(rng.choice(len(batch), per, replace=False)))
            for j in picks:
                if (b, j) not in memo:
                    memo[(b, j)] = (
                        R.block_matches(batch[j], rs),
                        None if answer is None else answer(batch[j], rs))
                want, stand_in = memo[(b, j)]
                ck.add(out[j] if answer is None else stand_in, want)
        return ck


class FlowLoop:
    kind = "stream"

    def __init__(self, ht, db, traffic: Flows, seed: int, device=None):
        self.db, self.t = db, traffic
        if db is not None:  # None: only the sample, for the control
            from hyperscan_tpu_torch.runtime import streamset as SS

            self.SS = SS
            self.ss = SS.open_streamset(db, traffic.flows, device=device)
        self.pending = collections.deque()
        self.r = 0  # rounds started
        self.round_bytes = traffic.flows * traffic.write
        self.flows = self._sample_flows(rng_for(seed, "flows"))
        self.got = {k: [] for k in self.flows}
        self.closed: Dict[int, list] = {}

    def _sample_flows(self, rng) -> List[int]:
        """`check["flows"]` flows drawn from the seed: three quarters of
        them (as far as there are) among the flows with rule plants, each
        of which has a match of every rule shape across a write boundary,
        the rest among the other flows."""
        want = self.t.check["flows"]
        planted = self.t.planted
        others = np.setdiff1d(np.arange(self.t.flows), planted)
        take = min(len(planted), want * 3 // 4)
        picked = rng.choice(planted, take, replace=False).tolist()
        picked += rng.choice(others, min(len(others), want - take),
                             replace=False).tolist()
        return sorted(int(k) for k in picked)

    def _start(self) -> None:
        t0 = time.perf_counter()
        with _span("bench.write_start"):
            h = self.SS.streamset_write_start(self.db, self.ss,
                                              self.t.round(self.r))
        self.pending.append((self.r, t0, h))
        self.r += 1

    def _finish(self):
        r, t0, h = self.pending.popleft()
        with _span("bench.write_finish"):
            out = self.SS.streamset_write_finish(self.db, self.ss, h)
        lat = time.perf_counter() - t0
        for k in self.flows:
            if out[k]:
                self.got[k].extend((r, m) for m in out[k])
        return out, (lat, self.round_bytes)

    def step(self):
        self._start()
        done = []
        while len(self.pending) > self.t.in_flight:
            done.append(self._finish()[1])
        return done

    def drain(self):
        return [self._finish()[1] for _ in range(len(self.pending))]

    def warm(self, agree: Agree, log, min_rounds: int = 4,
             max_rounds: int = 12) -> None:
        """Rounds until two rounds in a row ran the same literal family
        as the two before (at least min_rounds, at most max_rounds)."""
        fams = []
        while True:
            before = families(self.db)
            self.step()
            self.drain()
            fams.append(_ran(before, families(self.db)))
            settled = len(fams) >= min_rounds and fams[-2:] == fams[-4:-2]
            if not agree.any(not settled and len(fams) < max_rounds):
                break
        log(f"warm-up: {len(fams)} rounds, families {fams}")

    def close(self) -> None:
        with _span("bench.close"):
            out = self.SS.close_streamset(self.db, self.ss)
        self.closed = {k: out[k] for k in self.flows}

    def check(self, cfg: dict, answer=None) -> Check:
        """Each sampled flow's matches, round by round and at the close,
        against the reference over the flow's whole stream: the rounds'
        and the close's matches that it gives. `answer(data, rs, write)`,
        if given, stands in for the program's matches (the control)."""
        R, rs = spec.reference(cfg), cfg["ruleset"]
        ck = Check()
        w = self.t.write
        for k in self.flows:
            data = self.t.stream(k, self.r)
            want, want_close = R.stream_matches(data, rs, w)
            if answer is None:
                got: Dict[int, list] = {}
                for r, m in self.got[k]:
                    got.setdefault(r, []).append(m)
                got_close = self.closed.get(k, [])
            else:
                got, got_close = answer(data, rs, w)
            for r in sorted(set(want) | set(got)):
                ck.add(got.get(r, []), want.get(r, []))
            ck.add(got_close, want_close)
        return ck
