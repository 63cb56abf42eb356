"""Stage spans and counters of the scan path.

Spans. `span(name)` is a context manager and `spanned(name)` a decorator
that runs a function inside one. While a `torch.profiler` records, a span
opens `torch.profiler.record_function(name)`, so the stage lands in the
profiler's trace as a `user_annotation` event on the timeline of the
kernels and copies; spans nest on one thread as the calls do. While no
profiler records, `span` returns the shared no-op `NOOP` after one read
of the profiler's state, and nothing is recorded. There is no other
switch: spans are on exactly while a trace is recorded (for example
`hsbench --profile DIR`).

| span | wraps |
|---|---|
| `hs.scan_batch` | `runtime.scan.scan_batch` (the root of a block call) |
| `hs.reports` | `scan_batch`'s `finalize_reports` loop |
| `hs.assemble` | `ops.teddy.flatten_blocks` |
| `hs.upload` | `ops.teddy.corpus_tensor` |
| `hs.dispatch` | `ops.teddy_families.confirm_start` |
| `hs.fetch` | `confirm_finish`, `confirm_fetch_many` (re-dispatches nest) |
| `hs.verify` | `runtime.lit_runtime.verify_pairs` |
| `hs.windows` | `finish_confirmed` (`hs.chains` nests) |
| `hs.chains` | `resolve_chains` |
| `hs.write_start` | `runtime.streamset.streamset_write_start` (a root) |
| `hs.write_finish` | `streamset_write_finish` (a root) |
| `hs.exchange` | `parallel.sharded._exchange`: on a mesh of several processes, the group's gather of the shards' finished matches (a block scan) or confirmed pairs (a stream scan) |

While a profiler records, each span's self time (its duration less the
spans nested in it on its thread) is also summed by name in `PROFILED`,
with the spans opened and the counters raised meanwhile, so that a
reader of a profiled window has the stages without the exported trace.
`reset_profiled()` empties it.

Counters, raised once per stage and never per match, flow or block:

- `COUNTS["redispatches"]`: capacity-overflow re-dispatches, in
  `confirm_finish`'s loop and the engine scans' retry loops
  (`ops.dfa_kernel._run_chunks`, `ops.nfa_kernel.nfa_scan_corpus`);
- `COUNTS["chain_exprs"]`: the chain expressions `resolve_chains` works
  through;
- `COUNTS["chain_passes"]`: the packed role scans `resolve_chains` runs,
  each over every chain expression at once (a forward pass over the
  windows, a reverse pass from the role matches): two a call at most,
  whatever `chain_exprs` reads;
- `COUNTS["verify_pairs"]`: the device-confirmed (fid, pos) pairs handed
  to `runtime.lit_runtime.verify_pairs`, raised once a call;
- `COUNTS["verify_passes"]`: the exact atom compares run
  (`lit_runtime._atoms_match`, from `verify_pairs` and the host route's
  long-tail confirm), one for each width class of factor length present
  in a call, whatever the number of distinct factors: one a call for a
  compiled database, whose factors are 16 bytes at most
  (`compiler.literals.MAX_FACTOR_LEN`);
- `COUNTS["exchanges"]`: the exchanges over a mesh's process group
  (`parallel.sharded._exchange`), one a sharded call on several
  processes;
- `COUNTS["exchange_bytes"]`: the bytes of the pairs this process hands
  to those exchanges (int64, 16 a pair), raised once an exchange;
- `COUNTS["stitch_pinned"]`: StreamSet write rounds whose extents
  `runtime.streamset.streamset_write_start`'s `chunks` form stitched
  into pinned host memory for their upload to a CUDA device, once a
  round;
- `ops._build.LAUNCHES`: launches per CUDA kernel;
- `ops.teddy_families.FamilyState.dispatches`: per literal database,
  dispatches by family.
"""

from __future__ import annotations

import dataclasses
import functools
import threading
import time
from typing import Dict

import torch
from torch.autograd import profiler as _profiler

COUNTS: Dict[str, int] = {"redispatches": 0, "chain_exprs": 0,
                          "chain_passes": 0, "verify_pairs": 0,
                          "verify_passes": 0, "exchanges": 0,
                          "exchange_bytes": 0, "stitch_pinned": 0}

_lock = threading.Lock()
_local = threading.local()  # .stack: the thread's open spans
_clock = time.perf_counter_ns


@dataclasses.dataclass
class Profiled:
    """What the spans and counters saw while a profiler recorded."""

    spans: Dict[str, int] = dataclasses.field(default_factory=dict)
    self_ns: Dict[str, int] = dataclasses.field(default_factory=dict)
    counts: Dict[str, int] = dataclasses.field(
        default_factory=lambda: dict.fromkeys(COUNTS, 0))


PROFILED = Profiled()


def reset_profiled() -> None:
    with _lock:
        PROFILED.spans.clear()
        PROFILED.self_ns.clear()
        PROFILED.counts.update(dict.fromkeys(COUNTS, 0))


def count(key: str, n: int = 1) -> None:
    """Raise `COUNTS[key]` by n (and `PROFILED.counts[key]` while a
    profiler records)."""
    with _lock:
        COUNTS[key] += n
        if _profiler._is_profiler_enabled:
            PROFILED.counts[key] += n


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP = _Noop()


class _Span:
    __slots__ = ("name", "_rec", "_t0", "_child")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._rec = torch.profiler.record_function(self.name)
        self._rec.__enter__()
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        stack.append(self)
        self._child = 0
        self._t0 = _clock()
        return self

    def __exit__(self, *exc):
        dur = _clock() - self._t0
        stack = _local.stack
        stack.pop()
        if stack:
            stack[-1]._child += dur
        with _lock:
            p = PROFILED
            p.spans[self.name] = p.spans.get(self.name, 0) + 1
            p.self_ns[self.name] = (p.self_ns.get(self.name, 0) + dur
                                    - self._child)
        self._rec.__exit__(*exc)
        return False


def span(name: str):
    """A stage span: `record_function(name)` while a profiler records,
    else `NOOP`."""
    if not _profiler._is_profiler_enabled:
        return NOOP
    return _Span(name)


def spanned(name: str):
    """Decorator: each call of the function runs inside `span(name)`."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not _profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            with _Span(name):
                return fn(*args, **kwargs)

        return inner

    return wrap
