"""Batched stream runtime: StreamSet — thousands of streams per write round.

Reference analogue: hs_scan_stream runs ONE stream per call
(src/rose/stream.c:545); its literal matcher stitches history+buffer into
one extent (hwlmExecStreaming, src/hwlm/hwlm.h:137). This runtime (the
port of hyperscan_tpu/runtime/streamset.py, its device dispatch on a
torch device) batches every stream's history+write extent into ONE
filter dispatch per round and keeps per-stream runtime state vectorized:

- `offsets` / histories as arrays, advanced with O(1) numpy per round
  (the per-stream Python of `scan_streams` costs ~5-10 us/stream/write —
  at 4096 streams that alone caps aggregate throughput below 1 GB/s):
  the histories are packed end to end in one buffer (`_History`), and a
  round's extents are stitched from them and the new chunks with no
  per-stream Python where the lengths are uniform (`_stitch`), straight
  into pinned host memory when the round uploads to a card;
- boundary dedupe / SINGLEMATCH / combination state held sparsely, only
  for streams that actually matched (dict-of-sets keyed by stream index);
- the literal filter runs over the whole concatenated extent corpus —
  candidates inside the history region deliver offsets at or before the
  previous write boundary and are dropped by the same dedupe rule as
  `scan_streams` (reference analogue: the delay-rebuild rescan of
  history, src/rose/stream.c:415, whose re-reports are suppressed).

High-rate deployments should `gc.freeze()` after opening databases
and stream sets: CPython's gen-2 collector otherwise rescans the whole
compile graph (hundreds of thousands of tracked objects at 10k-pattern
scale) every few write rounds — measured 145 ms pauses on the bench
host, halving 16384-stream aggregate throughput.

Write rounds can be PIPELINED for pure-literal databases: the filter
over history+chunk extents is stateless (history bytes are part of the
extent), so `streamset_write_start` dispatches round r+1's device filter
before round r's host stages run; only the host finish stages are
sequential (boundary dedupe / SINGLEMATCH state, chain evidence, general
engine states), in write order (enforced). A StreamSet records the torch
device its rounds scan on (`open_streamset(db, size, device="cuda")`, the
card by default; a missing card raises).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from ..database import Database
from ..errors import DbModeError, InvalidError
from ..flags import HS_MODE_STREAM, HS_MODE_VECTORED, base_mode, \
    som_horizon_span
from ..flags import (HS_FLAG_QUIET, HS_FLAG_SINGLEMATCH,
                     HS_FLAG_SOM_LEFTMOST, HS_OFFSET_PAST_HORIZON)
from ..trace import count, spanned
from .lit_runtime import LEAD_BOUNDARY
from .stream import Stream, _engine_pass, _update_chain_state, \
    history_required, stream_device
from .scan import Match, RecordSink, _pattern_arrays, finalize_reports


def _stateless_reports(db: Database) -> bool:
    """True when report delivery carries no cross-call state (no
    SINGLEMATCH, no logical combinations): the vectorized multi-stream
    finalize applies."""
    if not hasattr(db, "_stateless_rep"):
        db._stateless_rep = (
            not db.combos()
            and not db.som_eod_eids()  # boundary reports defer (stateful)
            and not any(p.flags & HS_FLAG_SINGLEMATCH
                        for p in db.patterns)
        )
    return db._stateless_rep


@dataclasses.dataclass
class StreamSet:
    """A batch of open streams with vectorized runtime state.

    State mirrors `runtime.stream.Stream` field for field; see
    `streamset_stream` for the exact correspondence (used by the EOD
    close pass and the state codec interop).
    """

    db: Database
    size: int
    device: torch.device  # where its rounds scan
    offsets: np.ndarray  # int64[S] absolute bytes consumed
    # per-stream history tails (<= history_required), flat (_History)
    hist: "_History"
    terminated: np.ndarray  # bool[S]
    closed: np.ndarray  # bool[S]
    # sparse per-stream sets, allocated only for streams that matched
    seen_single: Dict[int, set] = dataclasses.field(default_factory=dict)
    combo_matched: Dict[int, set] = dataclasses.field(default_factory=dict)
    recent: Dict[int, Set[Tuple[int, int]]] = dataclasses.field(
        default_factory=dict)
    # (stream, eidx, boundary) -> (sorted abs role-end offsets, run start)
    chain_state: Dict[Tuple[int, int, int], Tuple[List[int], int]] = \
        dataclasses.field(default_factory=dict)
    # deferred boundary reports of EOD-capable SOM patterns (see
    # Stream.pending), sparse per stream
    pending: Dict[int, Set[Tuple[int, int, int]]] = dataclasses.field(
        default_factory=dict)
    engine_states: List[list] = dataclasses.field(default_factory=list)
    # pipeline bookkeeping: rounds started / finished
    seq_started: int = 0
    seq_finished: int = 0


def open_streamset(db: Database, size: int, device="cuda") -> StreamSet:
    """Open `size` streams at once (reference: hs_open_stream xN), whose
    rounds scan on `device`: the card unless the caller passes another."""
    if base_mode(db.mode) not in (HS_MODE_STREAM, HS_MODE_VECTORED):
        raise DbModeError("database not compiled for streaming")
    return StreamSet(
        db=db,
        size=size,
        device=stream_device(device),
        offsets=np.zeros(size, dtype=np.int64),
        hist=_History.empty(size),
        terminated=np.zeros(size, dtype=bool),
        closed=np.zeros(size, dtype=bool),
        engine_states=[[e.start_state] * size for e in db.engines],
    )


class _History:
    """Every stream's history tail, packed end to end in stream order:
    stream i's is `buf[off[i]:off[i] + lens[i]]`, `off` the exclusive
    cumsum of `lens`. `buf` is a copy of its own, which nothing writes
    again: a round replaces the whole object, so a handle or a saved
    `_History` keeps reading the bytes it saw. Indexing and iteration
    give uint8 views."""

    __slots__ = ("buf", "off", "lens")

    def __init__(self, buf: np.ndarray, lens: np.ndarray):
        self.buf = buf  # uint8, C-contiguous, len == lens.sum()
        self.off = _exclusive_cumsum(lens)  # int64[S]
        self.lens = lens  # int64[S]

    @classmethod
    def empty(cls, size: int) -> "_History":
        return cls(np.zeros(0, dtype=np.uint8),
                   np.zeros(size, dtype=np.int64))

    def __len__(self) -> int:
        return len(self.off)

    def __getitem__(self, i: int) -> np.ndarray:
        o = int(self.off[i])
        return self.buf[o:o + int(self.lens[i])]

    def __iter__(self):
        for o, n in zip(self.off.tolist(), self.lens.tolist()):
            yield self.buf[o:o + n]


def _exclusive_cumsum(a: np.ndarray) -> np.ndarray:
    out = np.zeros(len(a), dtype=np.int64)
    if len(a) > 1:
        np.cumsum(a[:-1], out=out[1:])
    return out


def _pack(buf: np.ndarray, off: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """The segments `buf[off[i]:off[i] + lens[i]]` copied end to end into
    a new uint8 array: one strided copy when they share a length and lie
    at one stride, else one gather."""
    S = len(lens)
    n = int(lens[0]) if S else 0
    step = int(off[1] - off[0]) if S > 1 else 0
    if S and (lens == n).all() and step >= 0 and (np.diff(off) == step).all():
        return np.lib.stride_tricks.as_strided(
            buf[int(off[0]):], shape=(S, n), strides=(step, 1)).copy().ravel()
    idx = np.repeat(off - _exclusive_cumsum(lens), lens)
    return buf[idx + np.arange(len(idx))]


def _stitch(dst, hist, hlen, blob, clen) -> None:
    """Write every stream's extent, its history then its chunk, end to
    end into `dst`; `hist` and `blob` hold the histories and the chunks
    packed in stream order. Two strided copies when every history has
    one length and every chunk one, else a loop over the streams."""
    S = len(hlen)
    if S == 0:
        return
    h, c = int(hlen[0]), int(clen[0])
    if (hlen == h).all() and (clen == c).all():
        d = dst.reshape(S, h + c)
        d[:, :h] = hist.reshape(S, h)
        d[:, h:] = blob.reshape(S, c)
        return
    for s, ho, hn, co, cn in zip(_exclusive_cumsum(hlen + clen).tolist(),
                                 _exclusive_cumsum(hlen).tolist(),
                                 hlen.tolist(),
                                 _exclusive_cumsum(clen).tolist(),
                                 clen.tolist()):
        dst[s:s + hn] = hist[ho:ho + hn]
        dst[s + hn:s + hn + cn] = blob[co:co + cn]


def streamset_stream(ss: StreamSet, i: int) -> Stream:
    """Detached single-stream copy of stream `i` (state-codec and EOD
    interop: the returned Stream is semantically identical to one that
    consumed the same writes via scan_stream)."""
    if ss.seq_started != ss.seq_finished:
        raise InvalidError(
            "finish outstanding writes before snapshotting a stream "
            "(offsets/history already advanced, report state has not)")
    s = Stream(db=ss.db, device=ss.device)
    s.offset = int(ss.offsets[i])
    s.history = ss.hist[i].tobytes()
    s.terminated = bool(ss.terminated[i])
    s.closed = bool(ss.closed[i])
    s.engine_states = [ss.engine_states[ei][i]
                       for ei in range(len(ss.db.engines))]
    s.seen_single = set(ss.seen_single.get(i, ()))
    s.combo_matched = set(ss.combo_matched.get(i, ()))
    s.recent = set(ss.recent.get(i, ()))
    s.pending = set(ss.pending.get(i, ()))
    s.chain_state = {
        (e, r): (list(v[0]), v[1])
        for (b, e, r), v in ss.chain_state.items() if b == i
    }
    return s


def streamset_load(ss: StreamSet, i: int, s: Stream) -> None:
    """Replace stream `i`'s state from a Stream object (expand/copy
    interop — inverse of streamset_stream)."""
    if s.db is not ss.db:
        raise InvalidError("stream belongs to a different database")
    if ss.seq_started != ss.seq_finished:
        raise InvalidError(
            "finish outstanding writes before loading stream state")
    ss.offsets[i] = s.offset
    o, n = int(ss.hist.off[i]), int(ss.hist.lens[i])
    lens = ss.hist.lens.copy()
    lens[i] = len(s.history)
    ss.hist = _History(np.concatenate(
        [ss.hist.buf[:o], np.frombuffer(bytes(s.history), dtype=np.uint8),
         ss.hist.buf[o + n:]]), lens)
    ss.terminated[i] = s.terminated
    ss.closed[i] = s.closed
    for ei in range(len(ss.db.engines)):
        ss.engine_states[ei][i] = s.engine_states[ei]
    for d, v in ((ss.seen_single, s.seen_single),
                 (ss.combo_matched, s.combo_matched),
                 (ss.recent, s.recent),
                 (ss.pending, s.pending)):
        if v:
            d[i] = set(v)
        else:
            d.pop(i, None)
    for k in [k for k in ss.chain_state if k[0] == i]:
        del ss.chain_state[k]
    for (e, r), v in s.chain_state.items():
        ss.chain_state[(i, e, r)] = (list(v[0]), v[1])


class _ESAdapter:
    """Shim presenting one StreamSet slot as a Stream for the shared
    engine/chain passes in runtime.stream (offset/engine_states/
    history/chain_state views)."""

    __slots__ = ("ss", "i", "offset", "history", "engine_states",
                 "chain_state", "recent")

    def __init__(self, ss: StreamSet, i: int, offset: int, history: bytes):
        self.ss = ss
        self.i = i
        self.offset = offset
        self.history = history
        self.engine_states = [ss.engine_states[ei][i]
                              for ei in range(len(ss.db.engines))]
        self.chain_state = _ChainView(ss, i)
        self.recent = ss.recent.get(i, set())

    def store(self) -> None:
        for ei in range(len(self.ss.db.engines)):
            self.ss.engine_states[ei][self.i] = self.engine_states[ei]


class _ChainView:
    """Dict-like view of one stream's chain_state slice."""

    __slots__ = ("ss", "i")

    def __init__(self, ss: StreamSet, i: int):
        self.ss = ss
        self.i = i

    def get(self, key, default=None):
        return self.ss.chain_state.get((self.i,) + key, default)

    def items(self):
        for (b, e, r), v in self.ss.chain_state.items():
            if b == self.i:
                yield (e, r), v

    def __setitem__(self, key, value):
        self.ss.chain_state[(self.i,) + key] = value

    def pop(self, key, default=None):
        return self.ss.chain_state.pop((self.i,) + key, default)


@dataclasses.dataclass
class _WriteHandle:
    seq: int
    prev_offsets: np.ndarray  # int64[S] offsets before this write
    hlens: np.ndarray  # int64[S] history lengths stitched into extents
    lens: np.ndarray  # int64[S] chunk lengths
    starts: np.ndarray  # int64[S] flat extent starts
    ends: np.ndarray  # int64[S]
    ext_np: np.ndarray  # uint8 flat concatenated extents (host mirror)
    anchored: np.ndarray  # bool[S]
    # ops.teddy_families.confirm_start handle (device path); it holds the
    # round's extent tensor, which an overflow re-dispatches over
    dev_handle: object = None
    host_pairs: Optional[Tuple[np.ndarray, np.ndarray]] = None
    chunks: Optional[List[bytes]] = None  # only when engines need them




@spanned("hs.write_start")
def streamset_write_start(
    db: Database,
    ss: StreamSet,
    chunks: Optional[Sequence[bytes]] = None,
    *,
    ext_np: Optional[np.ndarray] = None,
    ext_t: Optional[torch.Tensor] = None,
    hlens: Optional[np.ndarray] = None,
    chunk_lens: Optional[np.ndarray] = None,
    capacity: int = 1 << 14,
) -> _WriteHandle:
    """Dispatch one write round's filter work; returns a handle for
    streamset_write_finish.

    Two entry forms:
    - `chunks`: per-stream write payloads (host bytes). Extents are
      stitched here in one pass, into pinned host memory when the round
      uploads to a CUDA device (counter `stitch_pinned`); the filter runs
      on host (small totals) or on the streamset's device (large totals,
      extents uploaded once).
    - `ext_np` (+ optional `ext_t`): the caller already holds the
      concatenated history+chunk extents — `ext_np` as a flat host uint8
      mirror and (optionally) `ext_t` as the same bytes in a flat uint8
      tensor already on the streamset's device. `hlens[i]` gives each
      stream's stitched history length (defaults to the stream's current
      history length) and `chunk_lens[i]` the new bytes per stream. With
      `ext_t` the round filters on the device without an upload here.

    Rounds PIPELINE for every database shape: start() only stitches
    extents and dispatches the stateless literal filter (history bytes
    are part of the extent); all cross-write scan state — boundary
    dedupe, chain/infix evidence, general engine states — advances in
    streamset_write_finish, which enforces write order.
    """
    if ss.closed.any():
        raise InvalidError("streamset contains closed streams")
    S = ss.size
    if chunks is not None:
        if len(chunks) != S:
            raise InvalidError("chunks length != streamset size")
        if not set(map(type, chunks)) <= {bytes}:
            chunks = [bytes(c) for c in chunks]
        lens = np.fromiter(map(len, chunks), dtype=np.int64, count=S)
        hl = ss.hist.lens
    else:
        if ext_np is None:
            raise InvalidError("need chunks or ext_np")
        if chunk_lens is None:
            raise InvalidError("ext_np form requires chunk_lens")
        lens = np.asarray(chunk_lens, dtype=np.int64)
        hl = ss.hist.lens if hlens is None else \
            np.asarray(hlens, dtype=np.int64)
    ext_lens = hl + lens
    starts = _exclusive_cumsum(ext_lens)
    ends = starts + ext_lens
    total_ext = int(ends[-1]) if S else 0
    from .smallwrite import HOST_SCAN_LIMIT

    limit = getattr(db, "host_scan_limit", HOST_SCAN_LIMIT)
    on_device = db.lit is not None and (ext_t is not None
                                        or total_ext > limit)
    if chunks is not None:
        # the upload reads the buffer the stitch writes: pinned when it
        # is a DMA to a card. Each round takes a buffer of its own, held
        # by its handle
        pinned = on_device and ext_t is None and ss.device.type == "cuda"
        ext_np = (torch.empty(total_ext, dtype=torch.uint8,
                              pin_memory=True).numpy() if pinned
                  else np.empty(total_ext, dtype=np.uint8))
        blob = np.frombuffer(b"".join(chunks), dtype=np.uint8)
        _stitch(ext_np, ss.hist.buf, hl, blob, lens)
        if pinned:
            count("stitch_pinned")
    if total_ext != int(ext_np.shape[0]):
        raise InvalidError("ext_np length != sum of extents")
    anchored = (ss.offsets - hl) == 0

    h = _WriteHandle(
        seq=ss.seq_started + 1,
        prev_offsets=ss.offsets.copy(),
        hlens=hl, lens=lens, starts=starts, ends=ends,
        ext_np=ext_np, anchored=anchored,
        # a copy: the caller may refill its list before the finish
        chunks=list(chunks) if db.engines and chunks is not None else None,
    )
    if db.engines and chunks is None:
        # engine pass needs the chunk payloads; slice them from ext_np
        h.chunks = [
            ext_np[int(starts[i] + hl[i]): int(ends[i])].tobytes()
            for i in range(S)
        ]

    # literal filter dispatch
    if db.lit is not None:
        from .smallwrite import teddy_filter_host

        total = total_ext
        if on_device:
            from ..ops.teddy import corpus_tensor
            from ..ops.teddy_families import confirm_start

            if ext_t is None:
                ext_t = corpus_tensor(ext_np, ss.device)
            elif ext_t.dtype != torch.uint8 or ext_t.dim() != 1 \
                    or ext_t.numel() != total \
                    or ext_t.device != ss.device:
                raise InvalidError(
                    "ext_t must be a flat uint8 tensor of the extents on "
                    f"the streamset's device {ss.device}")
            h.dev_handle = confirm_start(ext_t, db.lit, total, capacity)
        else:
            pos, words = teddy_filter_host(ext_np, db.lit.masks)
            from .lit_runtime import confirm_candidates

            h.host_pairs = confirm_candidates(
                db.lit, ext_np, starts, pos, words)

    # state advance: next round's extents stitch on the new history, the
    # tail of each extent, copied out so that nothing holds the extents
    hist_req = history_required(db)
    ss.offsets = ss.offsets + lens
    if hist_req == 0 or S == 0:
        ss.hist = _History.empty(S)
    else:
        keep = np.minimum(ext_lens, hist_req)
        ss.hist = _History(_pack(np.ascontiguousarray(ext_np, dtype=np.uint8),
                                 ends - keep, keep), keep)
    ss.seq_started += 1
    return h


@spanned("hs.write_finish")
def streamset_write_finish(
    db: Database,
    ss: StreamSet,
    h: _WriteHandle,
    callbacks: Optional[Sequence[Optional[Callable]]] = None,
    got: Optional[np.ndarray] = None,
) -> List[List[Match]]:
    """Run the host stages of a started write round and deliver matches.

    Must be called in write order. `got` optionally supplies the
    already-fetched device result buffer (ops.teddy_families.
    confirm_fetch_many reads many rounds' buffers in one copy)."""
    if h.seq != ss.seq_finished + 1:
        raise InvalidError("streamset writes must finish in order")
    S = ss.size
    callbacks = callbacks or [None] * S
    recs_abs: Dict[int, Set[Tuple[int, int, int]]] = {}
    ranges_abs: Dict[int, List[Tuple[int, int, int]]] = {}

    if db.lit is not None:
        from .lit_runtime import finish_confirmed, verify_pairs

        if h.dev_handle is not None:
            from ..ops.teddy_families import confirm_finish

            fid_a, p_a = confirm_finish(h.dev_handle, got=got)
            fid_a, p_a = verify_pairs(db.lit, h.ext_np, h.starts, fid_a, p_a)
        else:
            fid_a, p_a = h.host_pairs or (np.zeros(0, np.int64),) * 2

        has_chains = bool(db.lit.chains)
        chain_ctx = None
        chain_out = None
        if has_chains:
            chain_ctx = {}
            chain_out = {}
            from .lit_runtime import chain_ctx_record

            base_abs_v = h.prev_offsets - h.hlens
            for (bi, eidx, r), (c_ends, c_run) in ss.chain_state.items():
                if c_ends or r == LEAD_BOUNDARY:
                    # infix boundaries carry an arbitrary-width NFA mask
                    # at c_ends[0] — chain_ctx_record keeps those as
                    # lists (int64 overflows past 62 infix positions)
                    chain_ctx[(bi, eidx, r)] = chain_ctx_record(
                        db.lit, eidx, r, c_ends, c_run,
                        int(base_abs_v[bi]))
        rng: List[Tuple[int, int, int, int]] = []
        recs = finish_confirmed(
            db, h.ext_np, h.starts, h.ends, fid_a, p_a,
            block_anchored=h.anchored,
            block_final=np.zeros(S, dtype=bool),
            chain_ctx=chain_ctx, chain_out=chain_out,
            ranges_out=rng,
        )
        # deliver: history-region re-reports end at or before the previous
        # boundary and drop; boundary-offset records dedupe via `recent`
        for (bi, eidx, to_local, frm) in recs:
            base = int(h.prev_offsets[bi] - h.hlens[bi])
            to_abs = base + to_local
            prev_off = int(h.prev_offsets[bi])
            if to_abs > prev_off or (
                to_abs == prev_off
                and (eidx, to_abs) not in ss.recent.get(bi, ())
            ):
                recs_abs.setdefault(bi, set()).add(
                    (eidx, to_abs, base + frm))
        for (bi, eidx, lo_local, hi_local) in rng:
            base = int(h.prev_offsets[bi] - h.hlens[bi])
            lo_abs = max(base + lo_local, int(h.prev_offsets[bi]) + 1)
            hi_abs = base + hi_local
            if hi_abs >= lo_abs:
                ranges_abs.setdefault(bi, []).append((eidx, lo_abs, hi_abs))
        if has_chains:
            from .stream import _chains_sweep_always

            # all-infix rulesets only need the (stream, chain) pairs
            # with evidence — skip the per-round extent copies entirely
            # when nothing is live
            if (_chains_sweep_always(db.lit) or chain_out
                    or ss.chain_state):
                needed = (range(S) if _chains_sweep_always(db.lit) else
                          sorted({b for (b, _e, _r) in chain_out}
                                 | {b for (b, _e, _r) in ss.chain_state}))
                adapters = [
                    _ESAdapter(ss, i, int(h.prev_offsets[i]),
                               h.ext_np[int(h.starts[i]):
                                        int(h.starts[i] + h.hlens[i])
                                        ].tobytes())
                    for i in needed
                ]
                exts = [
                    h.ext_np[int(h.starts[i]):int(h.ends[i])].tobytes()
                    for i in needed
                ]
                starts_n = h.starts[list(needed)]
                # remap chain_out block indices to the reduced list
                imap = {b: k for k, b in enumerate(needed)}
                co = {(imap[b], e, r): v
                      for (b, e, r), v in chain_out.items()}
                _update_chain_state(db, adapters, exts, starts_n, co)

    if db.engines:
        adapters = [
            _ESAdapter(ss, i, int(h.prev_offsets[i]), b"")
            for i in range(S)
        ]
        recs_l = [set() for _ in range(S)]
        rngs_l = [[] for _ in range(S)]
        _engine_pass(db, adapters, h.chunks, recs_l, rngs_l, ss.device)
        for a in adapters:
            a.store()
        for i in range(S):
            if recs_l[i]:
                recs_abs.setdefault(i, set()).update(recs_l[i])
            if rngs_l[i]:
                ranges_abs.setdefault(i, []).extend(rngs_l[i])

    # finalize per matched stream; advance dedupe state vectorized
    out: List[List[Match]] = [[] for _ in range(S)]
    new_offsets = h.prev_offsets + h.lens
    touched = set(recs_abs) | set(ranges_abs) | set(ss.pending)
    fast = _stateless_reports(db) and not ranges_abs \
        and all(cb is None for cb in callbacks)
    if fast and touched:
        # one vectorized report pass over every matched stream (bounds,
        # QUIET, dedupe/min-merge, offset order), split per stream at
        # the end — per-stream Python only where a callback or stateful
        # flag demands it. At 16k streams x 8KB writes the per-stream
        # finalize was the round's dominant cost.
        rows = [(bi, e, t, f) for bi in touched
                for (e, t, f) in recs_abs[bi]]
        arr = np.asarray(rows, dtype=np.int64)
        bi_a, e_a, t_a, f_a = arr[:, 0], arr[:, 1], arr[:, 2], arr[:, 3]
        minoff, maxoff, minlen, flags, extid = _pattern_arrays(db)
        keep = (t_a >= minoff[e_a]) & (t_a <= maxoff[e_a])
        ml = minlen[e_a]
        keep &= (ml == 0) | ((t_a - f_a) >= ml)
        keep &= (flags[e_a] & HS_FLAG_QUIET) == 0
        bi_a, e_a, t_a, f_a = (x[keep] for x in (bi_a, e_a, t_a, f_a))
        order = np.lexsort((f_a, e_a, t_a, bi_a))
        bi_a, e_a, t_a, f_a = (x[order] for x in (bi_a, e_a, t_a, f_a))
        if len(t_a):
            first = np.ones(len(t_a), dtype=bool)
            first[1:] = ((t_a[1:] != t_a[:-1]) | (e_a[1:] != e_a[:-1])
                         | (bi_a[1:] != bi_a[:-1]))
            bi_a, e_a, t_a, f_a = (x[first]
                                   for x in (bi_a, e_a, t_a, f_a))
        som = (flags[e_a] & HS_FLAG_SOM_LEFTMOST) != 0
        horizon = som_horizon_span(db.mode)
        rep_f = np.where(som, f_a, 0)
        if horizon is not None:
            past = som & (t_a - f_a > horizon)
            rep_f = np.where(past, -1, rep_f)
        ext = extid[e_a]
        el, fl_, tl, bl = (ext.tolist(), rep_f.tolist(), t_a.tolist(),
                           bi_a.tolist())
        term = ss.terminated if ss.terminated.any() else None
        for j in range(len(el)):
            if term is not None and term[bl[j]]:
                continue  # no delivery after callback termination
            fv = fl_[j]
            if fv < 0:
                fv = HS_OFFSET_PAST_HORIZON
            out[bl[j]].append((el[j], fv, tl[j]))
        # boundary dedupe entries (records at the new boundary)
        for bi in touched:
            new_off = int(new_offsets[bi])
            rec_new = {(e, t) for (e, t, _f) in recs_abs[bi]
                       if t >= new_off}
            old = ss.recent.get(bi)
            if old:
                rec_new |= {(e, t) for (e, t) in old if t >= new_off}
            if rec_new:
                ss.recent[bi] = rec_new
            elif old:
                del ss.recent[bi]
        touched = set()  # scalar loop below skipped
    risk = db.som_eod_eids()
    for bi in touched:
        new_off = int(new_offsets[bi])
        recs_bi = recs_abs.get(bi, set()) | ss.pending.get(bi, set())
        rngs_bi = list(ranges_abs.get(bi, ()))
        new_pending: Set[Tuple[int, int, int]] = set()
        if risk:
            # defer boundary reports of EOD-capable SOM patterns (see
            # Stream.pending)
            new_pending = {(e, t, f) for (e, t, f) in recs_bi
                           if t == new_off and e in risk}
            recs_bi -= new_pending
            if any(e in risk and hi == new_off
                   for (e, _lo, hi) in rngs_bi):
                clipped = []
                for (eid, lo, hi) in rngs_bi:
                    if eid in risk and hi == new_off:
                        new_pending.add((eid, new_off, new_off))
                        hi -= 1
                    if hi >= lo:
                        clipped.append((eid, lo, hi))
                rngs_bi = clipped
        if new_pending:
            ss.pending[bi] = new_pending
        else:
            ss.pending.pop(bi, None)
        if ss.terminated[bi] or (not recs_bi and not rngs_bi):
            ms = []  # no delivery (terminated, or all records deferred)
        else:
            seen = ss.seen_single.setdefault(bi, set())
            combo = ss.combo_matched.setdefault(bi, set())
            sink = RecordSink()
            sink.single = recs_bi
            for (eid, lo, hi) in rngs_bi:
                sink.add_range(eid, lo, hi)
            ms, terminated = finalize_reports(
                db, sink.materialize(None, db.som_eids()), callbacks[bi],
                seen_single=seen, combo_matched=combo, at_end=False,
                som_horizon=som_horizon_span(db.mode),
            )
            if terminated:
                ss.terminated[bi] = True
        out[bi] = ms
        rec_new = {(e, t) for (e, t, _f) in recs_abs.get(bi, ())
                   if t >= new_off} | {
            (e, t) for (e, t, _f) in new_pending} | {
            (eid, t) for (eid, lo, hi) in ranges_abs.get(bi, ())
            for t in range(max(lo, new_off), hi + 1)}
        old = ss.recent.get(bi)
        if old:
            rec_new |= {(e, t) for (e, t) in old if t >= new_off}
        if rec_new:
            ss.recent[bi] = rec_new
        elif old:
            del ss.recent[bi]
    # boundary entries of untouched streams expire when the offset moves
    if ss.recent:
        for bi in [b for b in ss.recent if b not in touched]:
            if int(h.lens[bi]) == 0:
                continue  # zero-length write: boundary unchanged
            new_off = int(new_offsets[bi])
            kept = {(e, t) for (e, t) in ss.recent[bi] if t >= new_off}
            if kept:
                ss.recent[bi] = kept
            else:
                del ss.recent[bi]
    ss.seq_finished += 1
    return out


def scan_streamset(
    db: Database,
    ss: StreamSet,
    chunks: Sequence[bytes],
    callbacks: Optional[Sequence[Optional[Callable]]] = None,
) -> List[List[Match]]:
    """One synchronous write round over the whole StreamSet."""
    h = streamset_write_start(db, ss, chunks)
    return streamset_write_finish(db, ss, h, callbacks)


def close_streamset(
    db: Database,
    ss: StreamSet,
    callbacks: Optional[Sequence[Optional[Callable]]] = None,
) -> List[List[Match]]:
    """Close every stream, delivering EOD matches (reference:
    hs_close_stream per stream, src/runtime.c:999)."""
    if ss.seq_started != ss.seq_finished:
        raise InvalidError("finish outstanding writes before closing")
    from .stream import close_stream

    callbacks = callbacks or [None] * ss.size
    out: List[List[Match]] = []
    for i in range(ss.size):
        if ss.closed[i]:
            raise InvalidError("stream already closed")
        s = streamset_stream(ss, i)
        out.append(close_stream(s, callbacks[i]))
        ss.closed[i] = True
        ss.terminated[i] = s.terminated
    return out
