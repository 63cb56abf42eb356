"""Streaming runtime: stream lifecycle, history rescan, EOD semantics.

Reference analogues:
- stream object + lifecycle: hs_open/scan/close/reset/copy_stream
  (src/runtime.c:511,980,999,713; struct hs_stream src/state.h:54)
- history maintenance at each write boundary: maintainHistoryBuffer
  (src/runtime.c:478) — here the history tail is re-scanned by the literal
  path each write, the same job as the delay-rebuild rescan
  (src/rose/stream.c:415 do_rebuild)
- carried engine state: roseSaveNfaStreamState/loadStreamState — here the
  general DFA engines carry one int state per (stream, engine)
- EOD reporting on close: report_eod_matches (src/runtime.c:632)
- state codec: hs_compress_stream / hs_expand_stream (src/runtime.c:1177,
  src/stream_compress.c)

Port of hyperscan_tpu/runtime/stream.py with its device branches on a
torch device. `scan_streams` batches many streams into one device
dispatch: the literal filter runs over the concatenated history+chunk
extents (`lit_runtime.scan_literal_path`), and large writes of bounded
and unbounded DFA engines scan on kernel C entered in the carried
per-stream states (`ops.dfa_kernel`). Per-stream `scan_stream` is the
1-stream special case. A stream records the torch device it scans on
(`open_stream(db, device="cuda")`, the card by default; a missing card
raises). The state codec is the reference's, byte for byte, so a
compressed stream moves between the two packages.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from ..database import Database
from ..errors import DbModeError, InvalidError, ScanTerminated
from ..flags import (HS_MODE_STREAM, HS_MODE_VECTORED, base_mode,
                     som_horizon_span)
from .scan import Match, finalize_reports, mesh_device, resolve_device

STREAM_MAGIC = b"HSTPUST5"  # v5: chain-state head entry is
# length-prefixed bytes (general-infix NFA masks may exceed 64 bits)


def history_required(db: Database) -> int:
    """Bytes of history each stream must keep so that any match ending in
    a new chunk has its factor candidate, confirm bytes and validation
    window fully inside history+chunk (reference analogue:
    RoseEngine historyRequired). One formula, shared with the infix
    capture points (lit_runtime.lit_history_required) — history
    retention and mask-capture positions must agree exactly."""
    from .lit_runtime import lit_history_required

    return lit_history_required(db.lit) if db.lit is not None else 0


@dataclasses.dataclass
class Stream:
    """An open stream (reference: hs_stream_t)."""

    db: Database
    device: torch.device  # where its writes scan
    offset: int = 0  # absolute bytes consumed
    history: bytes = b""
    engine_states: List[int] = dataclasses.field(default_factory=list)
    terminated: bool = False
    closed: bool = False
    seen_single: Set[int] = dataclasses.field(default_factory=set)
    # logical vector: external ids matched so far (reference: logicalVector)
    combo_matched: Set[int] = dataclasses.field(default_factory=set)
    # (expr_idx, to_abs) reported near the last write boundary, used to
    # dedupe the literal path's history rescan
    recent: Set[Tuple[int, int]] = dataclasses.field(default_factory=set)
    # chain evidence (reference analogue: rose role state): per
    # (pattern idx, gap boundary role) -> (sorted absolute role-end
    # offsets within the live gap run, absolute start of that run)
    chain_state: Dict[Tuple[int, int], Tuple[List[int], int]] = \
        dataclasses.field(default_factory=dict)
    # deferred boundary reports of EOD-capable SOM patterns: a match
    # ending exactly at the current stream end may gain an EARLIER
    # leftmost start from a $-anchored alternative at close, so its
    # report holds here until the next write (boundary becomes interior)
    # or close (min-merged with the EOD pass)
    pending: Set[Tuple[int, int, int]] = dataclasses.field(
        default_factory=set)

    def _init_states(self) -> None:
        self.engine_states = [e.start_state for e in self.db.engines]


def stream_device(device) -> torch.device:
    """The torch device streams scan on: `resolve_device`'s (a missing
    card raises), a card named without an index taken as the current
    one, so that host threads can make it current."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def open_stream(db: Database, device="cuda") -> Stream:
    """reference: hs_open_stream (src/runtime.c:511). The stream's writes
    scan on `device`: the card unless the caller passes another."""
    if base_mode(db.mode) not in (HS_MODE_STREAM, HS_MODE_VECTORED):
        raise DbModeError("database not compiled for streaming")
    s = Stream(db=db, device=stream_device(device))
    s._init_states()
    return s


def copy_stream(stream: Stream) -> Stream:
    """reference: hs_copy_stream (src/runtime.c:713)."""
    return dataclasses.replace(
        stream,
        engine_states=list(stream.engine_states),
        seen_single=set(stream.seen_single),
        combo_matched=set(stream.combo_matched),
        recent=set(stream.recent),
        chain_state={k: (list(v[0]), v[1])
                     for k, v in stream.chain_state.items()},
        pending=set(stream.pending),
    )


def _engine_pass(db, streams, chunks, recs_abs, ranges_abs, device):
    """Advance general engines over this write's chunks (batched lanes);
    large writes of DFA engines scan on `device`."""
    if not db.engines:
        return
    from ..database import NfaEngine
    from .scan import engine_scan_host

    B = len(streams)
    maxlen = max(len(c) for c in chunks)
    data = np.zeros((B, max(1, maxlen)), dtype=np.uint8)
    lengths = np.zeros((B,), dtype=np.int32)
    for i, c in enumerate(chunks):
        a = np.frombuffer(c, dtype=np.uint8)
        data[i, : len(a)] = a
        lengths[i] = len(a)
    from ..database import LbrEngine, SomEngine

    for ei, engine in enumerate(db.engines):
        init = [st.engine_states[ei] for st in streams]
        if isinstance(engine, LbrEngine):
            # counter engine: one carried run length per stream; match
            # ends inside a run are contiguous, so emit to-ranges
            runs, finals = engine.scan_runs(data, lengths, init)
            for bi, st in enumerate(streams):
                r = runs[bi]
                if len(r):
                    tos = st.offset + r + 1
                    cuts = np.flatnonzero(np.diff(tos) > 1)
                    los = np.concatenate([[0], cuts + 1])
                    his = np.concatenate([cuts, [len(tos) - 1]])
                    for (a, b) in zip(los.tolist(), his.tolist()):
                        ranges_abs[bi].append(
                            (engine.eidx, int(tos[a]), int(tos[b]))
                        )
                st.engine_states[ei] = int(finals[bi])
            _vacuous_stream_reports(engine, streams, chunks, recs_abs,
                                    ranges_abs)
            continue
        if isinstance(engine, SomEngine):
            # SOM engines carry (activation, leftmost-start registers)
            # per stream; registers hold absolute offsets
            from .nfa_host import som_scan_host

            base = np.asarray([st.offset for st in streams], np.int64)
            hits, finals = som_scan_host(engine, data, lengths, init, base)
            for bi, st in enumerate(streams):
                for (t, sid, frm) in hits[bi]:
                    for (eidx, adj) in engine.expand_set(1 << (sid - 1)):
                        to_abs = st.offset + t + 1 + adj
                        if to_abs >= 0:
                            recs_abs[bi].add((eidx, to_abs, frm))
                st.engine_states[ei] = finals[bi]
            _vacuous_stream_reports(engine, streams, chunks, recs_abs,
                                    ranges_abs)
            continue
        if not isinstance(engine, NfaEngine):
            init = np.asarray(init, dtype=np.int32)
            from ..database import MAX_HALO_DEPTH
            from .smallwrite import HOST_SCAN_LIMIT

            total = int(lengths.sum())
            limit = getattr(db, "host_scan_limit", HOST_SCAN_LIMIT)
            if total > limit:
                # large write: the same device kernels as block mode,
                # entered in the carried per-stream states (reference:
                # src/rose/stream.c:545 scans stream bodies with the
                # block engines + resumed state). Bounded engines take
                # the exact chunk-halo kernel, unbounded ones the
                # speculative chunk kernel with host entry fixup.
                bounded = (engine.max_depth is not None
                           and engine.max_depth <= MAX_HALO_DEPTH)
                from ..ops.dfa_kernel import (
                    dfa_scan_corpus_device,
                    dfa_scan_corpus_device_speculative,
                )

                scan_fn = (dfa_scan_corpus_device if bounded
                           else dfa_scan_corpus_device_speculative)
                (bi_a, pos_a, sid_a), finals = scan_fn(
                    engine, chunks, np.zeros(B, dtype=bool),
                    init_states=init, device=device,
                )
                for bi, st in enumerate(streams):
                    sel = bi_a == bi
                    for sid in np.unique(sid_a[sel]):
                        pp = pos_a[sel][sid_a[sel] == sid]
                        for (eidx, adj) in engine.expand_set(int(sid)):
                            tos = st.offset + pp + 1 + adj
                            tos = tos[tos >= 0]
                            for t in tos.tolist():
                                recs_abs[bi].add((eidx, int(t), 0))
                    st.engine_states[ei] = int(finals[bi])
                _vacuous_stream_reports(engine, streams, chunks, recs_abs,
                                        ranges_abs)
                continue
        # general engines carry per-stream state byte-serially; the
        # native host runtime handles this
        hits, finals = engine_scan_host(engine, data, lengths, init)
        for bi, st in enumerate(streams):
            hp, hv = hits[bi]
            for (t, sid) in zip(hp.tolist(), hv.tolist()):
                for (eidx, adj) in engine.expand_set(sid):
                    to_abs = st.offset + t + 1 + adj
                    if to_abs >= 0:
                        recs_abs[bi].add((eidx, to_abs, 0))
            st.engine_states[ei] = int(finals[bi])
        _vacuous_stream_reports(engine, streams, chunks, recs_abs,
                                ranges_abs)


def _chains_sweep_always(lit) -> bool:
    """True when some chain carries class-run state that advances on
    every byte (class gaps / lead / trail): the per-write sweep must
    visit every (stream, chain) pair. All-infix rulesets only need the
    pairs with evidence. Cached per lit."""
    if not hasattr(lit, "_sweep_always"):
        lit._sweep_always = any(
            ch.lead is not None or ch.trail is not None
            or len(getattr(ch, "infix", {})) < ch.num_roles - 1
            for ch in lit.chains.values()
        )
    return lit._sweep_always


def _update_chain_state(db, streams, exts, flat_starts, chain_out) -> None:
    """Advance per-stream chain evidence: merge newly validated prefix
    ends, restart gap runs at bad bytes, prune dead evidence (reference
    analogue: saving rose role state per stream)."""
    from .lit_runtime import LEAD_BOUNDARY

    CAP = 4096  # evidence cap per (stream, chain, boundary)
    # chains whose boundaries are ALL general infixes have no class-run
    # state to maintain; touch them only where evidence exists (at 10k
    # patterns a sixth of the ruleset is infix chains — an unconditional
    # stream x chain sweep is the per-write bottleneck). Chains with
    # class gaps keep the full sweep (run state advances on every byte).
    lit = db.lit
    if not hasattr(lit, "_class_chain_ids"):
        lit._class_chain_ids = [
            eidx for eidx, ch in lit.chains.items()
            if ch.lead is not None or ch.trail is not None
            or len(getattr(ch, "infix", {})) < ch.num_roles - 1
        ]
    class_ids = lit._class_chain_ids
    touched_by_stream: Dict[int, Set[int]] = {}
    for (bi, eidx, _r) in chain_out:
        touched_by_stream.setdefault(bi, set()).add(eidx)
    for bi, st in enumerate(streams):
        tb = touched_by_stream.get(bi, set())
        for (key, _v) in list(st.chain_state.items()):
            tb.add(key[0])
        if tb:
            touched_by_stream[bi] = tb
        base_abs = st.offset - len(st.history)
        ext = None
        new_boundary = base_abs + len(exts[bi])
        chain_ids = sorted(set(class_ids) | tb) if tb else class_ids
        for eidx in chain_ids:
            ch = lit.chains[eidx]
            if ext is None:
                ext = np.frombuffer(exts[bi], np.uint8)
            # boundaries to advance: mid gaps carry role ends inside the
            # live gap run; the lead boundary carries only its run; the
            # trail boundary (index R-1) carries final-role ends whose
            # trailing run is still alive (MPV-puff pending state)
            bounds = [(r, ch.gap_bits[r], None)
                      for r in range(ch.num_roles - 1)]
            if ch.lead is not None:
                bounds.append(
                    (LEAD_BOUNDARY, ch.gap_bits[ch.lead[0]], None))
            if ch.trail is not None:
                bounds.append(
                    (ch.num_roles - 1, ch.gap_bits[ch.trail[0]],
                     ch.trail[2]))
            for (r, gb, ghi) in bounds:
                if getattr(ch, "infix", None) and r in ch.infix:
                    # general-gap boundary: carried state is the infix
                    # NFA mask at the next extent start plus recent end
                    # positions (resolve_chains wrote an "imask" record)
                    rec = chain_out.get((bi, eidx, r))
                    if rec is None:
                        continue  # chain untouched this write
                    _tag, mask, keeps, cap_flat = rec
                    fs = int(flat_starts[bi])
                    cap_abs = base_abs + (int(cap_flat) - fs)
                    ends_abs = [base_abs + (int(p) - fs) for p in keeps]
                    if mask or ends_abs:
                        st.chain_state[(eidx, r)] = (
                            [int(mask)] + ends_abs, cap_abs)
                    else:
                        # dead: remove outright (a permanent placeholder
                        # would keep the stream in the evidence sweep and
                        # grow chain_state without bound)
                        st.chain_state.pop((eidx, r), None)
                    continue
                c_ends, c_run = st.chain_state.get((eidx, r), ([], 0))
                bad = np.flatnonzero(~gb[ext]) if len(ext) else \
                    np.zeros(0, np.int64)
                if len(bad):
                    c_run = max(c_run, base_abs + int(bad[-1]) + 1)
                new = chain_out.get((bi, eidx, r))
                merged = set(p for p in c_ends if p >= c_run)
                if new is not None:
                    fs = int(flat_starts[bi])
                    for p in np.asarray(new).tolist():
                        p_abs = base_abs + (int(p) - fs)
                        if p_abs >= c_run:
                            merged.add(p_abs)
                if ghi is not None:
                    # bounded trailing gap: ends fully emitted by the new
                    # boundary are dead
                    merged = {p for p in merged if p + ghi >= new_boundary}
                elif r == ch.num_roles - 1 and ch.trail is not None \
                        and merged:
                    # unbounded trailing gap: all pending ends share one
                    # live run, so the earliest subsumes the rest
                    merged = {min(merged)}
                ends = sorted(merged)[-CAP:]
                if ends or c_run or r == LEAD_BOUNDARY:
                    st.chain_state[(eidx, r)] = (ends, c_run)


def _vacuous_stream_reports(engine, streams, chunks, recs_abs,
                            ranges_abs) -> None:
    """Empty-match reports at every new offset of this write, recorded as
    lazy to-ranges (O(1) per write instead of O(bytes) Python)."""
    for bi, st in enumerate(streams):
        n = len(chunks[bi])
        for (anchored, eod, adj, eid) in engine.start_reports:
            if eod:
                continue  # EOD start reports fire at close
            if anchored:
                # st.recent suppresses the re-report when a zero-length
                # first write already delivered this (offset stays 0)
                if st.offset == 0 and (eid, adj) not in st.recent:
                    recs_abs[bi].add((eid, adj, adj))  # empty: frm == to
            else:
                lo = 0 if st.offset == 0 else st.offset + 1
                if lo == st.offset and (eid, lo + adj) in st.recent:
                    lo += 1  # boundary offset already reported
                lo_to = max(lo + adj, 0)
                hi_to = st.offset + n + adj
                if hi_to >= lo_to:
                    ranges_abs[bi].append((eid, lo_to, hi_to))


def _scan_streams_sharded(db, exts, anchored, mesh, chain_ctx, chain_out,
                          has_chains, deliver, deliver_range) -> None:
    """Literal path of a stream write batch sharded across the mesh
    (`parallel.sharded.sharded_literal_confirm`: each shard runs the
    literal path's own family dispatch on its device): streams partition
    data-parallel; chain role state remaps between global stream indices
    and shard-local block indices."""
    from ..parallel.sharded import sharded_literal_confirm
    from .lit_runtime import finish_confirmed, verify_pairs

    B = len(exts)
    lens = np.asarray([len(e) for e in exts], dtype=np.int64)
    g_starts = np.zeros(B, dtype=np.int64)
    if B > 1:
        np.cumsum(lens[:-1], out=g_starts[1:])
    for (g, fid_a, p_a, corpus_d, starts_d, ends_d) in \
            sharded_literal_confirm(db.lit, exts, mesh, 1 << 14):
        if not len(g):
            continue
        anch_g = anchored[np.asarray(g, dtype=np.int64)]
        ctx_g = None
        out_g = None
        if has_chains:
            gmap = {gi: li for li, gi in enumerate(g)}
            ctx_g = {
                (gmap[b], e, r): v
                for (b, e, r), v in chain_ctx.items() if b in gmap
            }
            out_g = {}
        fid_a, p_a = verify_pairs(db.lit, corpus_d, starts_d, fid_a, p_a)
        rng_g: List[Tuple[int, int, int, int]] = []
        recs = finish_confirmed(
            db, corpus_d, starts_d, ends_d, fid_a, p_a,
            block_anchored=anch_g,
            block_final=np.zeros(len(g), dtype=bool),
            chain_ctx=ctx_g, chain_out=out_g,
            ranges_out=rng_g,
        )
        for (li, eidx, to_local, frm) in recs:
            deliver(g[li], eidx, to_local, frm)
        for (li, eidx, lo, hi) in rng_g:
            deliver_range(g[li], eidx, lo, hi)
        if out_g:
            for (li, e, r), arr in out_g.items():
                gi = g[li]
                delta = int(g_starts[gi]) - int(starts_d[li])
                if isinstance(arr, tuple) and arr and arr[0] == "imask":
                    chain_out[(gi, e, r)] = (
                        "imask", arr[1],
                        [int(p) + delta for p in arr[2]],
                        int(arr[3]) + delta,
                    )
                else:
                    chain_out[(gi, e, r)] = (
                        np.asarray(arr, dtype=np.int64) + delta
                    )


def scan_streams(
    db: Database,
    streams: Sequence[Stream],
    chunks: Sequence[bytes],
    callbacks: Optional[Sequence[Optional[Callable]]] = None,
    mesh=None,
    threads: int = 1,
    device=None,
) -> List[List[Match]]:
    """Batched stream write: all streams' extents are filtered in one
    device dispatch. `device` is where the write scans: the streams'
    device when None (streams on several devices raise InvalidError).
    With `mesh` (a `parallel.Mesh`), streams shard data-parallel across
    its devices (per-stream state stays sequential), and the rest of the
    write runs on the mesh's first device. `threads > 1` partitions the
    streams across host threads (the hsbench `-T` analogue; streams are
    independent, one scratch per thread in the reference model); each
    thread makes the card current before it launches."""
    B = len(streams)
    if B != len(chunks):
        raise InvalidError("streams/chunks length mismatch")
    device = _write_device(streams, device)
    if mesh is not None:
        device = mesh_device(mesh, device)
    if threads > 1 and mesh is not None:
        raise InvalidError(
            "threads and mesh are exclusive: a mesh already partitions "
            "the streams across chips (one dispatching host thread); "
            "use threads only for host-path writes")
    if threads > 1 and mesh is None and B > 1:
        from concurrent.futures import ThreadPoolExecutor

        from ..parallel.sharded import _on

        cbs = callbacks or [None] * B
        groups = [list(range(g, B, threads)) for g in range(threads)]
        groups = [g for g in groups if g]
        out: List[Optional[List[Match]]] = [None] * B

        def run(g):
            with _on(device):
                return g, scan_streams(
                    db, [streams[i] for i in g], [chunks[i] for i in g],
                    [cbs[i] for i in g], device=device,
                )

        with ThreadPoolExecutor(max_workers=len(groups)) as ex:
            for g, ms_g in ex.map(run, groups):
                for i, ms in zip(g, ms_g):
                    out[i] = ms
        return out  # type: ignore[return-value]
    for st in streams:
        if st.closed:
            raise InvalidError("stream is closed")
        if st.db is not db:
            raise InvalidError("stream belongs to a different database")
    callbacks = callbacks or [None] * B

    recs_abs: List[Set[Tuple[int, int]]] = [set() for _ in range(B)]
    # vacuous reports as lazy (eid, lo_to, hi_to) ranges
    ranges_abs: List[List[Tuple[int, int, int]]] = [[] for _ in range(B)]
    chunks = [bytes(c) for c in chunks]

    # literal path over history+chunk extents
    if db.lit is not None:
        exts = [st.history + c for (st, c) in zip(streams, chunks)]
        # anchored context applies iff the extent begins at stream offset 0
        anchored = np.asarray(
            [st.offset - len(st.history) == 0 for st in streams]
        )
        # chain role state: carried prefix-end evidence per (stream, chain)
        chain_ctx = {}
        chain_out = {}
        has_chains = bool(db.lit.chains)
        if has_chains:
            from .lit_runtime import LEAD_BOUNDARY, chain_ctx_record

            for bi, st in enumerate(streams):
                base_abs = st.offset - len(st.history)
                for (eidx, r), (c_ends, c_run) in st.chain_state.items():
                    # carry ALL live evidence: in-extent ends whose factor
                    # bytes were trimmed out of history are not
                    # re-derivable by the rescan (lit_runtime merges and
                    # dedupes them against re-derived ends). The lead
                    # boundary carries its run even with no ends.
                    if c_ends or r == LEAD_BOUNDARY:
                        chain_ctx[(bi, eidx, r)] = chain_ctx_record(
                            db.lit, eidx, r, c_ends, c_run, base_abs)

        def deliver(bi, eidx, to_local, frm):
            st = streams[bi]
            base = st.offset - len(st.history)
            to_abs = base + to_local
            # history rescan duplicates: anything ending at or before the
            # previous write boundary was reported then
            if to_abs > st.offset or (
                to_abs == st.offset and (eidx, to_abs) not in st.recent
            ):
                recs_abs[bi].add((eidx, to_abs, base + frm))

        def deliver_range(bi, eidx, lo_local, hi_local):
            st = streams[bi]
            base = st.offset - len(st.history)
            # offsets <= the previous boundary were reported by earlier
            # writes (the trail run was alive in their extents too)
            lo_abs = max(base + lo_local, st.offset + 1)
            hi_abs = base + hi_local
            if hi_abs >= lo_abs:
                ranges_abs[bi].append((eidx, lo_abs, hi_abs))

        total_ext = sum(len(e) for e in exts)
        if mesh is not None and total_ext > 1 << 16:
            _scan_streams_sharded(
                db, exts, anchored, mesh, chain_ctx, chain_out,
                has_chains, deliver, deliver_range,
            )
        else:
            lens = np.asarray([len(e) for e in exts], dtype=np.int64)
            starts = np.zeros(B, dtype=np.int64)
            if B > 1:
                np.cumsum(lens[:-1], out=starts[1:])
            ends = starts + lens
            corpus = (
                np.concatenate([np.frombuffer(e, np.uint8) for e in exts])
                if int(lens.sum())
                else np.zeros(0, np.uint8)
            )
            from .lit_runtime import scan_literal_path

            # bounded rebuild region: only candidates whose windows can
            # produce NEW offsets need (re)filtering (reference:
            # delay-rebuild, src/rose/stream.c:415)
            filter_from = starts + np.asarray(
                [len(st.history) for st in streams], dtype=np.int64
            )
            rng: List[Tuple[int, int, int, int]] = []
            for (bi, eidx, to_local, frm) in scan_literal_path(
                db, corpus, starts, ends,
                block_anchored=anchored, block_final=np.zeros(B, bool),
                chain_ctx=chain_ctx if has_chains else None,
                chain_out=chain_out if has_chains else None,
                ranges_out=rng,
                filter_from=filter_from,
                device=device,
            ):
                deliver(bi, eidx, to_local, frm)
            for (bi, eidx, lo, hi) in rng:
                deliver_range(bi, eidx, lo, hi)

        if has_chains:
            starts_for_update = np.zeros(B, dtype=np.int64)
            lens_u = np.asarray([len(e) for e in exts], dtype=np.int64)
            if B > 1:
                np.cumsum(lens_u[:-1], out=starts_for_update[1:])
            _update_chain_state(db, streams, exts, starts_for_update,
                                chain_out)

    _engine_pass(db, streams, chunks, recs_abs, ranges_abs, device)

    out: List[List[Match]] = []
    hist_req = history_required(db)
    risk = db.som_eod_eids()
    for bi, st in enumerate(streams):
        new_off = st.offset + len(chunks[bi])
        # previously deferred boundary reports: the boundary is now
        # interior (or unchanged on a zero-length write — re-defer below)
        recs_bi = recs_abs[bi] | st.pending
        rngs_bi = ranges_abs[bi]
        new_pending: Set[Tuple[int, int, int]] = set()
        if risk:
            new_pending = {(e, t, f) for (e, t, f) in recs_bi
                           if t == new_off and e in risk}
            recs_bi = recs_bi - new_pending
            if rngs_bi and any(e in risk and hi == new_off
                               for (e, _lo, hi) in rngs_bi):
                clipped = []
                for (eid, lo, hi) in rngs_bi:
                    if eid in risk and hi == new_off:
                        # empty match at the boundary: frm == to
                        new_pending.add((eid, new_off, new_off))
                        hi -= 1
                    if hi >= lo:
                        clipped.append((eid, lo, hi))
                rngs_bi = clipped
        if st.terminated or (not recs_bi and not rngs_bi):
            # nothing matched in this write — or the stream was
            # terminated by an earlier callback (no further delivery;
            # offsets/history still advance so the batch stays aligned)
            ms, terminated = [], False
        else:
            from .scan import RecordSink

            sink = RecordSink()
            sink.single = recs_bi
            for (eid, lo, hi) in rngs_bi:
                sink.add_range(eid, lo, hi)
            ms, terminated = finalize_reports(
                db, sink.materialize(None, db.som_eids()), callbacks[bi],
                seen_single=st.seen_single,
                combo_matched=st.combo_matched, at_end=False,
                som_horizon=som_horizon_span(db.mode),
            )
        st.terminated = st.terminated or terminated
        st.pending = new_pending
        # preserve prior boundary dedupe entries when the boundary does
        # not advance (zero-length write), else they are re-reported by
        # the next history rescan (deferred records count: their rescan
        # duplicates must not deliver either)
        st.recent = {(e, t) for (e, t, _f) in recs_abs[bi]
                     if t >= new_off} | {
            (e, t) for (e, t, _f) in new_pending} | {
            (e, t) for (e, t) in st.recent if t >= new_off} | {
            (eid, t) for (eid, lo, hi) in ranges_abs[bi]
            for t in range(max(lo, new_off), hi + 1)}
        ext = st.history + chunks[bi]
        st.history = ext[-hist_req:] if hist_req else b""
        st.offset = new_off
        out.append(ms)
    return out


def _write_device(streams, device) -> torch.device:
    """The device of a write over `streams`: theirs, which must be one."""
    devs = {st.device for st in streams}
    if device is not None:
        devs.add(stream_device(device))
    if len(devs) > 1:
        raise InvalidError(
            "streams on different devices: "
            + ", ".join(sorted(str(d) for d in devs)))
    return devs.pop() if devs else stream_device("cuda")


def scan_stream(
    stream: Stream, data: bytes,
    callback: Optional[Callable] = None,
) -> List[Match]:
    """reference: hs_scan_stream (src/runtime.c:980)."""
    if stream.terminated:
        raise ScanTerminated("stream was terminated by callback")
    return scan_streams(stream.db, [stream], [data], [callback])[0]


def _order_abs(recs) -> List[Tuple[int, int, int]]:
    """Min-merge SOM starts per (expr, to) and order by absolute offset."""
    best = {}
    for (e, t, frm) in recs:
        k = (t, e)
        if k not in best or frm < best[k]:
            best[k] = frm
    return [(e, t, best[(t, e)]) for (t, e) in sorted(best)]


def _eod_pass(stream: Stream) -> List[Tuple[int, int, int]]:
    """Collect EOD-only records at stream end (reference:
    report_eod_matches, src/runtime.c:632)."""
    db = stream.db
    recs: Set[Tuple[int, int, int]] = set()
    n = stream.offset
    # general engines: final-state EOD accepts + vacuous EOD reports
    from ..database import SomEngine

    for ei, engine in enumerate(db.engines):
        if isinstance(engine, SomEngine):
            for (eidx, adj, frm) in engine.eod_reports(
                stream.engine_states[ei]
            ):
                if n + adj >= 0:
                    recs.add((eidx, n + adj, frm))
            sid = 0
        else:
            sid = engine.eod_set(stream.engine_states[ei])
        if sid:
            for (eidx, adj) in engine.expand_set(sid):
                if n + adj >= 0:
                    recs.add((eidx, n + adj, 0))
        for (anchored, eod, adj, eid) in engine.start_reports:
            if not eod:
                continue
            if anchored:
                if n == 0 and adj >= 0:
                    recs.add((eid, adj, adj))  # empty match: frm == to
            elif n + adj >= 0:
                recs.add((eid, n + adj, n + adj))
    # literal path: rescan history with EOD semantics, keep only EOD records
    if db.lit is not None and stream.history:
        hist = np.frombuffer(stream.history, np.uint8)
        starts = np.zeros(1, np.int64)
        ends = np.asarray([len(hist)], np.int64)
        anchored = np.asarray([stream.offset == len(stream.history)])
        final = np.ones(1, dtype=bool)
        from .lit_runtime import scan_literal_path

        base = stream.offset - len(stream.history)
        for (_bi, eidx, to_local, frm) in scan_literal_path(
            db, hist, starts, ends,
            block_anchored=anchored, block_final=final,
            eod_only=True, device=stream.device,
        ):
            recs.add((eidx, base + to_local, base + frm))
    # an (id, to) already reported at the final write boundary must not
    # re-report at close with a different (e.g. empty-match) start: a
    # match is delivered once per (id, to) — the block path's min-merge
    # sees both records in one materialize; the stream path suppresses
    # the later one (found by the SOM-stream fuzzer: `...9*$`-style
    # nullable EOD branches). DEFERRED boundary reports of EOD-capable
    # SOM patterns were never delivered: they merge here so the EOD
    # matches' (possibly earlier) leftmost starts win, exactly like the
    # block min-merge.
    pend_keys = {(e, t) for (e, t, _f) in stream.pending}
    recs |= set(stream.pending)
    suppressed = stream.recent - pend_keys
    recs = {r for r in recs if (r[0], r[1]) not in suppressed}
    return _order_abs(recs)


def close_stream(
    stream: Stream, callback: Optional[Callable] = None
) -> List[Match]:
    """reference: hs_close_stream (src/runtime.c:999). Returns (and
    delivers, if a callback is given) the matches at end-of-data."""
    if stream.closed:
        raise InvalidError("stream already closed")
    ms: List[Match] = []
    if not stream.terminated:
        ms, _t = finalize_reports(
            stream.db, _eod_pass(stream), callback,
            seen_single=stream.seen_single,
            combo_matched=stream.combo_matched,
            at_end=True, end_offset=stream.offset,
            som_horizon=som_horizon_span(stream.db.mode),
        )
    stream.closed = True
    return ms


def reset_stream(
    stream: Stream, callback: Optional[Callable] = None
) -> List[Match]:
    """reference: hs_reset_stream (src/runtime.c:1028): report EOD matches
    (if a callback is supplied), then reinitialize for reuse."""
    ms: List[Match] = []
    if callback is not None and not stream.terminated:
        ms, _t = finalize_reports(
            stream.db, _eod_pass(stream), callback,
            seen_single=stream.seen_single,
            combo_matched=stream.combo_matched,
            at_end=True, end_offset=stream.offset,
            som_horizon=som_horizon_span(stream.db.mode),
        )
    stream.offset = 0
    stream.history = b""
    stream.terminated = False
    stream.closed = False
    stream.seen_single = set()
    stream.combo_matched = set()
    stream.recent = set()
    stream.chain_state = {}
    stream.pending = set()
    stream._init_states()
    return ms


# --- state codec (reference: hs_compress_stream / hs_expand_stream) ---------


def compress_stream(stream: Stream) -> bytes:
    """Pack the stream state into a portable buffer (reference:
    hs_compress_stream, src/runtime.c:1177)."""
    parts = [STREAM_MAGIC]
    parts.append(
        struct.pack(
            "<QIBBI",
            stream.offset,
            len(stream.history),
            1 if stream.terminated else 0,
            1 if stream.closed else 0,
            len(stream.engine_states),
        )
    )
    parts.append(stream.history)
    for st_v in stream.engine_states:
        # length-prefixed per-engine state blob (reference:
        # nfaQueueCompressState variable-size state blocks). SOM engines
        # pack (mask, som registers); others pack a bare int
        if isinstance(st_v, tuple):
            mask, soms = st_v
            mask = int(mask)
            nb = max(1, (mask.bit_length() + 7) // 8)
            blob = struct.pack("<BH", 1, nb) + mask.to_bytes(nb, "little")
            blob += struct.pack("<H", len(soms))
            blob += struct.pack(f"<{len(soms)}q", *soms)
        else:
            s_i = int(st_v)
            nb = max(1, (s_i.bit_length() + 7) // 8)
            blob = struct.pack("<BH", 0, nb) + s_i.to_bytes(nb, "little")
        parts.append(struct.pack("<I", len(blob)))
        parts.append(blob)
    ss = sorted(stream.seen_single)
    parts.append(struct.pack("<I", len(ss)))
    parts.append(struct.pack(f"<{len(ss)}i", *ss))
    cm = sorted(stream.combo_matched)
    parts.append(struct.pack("<I", len(cm)))
    parts.append(struct.pack(f"<{len(cm)}i", *cm))
    rr = sorted(stream.recent)
    parts.append(struct.pack("<I", len(rr)))
    for (e, t) in rr:
        parts.append(struct.pack("<iq", e, t))
    cs = sorted(stream.chain_state.items())
    parts.append(struct.pack("<I", len(cs)))
    for ((eidx, role), (ends, run_start)) in cs:
        parts.append(struct.pack("<iiqI", eidx, role, run_start, len(ends)))
        if ends:
            # head entry length-prefixed: for general-infix boundaries
            # it is the carried NFA mask, an arbitrary-width Python int
            # (multi-word infixes exceed int64); the rest are offsets
            h = int(ends[0])
            nb = max(1, (h.bit_length() + 7) // 8)
            parts.append(struct.pack("<H", nb))
            parts.append(h.to_bytes(nb, "little"))
            parts.append(struct.pack(f"<{len(ends) - 1}q", *ends[1:]))
    pd = sorted(stream.pending)
    parts.append(struct.pack("<I", len(pd)))
    for (e, t, frm) in pd:
        parts.append(struct.pack("<iqq", e, t, frm))
    return b"".join(parts)


def expand_stream(db: Database, buf: bytes, device="cuda") -> Stream:
    """reference: hs_expand_stream (src/runtime.c:1204). The new stream
    scans on `device`."""
    s = open_stream(db, device)
    _expand_into(s, buf)
    return s


def reset_and_expand_stream(
    stream: Stream, buf: bytes, callback: Optional[Callable] = None
) -> List[Match]:
    """Atomically reset `stream` and load compressed state into it —
    the documented high-rate stream-reuse path (reference:
    hs_reset_and_expand_stream, src/hs_runtime.h:438, src/runtime.c:1230).
    If a callback is given, the stream's CURRENT state first reports its
    end-of-data matches (exactly hs_reset_stream's contract); then the
    decompressed state from `buf` replaces it in place. Returns the EOD
    matches (empty without a callback, matching the reference, which
    skips EOD work when onEvent is NULL)."""
    ms: List[Match] = []
    if callback is not None and not stream.terminated:
        ms, _t = finalize_reports(
            stream.db, _eod_pass(stream), callback,
            seen_single=stream.seen_single,
            combo_matched=stream.combo_matched,
            at_end=True, end_offset=stream.offset,
            som_horizon=som_horizon_span(stream.db.mode),
        )
    _expand_into(stream, buf)
    return ms


def reset_and_copy_stream(
    to: Stream, src: Stream, callback: Optional[Callable] = None
) -> List[Match]:
    """Atomically reset `to` and duplicate `src`'s state onto it
    (reference: hs_reset_and_copy_stream, src/hs_runtime.h:462,
    src/runtime.c:1108): `to`'s CURRENT state first reports its
    end-of-data matches when a callback is supplied, then `src`'s scan
    state replaces it in place. Both streams must come from the same
    database; `to` keeps its device. Returns the EOD matches."""
    if to.db is not src.db:
        raise InvalidError("streams belong to different databases")
    ms = reset_stream(to, callback)
    to.offset = src.offset
    to.history = (src.history if isinstance(src.history, bytes)
                  else bytes(src.history))
    to.terminated = src.terminated
    to.closed = src.closed
    to.engine_states = list(src.engine_states)
    to.seen_single = set(src.seen_single)
    to.combo_matched = set(src.combo_matched)
    to.recent = set(src.recent)
    to.chain_state = {k: (list(v[0]), v[1])
                      for k, v in src.chain_state.items()}
    to.pending = set(src.pending)
    return ms


def _expand_into(s: Stream, buf: bytes) -> None:
    """Decode a compress_stream buffer into an existing Stream object."""
    db = s.db
    if buf[:8] != STREAM_MAGIC:
        raise InvalidError("bad stream state magic")
    off = 8
    offset, hlen, term, closed, ne = struct.unpack_from("<QIBBI", buf, off)
    off += struct.calcsize("<QIBBI")
    history = buf[off : off + hlen]
    off += hlen
    states = []
    for _ in range(ne):
        (blen,) = struct.unpack_from("<I", buf, off)
        off += 4
        blob = buf[off : off + blen]
        off += blen
        kind, nb = struct.unpack_from("<BH", blob, 0)
        mask = int.from_bytes(blob[3 : 3 + nb], "little")
        if kind == 1:
            (nsom,) = struct.unpack_from("<H", blob, 3 + nb)
            soms = struct.unpack_from(f"<{nsom}q", blob, 5 + nb)
            states.append((mask, tuple(soms)))
        else:
            states.append(mask)
    (nss,) = struct.unpack_from("<I", buf, off)
    off += 4
    seen = set(struct.unpack_from(f"<{nss}i", buf, off))
    off += 4 * nss
    (ncm,) = struct.unpack_from("<I", buf, off)
    off += 4
    cmatched = set(struct.unpack_from(f"<{ncm}i", buf, off))
    off += 4 * ncm
    (nrr,) = struct.unpack_from("<I", buf, off)
    off += 4
    recent = set()
    for _ in range(nrr):
        e, t = struct.unpack_from("<iq", buf, off)
        off += struct.calcsize("<iq")
        recent.add((e, t))
    (ncs,) = struct.unpack_from("<I", buf, off)
    off += 4
    chain_state = {}
    for _ in range(ncs):
        ceidx, role, run_start, n_ends = struct.unpack_from("<iiqI", buf, off)
        off += struct.calcsize("<iiqI")
        c_ends = []
        if n_ends:
            (nb,) = struct.unpack_from("<H", buf, off)
            off += 2
            c_ends.append(int.from_bytes(buf[off : off + nb], "little"))
            off += nb
            c_ends += list(struct.unpack_from(f"<{n_ends - 1}q", buf, off))
            off += 8 * (n_ends - 1)
        chain_state[(ceidx, role)] = (c_ends, run_start)
    (npd,) = struct.unpack_from("<I", buf, off)
    off += 4
    pending = set()
    for _ in range(npd):
        e, t, frm = struct.unpack_from("<iqq", buf, off)
        off += struct.calcsize("<iqq")
        pending.add((e, t, frm))
    if ne != len(db.engines):
        raise InvalidError("stream state does not match database")
    s.offset = offset
    s.history = history
    s.terminated = bool(term)
    s.closed = bool(closed)
    s.engine_states = states
    s.seen_single = seen
    s.combo_matched = cmatched
    s.recent = recent
    s.chain_state = chain_state
    s.pending = pending


# --- vectored mode (reference: hs_scan_vector, src/runtime.c:1106) ----------


def scan_vector(
    db: Database,
    buffers: Sequence[bytes],
    callback: Optional[Callable] = None,
    device="cuda",
) -> List[Match]:
    """Vectored scan = one synthetic stream over a gather list; offsets are
    absolute in the concatenation (reference: src/runtime.c:1106-1175).
    Runs on `device`: the card unless the caller passes another."""
    if base_mode(db.mode) != HS_MODE_VECTORED:
        raise DbModeError("database not compiled for vectored mode")
    s = Stream(db=db, device=stream_device(device))
    s._init_states()
    out: List[Match] = []
    terminated = False
    for buf in buffers:
        if terminated:
            break
        ms = scan_streams(db, [s], [buf], [callback])[0]
        out.extend(ms)
        terminated = s.terminated
    if not terminated:
        out.extend(close_stream(s, callback))
    else:
        s.closed = True
    return out
