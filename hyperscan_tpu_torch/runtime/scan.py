"""Block-mode scan runtime.

Reference analogue: src/runtime.c hs_scan → roseBlockExec. The literal
pipeline filters and hash-confirms the (batched, concatenated) data on the
torch device, and report processing finishes on host: accept-set
expansion, offset adjusts, ext-param bounds, dedupe, ordering, SINGLEMATCH/QUIET handling, and callback delivery
(reference: src/rose/match.c + src/util/report.h semantics).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from ..database import Database, DfaEngine
from ..errors import DbModeError, InvalidError, ScratchInUseError
from ..flags import (
    HS_FLAG_QUIET,
    HS_FLAG_SINGLEMATCH,
    HS_FLAG_SOM_LEFTMOST,
    HS_MODE_BLOCK,
    HS_OFFSET_PAST_HORIZON,
    UNBOUNDED,
    base_mode,
)
from ..trace import span, spanned

Match = Tuple[int, int, int]  # (external id, from, to)



@dataclasses.dataclass
class RecordBatch:
    """Columnar match records — (expr_index, to, from) as parallel
    arrays, sorted by (to, expr) and deduped, plus unexpanded per-offset
    ranges (vacuous reports: every `to` in [lo, hi] with frm 0, disjoint
    from the arrays). The vectorized analogue of the reference's
    per-callback record flow: dense-match patterns (`x*` over megabytes)
    stay in numpy/range form end to end instead of costing ~10us of
    Python per report."""

    eids: np.ndarray  # int64
    tos: np.ndarray  # int64
    frms: np.ndarray  # int64
    ranges: List[Tuple[int, int, int]] = dataclasses.field(
        default_factory=list
    )  # (eid, lo_to, hi_to), sorted by lo_to, frm=0

    def __len__(self) -> int:
        return int(self.eids.shape[0]) + sum(
            hi - lo + 1 for (_e, lo, hi) in self.ranges
        )

    def expand(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Merge ranges into the arrays, keeping (to, eid) order."""
        if not self.ranges:
            return self.eids, self.tos, self.frms
        es = [self.eids]
        ts = [self.tos]
        fs = [self.frms]
        for (eid, lo, hi) in self.ranges:
            t = np.arange(lo, hi + 1, dtype=np.int64)
            es.append(np.full_like(t, eid))
            ts.append(t)
            fs.append(np.zeros_like(t))
        eids = np.concatenate(es)
        tos = np.concatenate(ts)
        frms = np.concatenate(fs)
        order = np.lexsort((eids, tos))
        return eids[order], tos[order], frms[order]

    def tuples(self) -> List[Tuple[int, int, int]]:
        eids, tos, frms = self.expand()
        return list(zip(eids.tolist(), tos.tolist(), frms.tolist()))


class RecordSink:
    """Accumulates match records from the engine passes in three forms:
    Python singles, numpy batches, and lazy per-offset ranges (vacuous
    reports — the reference's boundary-program empty matches, which are
    O(n) events but O(1) information)."""

    def __init__(self) -> None:
        self.single: set = set()
        self.batches: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        self.ranges: List[Tuple[int, int, int]] = []  # (eid, lo_to, hi_to)

    def add(self, eid: int, to: int, frm: int = 0) -> None:
        self.single.add((eid, to, frm))

    def add_batch(self, eids, tos, frms=None) -> None:
        tos = np.asarray(tos, dtype=np.int64)
        if tos.size == 0:
            return
        eids = np.broadcast_to(
            np.asarray(eids, dtype=np.int64), tos.shape
        )
        frms = (
            np.zeros_like(tos)
            if frms is None
            else np.broadcast_to(np.asarray(frms, dtype=np.int64), tos.shape)
        )
        self.batches.append((eids, tos, frms))

    def add_range(self, eid: int, lo: int, hi: int) -> None:
        """Report (eid, to, 0) for every to in [lo, hi]."""
        if hi >= lo:
            self.ranges.append((int(eid), int(lo), int(hi)))

    def materialize(self, n: Optional[int],
                    som_eids: frozenset = frozenset()) -> RecordBatch:
        """Bounds-check (0 <= to <= n when n is given), min-merge SOM
        starts per (to, eid), and sort by offset. Ranges of non-SOM
        patterns stay unexpanded: they dominate any array record at the
        same (to, eid) (their frm is 0, the minimum), so covered array
        records are dropped. SOM patterns' ranges expand here with
        frm == to (an empty match starts where it ends) so the min-merge
        can prefer real matches' leftmost starts."""
        if not self.batches and not self.ranges and len(self.single) <= 16:
            # scalar fast path: a handful of point records (the common
            # streaming-write case) — the numpy pipeline below has ~20
            # fixed-cost array ops that dominate tiny batches. Sorting
            # by (to, eid, frm) and keeping the first (to, eid) is the
            # same min-merge + offset order as the lexsort path.
            rows = []
            last = None
            for (t, e, f) in sorted((t, e, f) for (e, t, f) in self.single):
                if t < 0 or (n is not None and t > n):
                    continue
                if (t, e) != last:
                    rows.append((e, t, f))
                    last = (t, e)
            if not rows:
                z = np.zeros(0, dtype=np.int64)
                return RecordBatch(z, z, z, [])
            arr = np.asarray(rows, dtype=np.int64)
            return RecordBatch(arr[:, 0], arr[:, 1], arr[:, 2], [])
        es: List[np.ndarray] = []
        ts: List[np.ndarray] = []
        fs: List[np.ndarray] = []
        if self.single:
            arr = np.asarray(sorted(self.single), dtype=np.int64)
            es.append(arr[:, 0])
            ts.append(arr[:, 1])
            fs.append(arr[:, 2])
        for (e, t, f) in self.batches:
            es.append(e)
            ts.append(t)
            fs.append(f)
        ranges: List[Tuple[int, int, int]] = []
        for (eid, lo, hi) in self.ranges:
            lo = max(lo, 0)
            if n is not None:
                hi = min(hi, n)
            if hi < lo:
                continue
            if eid in som_eids:
                t = np.arange(lo, hi + 1, dtype=np.int64)
                es.append(np.full_like(t, eid))
                ts.append(t)
                fs.append(t.copy())  # empty match: from == to
            else:
                ranges.append((eid, lo, hi))
        # merge overlapping/adjacent same-pattern ranges (run ends and
        # vacuous reports can cover the same intervals)
        ranges.sort()
        merged_r: List[List[int]] = []
        for (eid, lo, hi) in ranges:
            if merged_r and merged_r[-1][0] == eid \
                    and lo <= merged_r[-1][2] + 1:
                if hi > merged_r[-1][2]:
                    merged_r[-1][2] = hi
            else:
                merged_r.append([eid, lo, hi])
        ranges = [(e, lo, hi) for (e, lo, hi) in merged_r]
        ranges.sort(key=lambda r: r[1])
        if not ts:
            z = np.zeros(0, dtype=np.int64)
            return RecordBatch(z, z, z, ranges)
        eids = np.concatenate(es)
        tos = np.concatenate(ts)
        frms = np.concatenate(fs)
        ok = tos >= 0
        if n is not None:
            ok &= tos <= n
        for (eid, lo, hi) in ranges:
            ok &= ~((eids == eid) & (tos >= lo) & (tos <= hi))
        eids, tos, frms = eids[ok], tos[ok], frms[ok]
        order = np.lexsort((frms, eids, tos))
        eids, tos, frms = eids[order], tos[order], frms[order]
        if len(tos):
            first = np.ones(len(tos), dtype=bool)
            first[1:] = (tos[1:] != tos[:-1]) | (eids[1:] != eids[:-1])
            eids, tos, frms = eids[first], tos[first], frms[first]
        return RecordBatch(eids, tos, frms, ranges)


@dataclasses.dataclass
class Scratch:
    """Per-thread scan workspace (reference: src/scratch.c hs_scratch).

    Holds the match-buffer capacity and marks in-use for reentrancy
    detection. The device wrappers allocate their own buffers, so the
    scratch's main job is capacity policy + the in-use guard.
    """

    capacity: int = 4096
    in_use: bool = False

    def clone(self) -> "Scratch":
        return Scratch(capacity=self.capacity)


def resolve_device(device) -> "torch.device":
    """The torch device a scan runs on. A CUDA device must exist: a scan
    asked to run on the card raises where there is none, and never falls
    back to the CPU."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "scan asked for device %r but torch.cuda.is_available() is "
            "False; pass device='cpu' to scan on the CPU" % (str(dev),))
    return dev


def mesh_device(mesh, device) -> "torch.device":
    """The device a scan with `mesh` runs its unsharded half on: this
    process's first device of the mesh (on a mesh of several processes,
    each runs the unsharded half on its own card). An explicit `device`
    other than that one raises."""
    import torch

    from ..parallel.sharded import _as_shard_mesh

    first = _as_shard_mesh(mesh).first
    if device is not None:
        dev = torch.device(device)
        if dev.type != first.type or (
                None not in (dev.index, first.index)
                and dev.index != first.index):
            raise InvalidError(
                f"device {str(dev)!r} differs from the mesh's first device "
                f"{str(first)!r}: with a mesh, leave device unset")
    return first


def scan_blocks_raw(
    db: Database, blocks: Sequence[bytes], capacity: int, mesh=None,
    device=None,
) -> List[RecordBatch]:
    """Scan a batch of independent blocks; returns per-block RecordBatch
    of internal (expr_index, to, from) records (pre report-processing),
    deduped and sorted. Capacity overflow retries happen inside the
    device kernel wrappers (ops.teddy_families.confirm_finish, the engine
    scans of ops.dfa_kernel and ops.nfa_kernel).

    Above the database's `host_scan_limit` the blocks are concatenated
    into one flat corpus, uploaded once to the torch `device` (the card
    when None), and both the literal pipeline and the general engines
    scan that tensor; below it everything runs on the host.

    With `mesh` (parallel.sharded.Mesh), a literal database over more
    than 64 KiB of blocks shards its literal pipeline across the mesh
    (`sharded_literal_scan`): each shard's blocks are uploaded to its
    device and confirmed there, and the host stages (`verify_pairs`,
    `finish_confirmed`) run per shard, with shard-local block indices;
    everything else runs on the mesh's first device (`mesh_device`), and
    the engines then scan without literal prefilter gating (reference:
    hyperscan_tpu/runtime/scan.py:246-266). On a mesh of several
    processes every process is handed the same global batch and returns
    every block's records, but computes only its own shards' part of the
    literal path: it flattens, uploads, confirms and runs the host stages
    of its own shards' blocks alone (the whole batch is flattened only
    for the engines, where the database has any), and only the shards'
    finished records and ranges cross the group. Report finalization
    (`scan_batch`) stays on every process."""
    if mesh is not None:
        device = mesh_device(mesh, device)
    elif device is None:
        device = "cuda"
    B = len(blocks)
    per_block: List[RecordSink] = [RecordSink() for _ in range(B)]
    from ..ops.teddy import corpus_tensor, flatten_blocks
    from .smallwrite import HOST_SCAN_LIMIT

    n = sum(map(len, blocks))
    sharded = db.lit is not None and mesh is not None and n > 1 << 16
    on_device = n > getattr(db, "host_scan_limit", HOST_SCAN_LIMIT)
    # a process of a mesh of several processes flattens only its own
    # shards' blocks (`sharded_literal_scan`), unless engines scan them all
    flat = corpus = starts = lens = None
    if not (sharded and mesh.distributed and not db.engines):
        flat = corpus, starts, lens = flatten_blocks(blocks)
    corpus_t = (corpus_tensor(corpus, device)
                if on_device and (db.engines or not sharded) else None)

    # literal path: Teddy filter over the concatenated corpus, then
    # confirm + window validation (reference: Rose floating literal
    # matcher path, src/rose/block.c roseBlockFloating)
    if sharded:
        from ..parallel.sharded import sharded_literal_scan

        recs, rng = sharded_literal_scan(db, blocks, mesh, capacity,
                                         flat=flat)
        for (bi, eidx, to, frm) in recs.tolist():
            per_block[bi].add(eidx, to, frm)
        for (bi, eidx, lo, hi) in rng.tolist():
            per_block[bi].add_range(eidx, lo, hi)
    # engine prefilter hits: None when the literal half did not collect
    # them (sharded), and the engines then scan every block
    prefilter_hits: Optional[dict] = None
    if db.lit is not None and not sharded:
        from .lit_runtime import scan_literal_path

        prefilter_hits = {}
        rng = []
        for (bi, eidx, to, frm) in scan_literal_path(
            db, corpus, starts, starts + lens,
            capacity=max(capacity, 1 << 14), ranges_out=rng,
            prefilter_out=prefilter_hits, device=device, corpus_t=corpus_t,
        ):
            per_block[bi].add(eidx, to, frm)
        for (bi, eidx, lo, hi) in rng:
            per_block[bi].add_range(eidx, lo, hi)

    if db.engines and not on_device:
        # small-write path (reference: runSmallWriteEngine): host numpy
        _host_engine_scan(db.engines, blocks, per_block)
    elif db.engines:
        _device_engine_scan(db, blocks, corpus, corpus_t, starts, lens,
                            capacity, prefilter_hits, per_block)
    return [per_block[bi].materialize(len(blocks[bi]), db.som_eids())
            for bi in range(B)]


def _device_engine_scan(db, blocks, corpus, corpus_t, starts, lens,
                        capacity, prefilter_hits, per_block) -> None:
    """The engine half of a device block scan (reference:
    hyperscan_tpu/runtime/scan.py:297-434): bounded DFAs take the
    chunk-halo scan, unbounded DFAs the speculative one, acyclic bit-NFAs
    the layered sweep and cyclic ones with a lazy-DFA core the
    speculative NFA scan, all over the uploaded corpus `corpus_t`; SOM,
    LBR and other NFA engines scan on the host. An engine whose every
    expression is literal-prefilter gated scans only the blocks where
    one of its mandatory factors hit (`prefilter_hits`; None when the
    literal half did not collect them, and then every block)."""
    from ..database import MAX_HALO_DEPTH, LbrEngine, NfaEngine, SomEngine
    from ..ops import dfa_kernel as DK
    from ..ops.nfa_kernel import nfa_device_eligible, nfa_scan_corpus
    from .smallwrite import HOST_SCAN_LIMIT

    B = len(blocks)
    limit = getattr(db, "host_scan_limit", HOST_SCAN_LIMIT)
    pre_eids = (_lit_prefilter_eids(db.lit)
                if db.lit is not None and prefilter_hits is not None
                else frozenset())
    host_engines = []  # (engine, sel)

    def _engine_sel(engine) -> np.ndarray:
        """Block indices this engine must scan: all, unless EVERY
        expression it reports is literal-prefilter gated ("pre" refs) —
        then only blocks where some mandatory factor hit. Block mode
        only (streaming keeps engines hot across writes); false factor
        hits over-approximate, never under (reference: the Rose literal
        cut feeding arbitrary engines, ng_violet.cpp:3053)."""
        es = engine.eids() if hasattr(engine, "eids") else None
        if (not pre_eids or not es or engine.start_reports
                or not es <= pre_eids):
            return np.arange(B, dtype=np.int64)
        act = sorted(set().union(
            *(prefilter_hits.get(e, set()) for e in es)))
        return np.asarray(act, dtype=np.int64)

    def _eod(engine, set_id_of, finals_or_bits, len_sub, pb_sub) -> None:
        for bi in range(len(pb_sub)):
            sid = set_id_of(finals_or_bits[bi])
            if sid:
                for (eid, adj) in engine.expand_set(sid):
                    pb_sub[bi].add(eid, int(len_sub[bi]) + adj)

    for engine in db.engines:
        if isinstance(engine, (SomEngine, LbrEngine)):
            host_engines.append((engine, np.arange(B, dtype=np.int64)))
            continue
        sel = _engine_sel(engine)
        if not len(sel):
            continue
        pb_sub = [per_block[j] for j in sel.tolist()]
        st_sub, len_sub = starts[sel], lens[sel]
        anch = np.ones(len(sel), dtype=bool)
        if isinstance(engine, NfaEngine):
            if nfa_device_eligible(engine):
                # acyclic bit-NFA: layered position-parallel device scan
                (bi_a, pos_a, val_a), eod_bits = nfa_scan_corpus(
                    engine, corpus_t, st_sub, len_sub, anch, capacity)
                _expand_device_records(engine, bi_a, pos_a, val_a, pb_sub)
                _eod(engine, int, eod_bits, len_sub, pb_sub)
            elif engine.spec_dfa is not None \
                    and int(len_sub.sum()) > limit:
                # cyclic bit-NFA: speculative device scan over the
                # lazy-DFA core, host rescan of sink/mismatch chunks
                (bi_a, pos_a, aids), host_recs, finals = \
                    DK.nfa_scan_corpus_speculative(
                        engine, corpus, corpus_t, st_sub, len_sub, anch,
                        capacity)
                _expand_device_records(
                    engine.spec_dfa, bi_a, pos_a, aids, pb_sub)
                for (bi, pp, hv) in host_recs:
                    _expand_device_records(
                        engine, np.full(len(pp), bi, np.int64), pp, hv,
                        pb_sub)
                _eod(engine, engine.eod_set, finals, len_sub, pb_sub)
            else:
                host_engines.append((engine, sel))
                continue
        else:
            if engine.max_depth is None \
                    or engine.max_depth > MAX_HALO_DEPTH:
                # unbounded-width engine: speculative chunk-parallel
                # device scan with host entry-state fixup (exact; the
                # worst case decays to the host path it replaces)
                (bi_a, pos_a, sid_a), finals = \
                    DK.dfa_scan_corpus_speculative(
                        engine, corpus, corpus_t, st_sub, len_sub, anch,
                        capacity)
            else:
                # bounded-width engine: exact chunk-halo device scan
                (bi_a, pos_a, sid_a), finals = DK.dfa_scan_corpus(
                    engine, corpus_t, st_sub, len_sub, anch, capacity)
            _expand_device_records(engine, bi_a, pos_a, sid_a, pb_sub)
            _eod(engine, engine.eod_set, finals, len_sub, pb_sub)
        _add_start_reports(engine, pb_sub, len_sub)

    # SOM, LBR and the NFAs without a device route scan on the host
    full = [e for (e, s) in host_engines if len(s) == B]
    if full:
        _host_engine_scan(full, blocks, per_block)
    for (e, s) in host_engines:
        if len(s) < B and len(s):
            sub = s.tolist()
            _host_engine_scan([e], [blocks[j] for j in sub],
                              [per_block[j] for j in sub])


def _lit_prefilter_eids(lit) -> frozenset:
    """Expression indices whose every general-engine branch registered
    mandatory "pre" factors (cached on the lit tables under this
    package's own attribute name)."""
    if "_torch_pre_eids" not in lit.__dict__:
        lit._torch_pre_eids = frozenset(
            e for refs in lit.factor_refs for (e, _a, _b, k) in refs
            if k == "pre")
    return lit._torch_pre_eids


def _expand_device_records(engine, bi_a, pos_a, val_a, per_block) -> None:
    """Vectorized expansion of device accept records: group by accept
    value (set id or set bitmask) and by block, then batch-append the
    expanded (eid, to) columns."""
    if len(pos_a) == 0:
        return
    for val in np.unique(val_a):
        reports = engine.expand_set(int(val))
        if not reports:
            continue
        sel = val_a == val
        bsel, psel = bi_a[sel], pos_a[sel]
        for bi in np.unique(bsel):
            pp = psel[bsel == bi]
            for (eid, adj) in reports:
                per_block[int(bi)].add_batch(eid, pp + 1 + adj)


def engine_scan_host(engine, data, lengths, init_states=None):
    """Dispatch a host batch scan to the engine's runtime (DFA byte loop
    or bit-NFA word loop). Returns (hits per row [(pos, set_id_or_bits)],
    finals) with carried-state semantics."""
    from ..database import NfaEngine, SomEngine

    if isinstance(engine, SomEngine):
        from .nfa_host import som_scan_host

        if init_states is None:
            init_states = [engine.start_state] * data.shape[0]
        base = np.zeros(data.shape[0], dtype=np.int64)
        return som_scan_host(engine, data, lengths, init_states, base)
    if isinstance(engine, NfaEngine):
        from .nfa_host import nfa_scan_host

        if init_states is None:
            init_states = [engine.start_state] * data.shape[0]
        return nfa_scan_host(engine, data, lengths, init_states)
    from .smallwrite import dfa_scan_host

    return dfa_scan_host(engine, data, lengths, init_states)


def _host_engine_scan(engines, blocks, per_block) -> np.ndarray:
    """Scan engines over a block batch with the host runtime, collecting
    accept / EOD / vacuous records into per_block. Returns lengths."""
    B = len(blocks)
    maxlen = max((len(b) for b in blocks), default=0)
    data = np.zeros((B, max(1, maxlen)), dtype=np.uint8)
    lengths = np.zeros((B,), dtype=np.int32)
    for i, blk in enumerate(blocks):
        data[i, : len(blk)] = np.frombuffer(blk, dtype=np.uint8)
        lengths[i] = len(blk)
    from ..database import LbrEngine, SomEngine

    for engine in engines:
        if isinstance(engine, LbrEngine):
            runs, _finals = engine.scan_runs(
                data, lengths, [0] * B
            )
            for bi in range(B):
                r = runs[bi]
                if len(r):
                    # contiguous run offsets coalesce to lazy ranges
                    # (dense-match patterns stay O(runs), not O(offsets))
                    tos = r + 1
                    cuts = np.flatnonzero(np.diff(tos) > 1)
                    los = np.concatenate([[0], cuts + 1])
                    his = np.concatenate([cuts, [len(tos) - 1]])
                    for (a, b) in zip(los.tolist(), his.tolist()):
                        per_block[bi].add_range(
                            engine.eidx, int(tos[a]), int(tos[b]))
            _add_start_reports(engine, per_block, lengths)
            continue
        hits, finals = engine_scan_host(engine, data, lengths)
        if isinstance(engine, SomEngine):
            for bi in range(B):
                for (t, sid, frm) in hits[bi]:
                    for (eid, adj) in engine.expand_set(1 << (sid - 1)):
                        per_block[bi].add(eid, t + 1 + adj, frm)
                for (eid, adj, frm) in engine.eod_reports(finals[bi]):
                    per_block[bi].add(eid, int(lengths[bi]) + adj, frm)
            _add_start_reports(engine, per_block, lengths)
            continue
        for bi in range(B):
            hp, hv = hits[bi]
            if len(hp):
                _expand_device_records(
                    engine, np.full(len(hp), bi, np.int64), hp, hv,
                    per_block,
                )
            sid = engine.eod_set(finals[bi])
            if sid:
                for (eid, adj) in engine.expand_set(sid):
                    per_block[bi].add(eid, int(lengths[bi]) + adj)
        _add_start_reports(engine, per_block, lengths)
    return lengths


def _add_start_reports(engine, per_block, lengths) -> None:
    """Empty-match reports (vacuous patterns; reference: boundary
    programs, roseRunBoundaryProgram)."""
    for (anchored, eod, adj, eid) in engine.start_reports:
        for bi in range(len(per_block)):
            n = int(lengths[bi])
            # an empty match starts where it ends: frm == to (correct
            # leftmost under SOM; makes min_length reject empties)
            if anchored and eod:
                if n == 0:
                    per_block[bi].add(eid, adj, adj)
            elif anchored:
                per_block[bi].add(eid, adj, adj)
            elif eod:
                per_block[bi].add(eid, n + adj, n + adj)
            else:
                per_block[bi].add_range(eid, adj, n + adj)


def _pattern_arrays(db: Database):
    """Cached per-pattern report-semantics columns (reference: the Report
    table, src/util/report.h)."""
    if not hasattr(db, "_pat_arrays"):
        n = len(db.patterns)
        minoff = np.zeros(n, dtype=np.int64)
        maxoff = np.full(n, np.iinfo(np.int64).max, dtype=np.int64)
        minlen = np.zeros(n, dtype=np.int64)
        flags = np.zeros(n, dtype=np.int64)
        extid = np.zeros(n, dtype=np.int64)
        for i, p in enumerate(db.patterns):
            minoff[i] = p.min_offset
            if p.max_offset != UNBOUNDED:
                maxoff[i] = p.max_offset
            minlen[i] = p.min_length
            flags[i] = p.flags
            extid[i] = p.external_id
        db._pat_arrays = (minoff, maxoff, minlen, flags, extid)
    return db._pat_arrays


def _finalize_batch(
    db: Database,
    batch: RecordBatch,
    callback,
    seen_single: set,
    som_horizon=None,
) -> Tuple[List[Match], bool]:
    """Vectorized report semantics for the no-combination case."""
    minoff, maxoff, minlen, flags, extid = _pattern_arrays(db)
    if not batch.ranges and len(batch.eids) <= 8:
        # scalar fast path: the numpy pipeline below has ~15 ops of fixed
        # overhead, which dominates the (common) tiny-batch case —
        # streaming writes typically deliver a handful of records
        out: List[Match] = []
        for e, t, f in zip(batch.eids.tolist(), batch.tos.tolist(),
                           batch.frms.tolist()):
            flv = int(flags[e])
            if t < minoff[e] or t > maxoff[e]:
                continue
            ml = int(minlen[e])
            if ml and (t - f) < ml:
                continue
            if flv & HS_FLAG_QUIET:
                continue
            if flv & HS_FLAG_SINGLEMATCH:
                if e in seen_single:
                    continue
                seen_single.add(int(e))
            frm = 0
            if flv & HS_FLAG_SOM_LEFTMOST:
                frm = int(f)
                if som_horizon is not None and t - f > som_horizon:
                    frm = HS_OFFSET_PAST_HORIZON
            m = (int(extid[e]), frm, int(t))
            out.append(m)
            if callback is not None and callback(m[0], m[1], m[2], 0):
                return out, True
        return out, False
    if batch.ranges and any(
        flags[e] & HS_FLAG_SINGLEMATCH for (e, _l, _h) in batch.ranges
    ):
        # SINGLEMATCH first-occurrence must be picked across the merged
        # stream; expand (rare: vacuous + SINGLEMATCH)
        e2, t2, f2 = batch.expand()
        batch = RecordBatch(e2, t2, f2)
    if batch.ranges:
        return _finalize_with_ranges(
            db, batch, callback, seen_single,
            (minoff, maxoff, minlen, flags, extid), som_horizon,
        )
    eids, tos, frms = batch.eids, batch.tos, batch.frms
    fl = flags[eids]
    keep = (tos >= minoff[eids]) & (tos <= maxoff[eids])
    ml = minlen[eids]
    keep &= (ml == 0) | ((tos - frms) >= ml)
    keep &= (fl & HS_FLAG_QUIET) == 0
    sm = keep & ((fl & HS_FLAG_SINGLEMATCH) != 0)
    if sm.any():
        idx = np.flatnonzero(sm)
        keep[idx] = False
        already = np.asarray(
            [int(e) in seen_single for e in eids[idx]], dtype=bool
        )
        idx = idx[~already]
        # first record per expression in delivery order (records are
        # sorted by offset)
        _u, fi = np.unique(eids[idx], return_index=True)
        first = idx[fi]
        keep[first] = True
        seen_single.update(int(e) for e in eids[first])
    eids, tos, frms, fl = eids[keep], tos[keep], frms[keep], fl[keep]
    som = (fl & HS_FLAG_SOM_LEFTMOST) != 0
    rep_frm = np.where(som, frms, 0)
    past = None
    if som_horizon is not None:
        # start beyond the horizon precision (reference:
        # HS_OFFSET_PAST_HORIZON, hs_runtime.h:615); -1 sentinel in the
        # int64 array, mapped to the 2^64-1 constant at delivery
        past = som & (tos - frms > som_horizon)
        rep_frm = np.where(past, -1, rep_frm)
    ext = extid[eids]
    el, fl_, tl = ext.tolist(), rep_frm.tolist(), tos.tolist()
    if past is not None and past.any():
        fl_ = [HS_OFFSET_PAST_HORIZON if f < 0 else f for f in fl_]
    if callback is None:
        return list(zip(el, fl_, tl)), False
    out: List[Match] = []
    for j in range(len(el)):
        m = (el[j], fl_[j], tl[j])
        out.append(m)
        if callback(el[j], fl_[j], tl[j], 0):
            return out, True
    return out, False


def _expand_combinations(
    db: Database,
    records: List[Tuple[int, int, int]],
    matched: set,
    at_end: bool,
    end_offset: int,
) -> List[Tuple[int, int, int]]:
    """Insert logical-combination reports into the event stream.

    Reference semantics (src/rose/program_runtime.c SET_LOGICAL /
    FLUSH_COMBINATION / LAST_FLUSH_COMBINATION): combinations referenced by
    any sub-expression matching at offset X are flushed once all events at
    X are processed; at end of data, combinations true with *none* of their
    referenced sub-expressions matched report at the data end (purely
    negative combinations)."""
    from ..compiler.logical import evaluate

    combos = db.combos()
    out: List[Tuple[int, int, int]] = []
    active: set = set()
    prev_to: Optional[int] = None

    def flush(to: int) -> None:
        for ci in sorted(active):
            eidx, ast, _refs = combos[ci]
            if evaluate(ast, matched):
                out.append((eidx, to, 0))
        active.clear()

    for (eidx, to, frm) in records:
        if prev_to is not None and to != prev_to:
            flush(prev_to)
        prev_to = to
        out.append((eidx, to, frm))
        xid = db.patterns[eidx].external_id
        matched.add(xid)
        for ci, (_ce, _ast, refs) in enumerate(combos):
            if xid in refs:
                active.add(ci)
    if prev_to is not None:
        flush(prev_to)
    if at_end:
        for (ceidx, ast, refs) in combos:
            if refs.isdisjoint(matched) and evaluate(ast, matched):
                out.append((ceidx, end_offset, 0))
    return out


def _finalize_with_ranges(
    db: Database,
    batch: RecordBatch,
    callback,
    seen_single: set,
    cols,
    som_horizon=None,
) -> Tuple[List[Match], bool]:
    """Batch finalize with unexpanded vacuous ranges: range semantics are
    uniform per range (same pattern, frm 0), so bounds/QUIET apply to the
    whole interval; expansion happens once, at delivery."""
    minoff, maxoff, minlen, flags, extid = cols
    # array part: reuse the plain batch path semantics without delivery
    arr_ms, _term = _finalize_batch(
        db, RecordBatch(batch.eids, batch.tos, batch.frms), None,
        seen_single, som_horizon,
    )
    # pieces are (min_to, max_to, kind, payload); ranges expand with
    # C-level zip(repeat, repeat, range) — no numpy materialization
    import itertools

    pieces = []
    if arr_ms:
        pieces.append((arr_ms[0][2], arr_ms[-1][2], "arr", arr_ms))
    for (eid, lo, hi) in batch.ranges:
        fl = int(flags[eid])
        if fl & HS_FLAG_QUIET:
            continue
        lo = max(lo, int(minoff[eid]))
        hi = min(hi, int(maxoff[eid]))
        if minlen[eid]:
            lo = max(lo, int(minlen[eid]))
        if hi < lo:
            continue
        pieces.append((lo, hi, "range",
                       (int(extid[eid]), lo, hi,
                        bool(fl & HS_FLAG_SOM_LEFTMOST))))
    if not pieces:
        return [], False
    pieces.sort(key=lambda p: p[0])
    disjoint = all(
        pieces[i][1] < pieces[i + 1][0] for i in range(len(pieces) - 1)
    )
    if disjoint and callback is None:
        out: List[Match] = []
        for (_lo, _hi, kind, payload) in pieces:
            if kind == "arr":
                out.extend(payload)
            else:
                (e, lo, hi, is_som) = payload
                if is_som:
                    out.extend(zip(itertools.repeat(e), range(lo, hi + 1),
                                   range(lo, hi + 1)))
                else:
                    out.extend(zip(itertools.repeat(e), itertools.repeat(0),
                                   range(lo, hi + 1)))
        return out, False
    # overlapping pieces (or callback delivery): merge by offset
    ts, es, fs = [], [], []
    for (_lo, _hi, kind, payload) in pieces:
        if kind == "arr":
            a = np.asarray(payload, dtype=np.int64)
            ts.append(a[:, 2])
            es.append(a[:, 0])
            fs.append(a[:, 1])
        else:
            (e, lo, hi, is_som) = payload
            t = np.arange(lo, hi + 1, dtype=np.int64)
            ts.append(t)
            es.append(np.full_like(t, e))
            fs.append(t.copy() if is_som else np.zeros_like(t))
    tos = np.concatenate(ts)
    ext = np.concatenate(es)
    frm = np.concatenate(fs)
    order = np.lexsort((ext, tos))
    tos, ext, frm = tos[order], ext[order], frm[order]
    if callback is None:
        return list(zip(ext.tolist(), frm.tolist(), tos.tolist())), False
    out = []
    el, fl_, tl = ext.tolist(), frm.tolist(), tos.tolist()
    for j in range(len(el)):
        out.append((el[j], fl_[j], tl[j]))
        if callback(el[j], fl_[j], tl[j], 0):
            return out, True
    return out, False


def finalize_reports(
    db: Database,
    records: List[Tuple[int, int]],
    callback: Optional[Callable[[int, int, int, int], int]] = None,
    seen_single: Optional[set] = None,
    combo_matched: Optional[set] = None,
    at_end: bool = True,
    end_offset: Optional[int] = None,
    som_horizon: Optional[int] = None,
) -> Tuple[List[Match], bool]:
    """Apply report semantics and deliver matches in offset order.

    Returns (matches, terminated). `terminated` is True if a callback
    returned nonzero (reference: HS_SCAN_TERMINATED, src/hs_runtime.h:78).
    `seen_single` and `combo_matched` carry SINGLEMATCH / logical-vector
    state across calls (streaming: the stream owns them for its lifetime).
    """
    if seen_single is None:
        seen_single = set()

    if isinstance(records, RecordBatch):
        if not db.combos():
            # vectorized fast path: dense-match patterns (`x*` over
            # megabytes) never touch per-record Python
            return _finalize_batch(db, records, callback, seen_single,
                                   som_horizon)
        records = records.tuples()

    # stage 1: per-pattern offset bounds (sub-expression guards run before
    # combinations see the event — reference: CHECK_BOUNDS precedes
    # SET_LOGICAL in the literal program)
    recs: List[Tuple[int, int, int]] = []
    for rec in records:
        eidx, to = rec[0], rec[1]
        frm = rec[2] if len(rec) > 2 else 0
        p = db.patterns[eidx]
        if not (p.min_offset <= to <= p.max_offset):
            continue
        if p.min_length and to - frm < p.min_length:
            # frm is the leftmost start, so to-frm is the longest match
            # length ending here (reference: min_length ext param)
            continue
        recs.append((eidx, to, frm))

    # stage 2: logical combinations
    if db.combos():
        if end_offset is None:
            end_offset = recs[-1][1] if recs else 0
        recs = _expand_combinations(
            db, recs, combo_matched if combo_matched is not None else set(),
            at_end, end_offset,
        )

    # stage 3: delivery (QUIET / SINGLEMATCH / callback)
    out: List[Match] = []
    for (eidx, to, frm) in recs:
        p = db.patterns[eidx]
        if p.combination is not None and not (p.min_offset <= to <= p.max_offset):
            continue  # combination's own ext bounds, checked at flush time
        if p.flags & HS_FLAG_QUIET:
            continue
        if p.flags & HS_FLAG_SINGLEMATCH:
            if eidx in seen_single:
                continue
            seen_single.add(eidx)
        # `from` is only reported under SOM_LEFTMOST (it may be tracked
        # internally for min_length without being reported)
        rep_frm = frm if (p.flags & HS_FLAG_SOM_LEFTMOST) else 0
        if (
            som_horizon is not None
            and (p.flags & HS_FLAG_SOM_LEFTMOST)
            and to - frm > som_horizon
        ):
            rep_frm = HS_OFFSET_PAST_HORIZON
        m = (p.external_id, rep_frm, to)
        out.append(m)
        if callback is not None:
            if callback(p.external_id, rep_frm, to, 0):
                return out, True
    return out, False


def finalize_report_ranges(
    db: Database,
    batch: RecordBatch,
    seen_single: Optional[set] = None,
    som_horizon: Optional[int] = None,
) -> Tuple[List[Match], List[Tuple[int, int, int]]]:
    """Report semantics WITHOUT expanding dense per-offset ranges.

    Returns (point_matches, ranges) where each range (external_id,
    lo_to, hi_to) stands for a match at every `to` in [lo_to, hi_to]
    with from=0 — O(ranges) instead of O(offsets) for pathological
    match densities (`x*` over megabytes). The reference delivers such
    matches as millions of ns-cost callbacks (src/rose/match.c); a
    vectorized runtime's equivalent is the interval itself.
    """
    if seen_single is None:
        seen_single = set()
    if db.combos():
        # combination flush points depend on every event offset: fall
        # back to full expansion (rare: vacuous + combinations)
        ms, _t = finalize_reports(db, batch, None,
                                  seen_single=seen_single,
                                  som_horizon=som_horizon)
        return ms, []
    minoff, maxoff, minlen, flags, extid = _pattern_arrays(db)
    ms, _t = _finalize_batch(
        db, RecordBatch(batch.eids, batch.tos, batch.frms), None,
        seen_single, som_horizon,
    )
    out_r: List[Tuple[int, int, int]] = []
    for (eid, lo, hi) in batch.ranges:
        fl = int(flags[eid])
        if fl & HS_FLAG_QUIET:
            continue
        lo = max(lo, int(minoff[eid]))
        hi = min(hi, int(maxoff[eid]))
        if minlen[eid]:
            lo = max(lo, int(minlen[eid]))
        if hi < lo:
            continue
        if fl & HS_FLAG_SINGLEMATCH:
            if eid not in seen_single:
                seen_single.add(int(eid))
                ms.append((int(extid[eid]), 0, lo))
            continue
        out_r.append((int(extid[eid]), lo, hi))
    return ms, out_r


def scan_block_ranges(
    db: Database,
    data: bytes,
    scratch: Optional[Scratch] = None,
    device="cuda",
) -> Tuple[List[Match], List[Tuple[int, int, int]]]:
    """Block scan returning (point_matches, unexpanded ranges) — the
    O(ranges) entry point for dense-match patterns (see
    finalize_report_ranges). Runs on `device`, the card by default."""
    if base_mode(db.mode) != HS_MODE_BLOCK:
        raise DbModeError("database not compiled for block mode")
    device = resolve_device(device)
    scratch = scratch or Scratch()
    recs = scan_blocks_raw(db, [bytes(data)], scratch.capacity,
                           device=device)[0]
    return finalize_report_ranges(db, recs)


def scan_count(
    db: Database,
    data: bytes,
    scratch: Optional[Scratch] = None,
    device="cuda",
) -> int:
    """Total match count of a block scan without materializing
    per-offset tuples (hsbench matches/kB without the tuple cost)."""
    ms, ranges = scan_block_ranges(db, data, scratch, device)
    return len(ms) + sum(hi - lo + 1 for (_e, lo, hi) in ranges)


def scan_block(
    db: Database,
    data: bytes,
    callback: Optional[Callable[[int, int, int, int], int]] = None,
    scratch: Optional[Scratch] = None,
    device="cuda",
) -> Tuple[List[Match], bool]:
    """hs_scan analogue (reference: src/runtime.c:316)."""
    if base_mode(db.mode) != HS_MODE_BLOCK:
        raise DbModeError("database not compiled for block mode")
    if not isinstance(data, (bytes, bytearray, memoryview)):
        raise InvalidError("data must be bytes-like")
    device = resolve_device(device)
    scratch = scratch or Scratch()
    if scratch.in_use:
        raise ScratchInUseError("scratch is already in use")
    scratch.in_use = True
    try:
        recs = scan_blocks_raw(db, [bytes(data)], scratch.capacity,
                               device=device)[0]
        return finalize_reports(db, recs, callback, end_offset=len(data))
    finally:
        scratch.in_use = False


@spanned("hs.scan_batch")
def scan_batch(
    db: Database,
    blocks: Sequence[bytes],
    scratch: Optional[Scratch] = None,
    mesh=None,
    threads: int = 1,
    device=None,
) -> List[List[Match]]:
    """Batched block scan: the blocks are concatenated into one flat
    corpus that the device filters in one dispatch (reference's per-core
    thread model replaced by batch parallelism). `threads > 1`
    partitions the batch across host threads — the hsbench `-T` analogue
    (reference: one scratch per thread, hs_runtime.h:555-576); the native
    C scans release the GIL, so host-path batches scale with cores.
    `device` is where the scan runs: the card ("cuda") when None.
    `mesh` (a `parallel.Mesh`) shards the literal pipeline across its
    devices (see scan_blocks_raw); the scan then runs on the mesh's
    devices, and an explicit `device` other than the mesh's first raises
    InvalidError."""
    if base_mode(db.mode) != HS_MODE_BLOCK:
        raise DbModeError("database not compiled for block mode")
    if threads > 1 and mesh is not None:
        raise InvalidError(
            "threads and mesh are exclusive: a mesh already partitions "
            "the batch across chips (one dispatching host thread); use "
            "threads only for host-path scans")
    if mesh is not None:
        device = mesh_device(mesh, device)
    device = resolve_device("cuda" if device is None else device)
    scratch = scratch or Scratch()
    blocks = [bytes(b) for b in blocks]
    if threads > 1 and mesh is None and len(blocks) > 1:
        from concurrent.futures import ThreadPoolExecutor

        groups = [list(range(g, len(blocks), threads))
                  for g in range(threads)]
        groups = [g for g in groups if g]
        out: List[Optional[List[Match]]] = [None] * len(blocks)

        def run(g):
            recs_g = scan_blocks_raw(db, [blocks[i] for i in g],
                                     scratch.capacity, device=device)
            return g, recs_g

        with ThreadPoolExecutor(max_workers=len(groups)) as ex:
            for g, recs_g in ex.map(run, groups):
                for i, recs in zip(g, recs_g):
                    out[i] = finalize_reports(
                        db, recs, end_offset=len(blocks[i]))[0]
        return out  # type: ignore[return-value]
    all_recs = scan_blocks_raw(db, blocks, scratch.capacity, mesh=mesh,
                               device=device)
    with span("hs.reports"):
        return [
            finalize_reports(db, recs, end_offset=len(blocks[i]))[0]
            for i, recs in enumerate(all_recs)
        ]
