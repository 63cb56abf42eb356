"""Literal-path runtime: Teddy candidates → exact confirm → window validation.

Reference analogues:
- confirm-after-candidate: src/fdr/fdr_confirm.h / do_confirm_fdr
  (src/fdr/fdr.c:330) — candidates from the filter are checked against the
  exact literal bytes before any reporting.
- role validation around a literal hit: the Rose literal program running
  CHECK_* guards then triggering engines (src/rose/program_runtime.c); here
  the role logic is a bounded window re-scan with the pattern's own
  scanning DFA, entered in the float-rest state (or the anchored start
  state when the window touches offset 0).

The device produces sparse candidates; this stage runs on host over numpy
(work is proportional to candidate count, not corpus size — the same
asymmetry the reference exploits with its confirm step).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Sequence, Set, Tuple

import numpy as np

from ..compiler.literals import MAX_FACTOR_LEN
from ..trace import count, spanned

Record = Tuple[int, int, int, int]  # (block_idx, expr_idx, to_local, from_local)
# from_local is 0 unless the pattern has HS_FLAG_SOM_LEFTMOST, in which
# case it is the leftmost match start (reference: som/som_runtime.c)

# extra window bytes on each side covering Glushkov-synthesized boundary
# context positions (\b / ^m / $ consume one adjacent byte; under UCP a
# \b context chain consumes one full UTF-8 codepoint of up to 4 bytes;
# see compiler/glushkov.py _Resolver)
WINDOW_SLACK = 4


def _confirm_index(lit):
    """Hash-style confirm tables (reference: FDRConfirm,
    src/fdr/fdr_confirm.h:78 — hash the masked tail bytes, then exact
    compare). Factors are grouped by (tail_len, tail_mask); each group is
    a sorted array of masked tail values, so confirm is a handful of
    searchsorted/gather ops over ALL candidates instead of a Python loop
    over every factor (78 factors/bucket at the 10k scale)."""
    if hasattr(lit, "_confirm_idx"):
        return lit._confirm_idx
    groups: Dict[Tuple[int, bytes], List[Tuple[int, int]]] = {}
    flen_arr = np.zeros(len(lit.factor_atoms), dtype=np.int64)
    for fid, atoms in enumerate(lit.factor_atoms):
        flen = len(atoms)
        flen_arr[fid] = flen
        cl = min(flen, 8)
        tail = atoms[-cl:]
        masks = bytes(m for (_v, m) in tail)
        vals = bytes((v & m) for (v, m) in tail)
        groups.setdefault((cl, masks), []).append(
            (int.from_bytes(vals, "little"), fid)
        )
    packed = []
    for (cl, masks), items in groups.items():
        items.sort()
        vals = np.asarray([v for (v, _f) in items], dtype=np.uint64)
        fids = np.asarray([f for (_v, f) in items], dtype=np.int64)
        mask64 = np.uint64(int.from_bytes(masks, "little"))
        long_tail = bool((flen_arr[fids] > 8).any())
        packed.append((cl, mask64, vals, fids, long_tail))
    lit._confirm_idx = (packed, flen_arr)
    return lit._confirm_idx


def _avalanche32(h: np.ndarray) -> np.ndarray:
    """Full-avalanche finalizer (xorshift-multiply): every input bit
    affects the low bits used as the hash-bucket index. Mirrored exactly
    by the device in ops.teddy._hash_confirm_stage."""
    h = h.astype(np.uint32).copy()
    h ^= h >> np.uint32(15)
    h *= np.uint32(0x2C1B3C6D)
    h ^= h >> np.uint32(13)
    return h


def confirm_device_tables(lit):
    """Confirm tables in device form (reference: FDRConfirm hash tables).

    Each (tail_len, tail_mask) group becomes a sorted int32 hash table:
    h = (lo32 * 0x9E3779B1) ^ (hi32 * 0x85EBCA6B) over the masked tail,
    with the tail aligned so the newest byte is the top byte of hi32 —
    matching the fixed 8-byte tail words the fused kernel packs for
    every position.

    Entries are deduplicated by distinct masked tail *value* (one class
    per value), so the device multiplicity loop is bounded by genuine
    32-bit hash collisions (≈1), not by how many factors share a tail —
    rulesets built from a phrase vocabulary routinely have 100+ factors
    with identical 8-byte tails, and probing each on device costs a full
    pass over the candidate buffer. The device emits (pos, class) pairs;
    expand_confirm_classes maps classes back to factor ids on host and
    verify_pairs re-checks exact bytes, so hash collisions only cost
    fetch bytes, never correctness.
    Returns [(cl, mlo, mhi, h_sorted i32, class_sorted i32, maxmult)].
    """
    if hasattr(lit, "_confirm_dev"):
        return lit._confirm_dev
    packed, _flen = _confirm_index(lit)
    out = []
    cls_fids: List[np.ndarray] = []
    cls_offs = [0]
    next_cls = 0
    for (cl, mask64, vals, fids, _long) in packed:
        shift = np.uint64(8 * (8 - cl))
        mask_f = int(mask64) << int(shift)
        vals_f = vals << shift  # fixed alignment: newest byte at the top
        mlo = np.uint32(mask_f & 0xFFFFFFFF)
        mhi = np.uint32((mask_f >> 32) & 0xFFFFFFFF)
        # one class per distinct masked tail value (vals is sorted)
        uvals, first = np.unique(vals_f, return_index=True)
        counts = np.diff(np.append(first, len(vals_f)))
        for j in range(len(uvals)):
            cls_fids.append(fids[first[j]:first[j] + counts[j]])
            cls_offs.append(cls_offs[-1] + counts[j])
        lo = (uvals & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        hi = (uvals >> np.uint64(32)).astype(np.uint32)
        h = ((lo * np.uint32(0x9E3779B1)) ^ (hi * np.uint32(0x85EBCA6B)))
        h = h.view(np.int32)
        cids = np.arange(next_cls, next_cls + len(uvals), dtype=np.int32)
        next_cls += len(uvals)
        # open-addressed direct-mapped table, ONE int32 per slot
        # (12-bit hash signature << 20 | class id + 1; 0 = empty): the
        # device probes slot (h & (T-1)) + k for k <= max displacement —
        # ONE take per probe. A sorted-array binary search costs log2(F)
        # dependent gathers per candidate (~13 at 10k scale); every take
        # costs ~20 ns/candidate on v5e, so probe count is the confirm
        # stage's unit of money. The raw multiplicative hash clusters
        # badly here: its low bits (the bucket index) ignore the
        # operands' high bytes, and vocabulary tails differ exactly in
        # the newest byte (the TOP byte of hi_w) — an xorshift-multiply
        # avalanche (applied identically on device) spreads them. A
        # 12-bit signature passes ~1/4096 false positives per probe;
        # verify_pairs exact-compares bytes afterwards, so collisions
        # cost fetch bytes, never correctness (the same division of
        # labor as the reference's confirm, src/fdr/fdr_confirm.h:78).
        F = len(uvals)
        hm = _avalanche32(h.view(np.uint32))
        sig = (hm >> np.uint32(20)).astype(np.int64)
        if next_cls >= (1 << 20):
            from ..errors import InvalidError

            raise InvalidError("confirm class space exceeded 2^20")
        T = 1 << max(4, (2 * F - 1).bit_length()) if F else 16
        while True:
            slots = np.zeros(T, np.int64)
            disp = 0
            for hv, sg, cid in zip(hm.tolist(), sig.tolist(),
                                   cids.tolist()):
                idx = hv & (T - 1)
                d = 0
                while slots[(idx + d) & (T - 1)] != 0:
                    d += 1
                slots[(idx + d) & (T - 1)] = (sg << 20) | (cid + 1)
                disp = max(disp, d)
            if disp <= 4 or T >= (1 << 22):
                break
            T <<= 1
        out.append((int(cl), mlo, mhi,
                    slots.astype(np.uint32).view(np.int32),
                    np.zeros(1, np.int32), disp + 1))
    lit._confirm_cls = (
        np.asarray(cls_offs, dtype=np.int64),
        np.concatenate(cls_fids).astype(np.int64)
        if cls_fids else np.zeros(0, np.int64),
    )
    lit._confirm_dev = out
    return out


def expand_confirm_classes(
    lit, cls_a: np.ndarray, pos_a: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray]:
    """Expand device (class, pos) pairs to (fid, pos) pairs (a class is
    the set of factors sharing one masked tail value)."""
    if cls_a.size == 0:
        return cls_a, pos_a
    offs, fids = lit._confirm_cls
    starts = offs[cls_a]
    counts = offs[cls_a + 1] - starts
    total = int(counts.sum())
    ends_c = np.cumsum(counts)
    idx = (np.arange(total, dtype=np.int64)
           - np.repeat(ends_c - counts, counts)
           + np.repeat(starts, counts))
    return fids[idx], np.repeat(pos_a, counts)


def _atom_tables(lit):
    """Every factor's atoms packed end to end (cached): `value & mask`
    and `mask` as two flat uint8 arrays, each factor's offset into them,
    its length, and its width class: the smallest power of two that
    holds it, from the compiler's factor cap up, so that a compiled
    database's factors all share one class."""
    if hasattr(lit, "_atom_tab"):
        return lit._atom_tab
    _packed, flen_arr = _confirm_index(lit)
    off = np.zeros(len(flen_arr), dtype=np.int64)
    np.cumsum(flen_arr[:-1], out=off[1:])
    n = int(flen_arr.sum())
    vm = np.fromiter(
        itertools.chain.from_iterable(
            itertools.chain.from_iterable(lit.factor_atoms)),
        dtype=np.uint8, count=2 * n,
    ).reshape(n, 2)
    width = np.full(len(flen_arr), 1 << (MAX_FACTOR_LEN - 1).bit_length(),
                    dtype=np.int64)
    while (width < flen_arr).any():
        width = np.where(width < flen_arr, width * 2, width)
    lit._atom_tab = (vm[:, 0] & vm[:, 1], vm[:, 1].copy(), off, flen_arr,
                     width)
    return lit._atom_tab


def _atoms_match(
    lit, corpus: np.ndarray, fid_a: np.ndarray, p_a: np.ndarray,
) -> np.ndarray:
    """Whether factor fid_a[i]'s (value, mask) atoms match the corpus
    bytes that end at flat position p_a[i] (the factor must start inside
    the corpus). One gather and compare for each width class present,
    whatever the number of distinct factors: each pair's right-aligned
    window of the class width against its factor's slice of the flat
    tables, the bytes before the factor masked out."""
    vm, mm, off, flen_arr, width = _atom_tables(lit)
    ok = np.ones(len(fid_a), dtype=bool)
    wp = width[fid_a]
    classes = np.unique(wp).tolist()
    for w in classes:
        sel = (slice(None) if len(classes) == 1
               else np.flatnonzero(wp == w))
        f, p = fid_a[sel], p_a[sel]
        ar = np.arange(w)
        t = (off[f] + flen_arr[f] - w)[:, None] + ar  # table index
        pre = t < off[f][:, None]  # columns before the factor
        t = np.maximum(t, 0)
        win = corpus[np.maximum(p[:, None] - (w - 1) + ar, 0)]
        ok[sel] = np.all((((win ^ vm[t]) & mm[t]) == 0) | pre, axis=1)
        count("verify_passes")
    return ok


@spanned("hs.verify")
def verify_pairs(
    lit, corpus: np.ndarray, block_starts: np.ndarray,
    fid_a: np.ndarray, p_a: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray]:
    """Exact host verification of device hash-confirmed (fid, pos)
    pairs: block containment + full (value, mask) atom compare. The
    pairs that pass keep their input order."""
    count("verify_pairs", int(fid_a.size))
    if fid_a.size == 0:
        return fid_a, p_a
    flen_arr = _atom_tables(lit)[3]
    blk = np.searchsorted(block_starts, p_a, side="right") - 1
    keep = (p_a - flen_arr[fid_a] + 1) >= block_starts[blk]
    fid_a, p_a = fid_a[keep], p_a[keep]
    if fid_a.size == 0:
        return fid_a, p_a
    good = _atoms_match(lit, corpus, fid_a, p_a)
    return fid_a[good], p_a[good]


def confirm_candidates(
    lit, corpus: np.ndarray, block_starts: np.ndarray,
    pos: np.ndarray, words: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray]:
    """Exact-match confirm: returns (fid_array, flat_end_pos_array).

    `pos` are flat indices of candidate last-factor bytes. A factor is
    confirmed when its (value, mask) atoms match the corpus bytes and the
    factor lies entirely inside one input block. The filter's bucket
    bitmask is not re-checked: the tail compare is exact, and a real
    factor occurrence always fires its own bucket, so the hash route
    finds exactly the same set.
    """
    z = np.zeros(0, dtype=np.int64)
    n = pos.shape[0]
    if n == 0:
        return z, z
    clen = corpus.shape[0]
    pos = np.asarray(pos, dtype=np.int64)
    pos = pos[pos < clen]  # drop candidates in the padded tail
    if pos.size == 0:
        return z, z

    from ..native import confirm_native

    nat = confirm_native(lit, corpus, block_starts, pos)
    if nat is not None:
        return nat

    blk = np.searchsorted(block_starts, pos, side="right") - 1
    bstart = block_starts[blk]
    packed, flen_arr = _confirm_index(lit)

    # gather each candidate's 8-byte tail once (clamped; short-prefix
    # candidates are masked out per group below)
    tail_idx = np.maximum(pos[:, None] - np.arange(7, -1, -1)[None, :], 0)
    tail = corpus[tail_idx].astype(np.uint64)  # [n, 8] oldest..newest

    out_f: List[np.ndarray] = []
    out_p: List[np.ndarray] = []
    shifts = (np.arange(8, dtype=np.uint64) * np.uint64(8))
    for (cl, mask64, vals, fids, long_tail) in packed:
        v = (tail[:, 8 - cl:] << shifts[:cl][None, :]).sum(
            axis=1, dtype=np.uint64
        )
        v &= mask64
        ok = pos >= cl - 1
        i0 = np.searchsorted(vals, v, side="left")
        i1 = np.searchsorted(vals, v, side="right")
        maxmult = int((i1 - i0).max()) if len(vals) else 0
        for k in range(maxmult):
            sel = np.flatnonzero(ok & (i0 + k < i1))
            if sel.size == 0:
                break
            f_sel = fids[i0[sel] + k]
            p_sel = pos[sel]
            # whole factor must lie inside the candidate's block
            starts = p_sel - flen_arr[f_sel] + 1
            okb = starts >= bstart[sel]
            f_sel, p_sel = f_sel[okb], p_sel[okb]
            if long_tail:
                # factors longer than the 8-byte tail: verify the rest
                lt = np.flatnonzero(flen_arr[f_sel] > 8)
                if lt.size:
                    keep = np.ones(len(f_sel), dtype=bool)
                    keep[lt] = _atoms_match(lit, corpus, f_sel[lt], p_sel[lt])
                    f_sel, p_sel = f_sel[keep], p_sel[keep]
            out_f.append(f_sel)
            out_p.append(p_sel)
    if not out_f:
        return z, z
    return np.concatenate(out_f), np.concatenate(out_p)


def _merge_spans(spans: List[Tuple[int, int, int]]) -> List[Tuple[int, int, int]]:
    """Merge overlapping (start, end, block_idx) spans within a block."""
    spans.sort()
    merged: List[Tuple[int, int, int]] = []
    for s, e, b in spans:
        if merged and merged[-1][2] == b and s <= merged[-1][1]:
            ps, pe, pb = merged[-1]
            merged[-1] = (ps, max(pe, e), pb)
        else:
            merged.append((s, e, b))
    return merged


def _som_backscan(rev, row: np.ndarray, upto: int,
                  at_block_start: bool) -> int:
    """Leftmost match start (window-relative) for a match whose consumed
    end is `upto` in this window. Reverse-DFA scan (reference analogue:
    nfaBlockExecReverse for SOM, src/som/som_runtime.c rev-NFA ops)."""
    s = int(rev.start_state)
    dead = int(rev.float_state)
    trans = rev.trans
    b2c = rev.byte_to_class
    aidv = rev.accept_id
    best = None
    completed = True
    for j in range(upto - 1, -1, -1):
        s = int(trans[s, int(b2c[int(row[j])])])
        aid = int(aidv[s])
        if aid:
            for (_e, adj) in rev.expand_set(aid):
                c = j + adj
                best = c if best is None else min(best, c)
        if s == dead:
            completed = False
            break
    if completed and at_block_start:
        aid = int(rev.accept_eod_id[s])
        if aid:
            for (_e, adj) in rev.expand_set(aid):
                best = adj if best is None else min(best, adj)
    return 0 if best is None else best


def validate_windows(
    validator, expr_idx: int, corpus: np.ndarray,
    spans: List[Tuple[int, int, int]],
    block_starts: np.ndarray, block_ends: np.ndarray,
    block_anchored: np.ndarray, block_final: np.ndarray,
    eod_only: bool = False,
    som_rev: Tuple = None,
) -> Set[Record]:
    """Lockstep numpy DFA scan over merged windows of one pattern.

    `validator` is a DfaEngine built from the pattern alone; spans are
    (flat_start, flat_end, block_idx), already clamped to block bounds.
    """
    recs: Set[Record] = set()
    if not spans:
        return recs
    spans = _merge_spans(spans)
    nw = len(spans)
    starts = np.asarray([s for (s, _e, _b) in spans], dtype=np.int64)
    ends = np.asarray([e for (_s, e, _b) in spans], dtype=np.int64)
    blks = np.asarray([b for (_s, _e, b) in spans], dtype=np.int64)
    lens = ends - starts
    wmax = int(lens.max())
    win = np.zeros((nw, wmax), dtype=np.uint8)
    for i, (s, e, _b) in enumerate(spans):
        win[i, : e - s] = corpus[s:e]

    b2c = validator.byte_to_class.astype(np.int64)
    trans = validator.trans
    accept_id = validator.accept_id
    accept_eod_id = validator.accept_eod_id
    bs = block_starts[blks]
    be = block_ends[blks]
    # anchored context only when the window starts at the true beginning
    # of the logical data (offset 0 of a block, or of a whole stream)
    states = np.where(
        (starts == bs) & block_anchored[blks],
        validator.start_state,
        validator.float_state,
    ).astype(np.int64)

    if eod_only or som_rev is not None:
        # SOM / close-pass: per-accept back-scans need the lockstep loop
        cls = b2c[win]  # [nw, wmax]
        for t in range(wmax):
            active = t < lens
            nxt = trans[states, cls[:, t]]
            states = np.where(active, nxt, states)
            if eod_only:  # close-pass: mid-data accepts already reported
                continue
            aids = np.where(active, accept_id[states], 0)
            for i in np.flatnonzero(aids):
                to_flat = int(starts[i]) + t + 1
                frm = 0
                if som_rev is not None and som_rev[0] is not None:
                    j = _som_backscan(
                        som_rev[0], win[i], t + 1,
                        bool((starts[i] == bs[i]) & block_anchored[blks[i]]),
                    )
                    frm = max(0, int(starts[i]) + j - int(bs[i]))
                for (eidx, adj) in validator.expand_set(int(aids[i])):
                    to_local = to_flat + adj - int(bs[i])
                    if 0 <= to_local <= int(be[i]) - int(bs[i]):
                        recs.add((int(blks[i]), eidx, to_local, frm))
    else:
        # common path: native batch DFA scan over the window rows (the
        # per-byte numpy loop costs microseconds of interpreter per step;
        # dense-match windows have one accept per byte)
        from .smallwrite import dfa_scan_host

        hits, states = dfa_scan_host(
            validator, win, lens.astype(np.int32),
            init_states=states.astype(np.int32),
        )
        for i in range(nw):
            hp, hv = hits[i]
            if not len(hp):
                continue
            base_to = int(starts[i]) - int(bs[i]) + 1
            blen = int(be[i]) - int(bs[i])
            bi = int(blks[i])
            for aid in np.unique(hv):
                tt = hp[hv == aid] + base_to
                for (eidx, adj) in validator.expand_set(int(aid)):
                    ta = tt + adj
                    for to_local in ta[(ta >= 0) & (ta <= blen)].tolist():
                        recs.add((bi, eidx, int(to_local), 0))
    # EOD accepts where the window reaches the end of its block (and the
    # block really is the end of the logical data — not a mid-stream chunk)
    at_eod = (ends == be) & block_final[blks]
    eod_aids = np.where(at_eod, accept_eod_id[states], 0)
    for i in np.flatnonzero(eod_aids):
        blen = int(be[i]) - int(bs[i])
        frm = 0
        if som_rev is not None and som_rev[1] is not None:
            j = _som_backscan(
                som_rev[1], win[i], int(lens[i]),
                bool((starts[i] == bs[i]) & block_anchored[blks[i]]),
            )
            frm = max(0, int(starts[i]) + j - int(bs[i]))
        for (eidx, adj) in validator.expand_set(int(eod_aids[i])):
            to_local = blen + adj
            if 0 <= to_local <= blen:
                recs.add((int(blks[i]), eidx, to_local, frm))
    return recs


def _max_f2e(lit) -> int:
    """Max window reach right of a factor end, over every reference."""
    if not hasattr(lit, "_max_f2e"):
        m = 0
        for refs in lit.factor_refs:
            for (_e, _s2f, f2e, _k) in refs:
                m = max(m, int(f2e))
        lit._max_f2e = m
    return lit._max_f2e


def scan_literal_path(
    db, corpus: np.ndarray, block_starts: np.ndarray, block_ends: np.ndarray,
    capacity: int = 1 << 14,
    block_anchored: np.ndarray = None, block_final: np.ndarray = None,
    eod_only: bool = False,
    chain_ctx: Dict = None, chain_out: Dict = None,
    ranges_out: List = None,
    filter_from: np.ndarray = None,
    prefilter_out: Dict = None,
    device="cuda",
    corpus_t=None,
) -> Set[Record]:
    """Full literal pipeline for one flat corpus of concatenated blocks.

    Corpora above the database's `host_scan_limit` are filtered and
    hash-confirmed on the torch `device`, over `corpus_t` when the caller
    has uploaded the corpus already (it is then shared with the engine
    scans).

    `filter_from[b]` (streaming) marks the first NEW flat offset of block
    b's extent: candidates whose windows cannot reach past it were fully
    derived by earlier writes, so the filter runs only over a bounded
    tail region (reference analogue: the delay-rebuild region,
    src/rose/stream.c:415 — the history rescan is bounded, not O(history)).
    The history bytes stay available to confirm/validation windows."""
    lit = db.lit
    if lit is None or corpus.shape[0] == 0:
        return set()

    from .smallwrite import HOST_SCAN_LIMIT, teddy_filter_host

    if corpus.shape[0] <= getattr(db, "host_scan_limit", HOST_SCAN_LIMIT):
        # small-write path: host shift-AND, no device round trip
        if filter_from is None or eod_only:
            pos, words = teddy_filter_host(corpus, lit.masks)
        else:
            M = int(lit.masks.shape[0])
            back = _max_f2e(lit) + WINDOW_SLACK + 1
            fe_min = filter_from.astype(np.int64) - back
            seg_starts = np.maximum(block_starts, fe_min - (M - 1))
            new_bytes = int(np.sum(block_ends - seg_starts))
            if new_bytes * 4 >= int(block_ends[-1]):
                # rescan regions cover most of the extents: one filter
                # call over the whole flat corpus beats per-block call
                # overhead; out-of-region candidates are dropped below
                pos, words = teddy_filter_host(corpus, lit.masks)
                bidx = np.searchsorted(block_starts, pos, side="right") - 1
                keep = pos >= fe_min[bidx]
                pos, words = pos[keep], words[:, keep]
            else:
                pps: List[np.ndarray] = []
                wws: List[np.ndarray] = []
                for b in range(block_starts.shape[0]):
                    bs = int(seg_starts[b])
                    be = int(block_ends[b])
                    p, w = teddy_filter_host(corpus[bs:be], lit.masks)
                    p = p + bs
                    keep = p >= fe_min[b]
                    pps.append(p[keep])
                    wws.append(w[:, keep])
                pos = (np.concatenate(pps) if pps
                       else np.zeros(0, np.int64))
                words = (np.concatenate(wws, axis=1) if wws
                         else np.zeros((int(lit.masks.shape[1]), 0),
                                       np.int32))
        return finish_literal_scan(
            db, corpus, block_starts, block_ends, pos, words,
            block_anchored=block_anchored, block_final=block_final,
            eod_only=eod_only, chain_ctx=chain_ctx, chain_out=chain_out,
            ranges_out=ranges_out, prefilter_out=prefilter_out,
        )
    # device path: filter + per-cell compaction + hash confirm on the
    # torch device — only (pos, fid) pairs cross the device boundary;
    # exact re-verify on host. Capacity overflow re-dispatches on the
    # device at the next power of two (ops.teddy_families.confirm_finish).
    from ..ops.teddy import corpus_tensor
    from ..ops.teddy_families import confirm_scan

    if corpus_t is None:
        corpus_t = corpus_tensor(corpus, device)
    fid_a, p_a = confirm_scan(corpus_t, lit, corpus.shape[0], capacity)
    fid_a, p_a = verify_pairs(lit, corpus, block_starts, fid_a, p_a)
    return finish_confirmed(
        db, corpus, block_starts, block_ends, fid_a, p_a,
        block_anchored=block_anchored, block_final=block_final,
        eod_only=eod_only, chain_ctx=chain_ctx, chain_out=chain_out,
        ranges_out=ranges_out, prefilter_out=prefilter_out,
    )


def finish_literal_scan(
    db, corpus: np.ndarray, block_starts: np.ndarray, block_ends: np.ndarray,
    pos: np.ndarray, words: np.ndarray,
    block_anchored: np.ndarray = None, block_final: np.ndarray = None,
    eod_only: bool = False,
    chain_ctx: Dict = None, chain_out: Dict = None,
    ranges_out: List = None,
    prefilter_out: Dict = None,
) -> Set[Record]:
    """Host stages after the device filter: confirm → windows → validate."""
    fid_a, p_a = confirm_candidates(
        db.lit, corpus, block_starts, pos, words
    )
    return finish_confirmed(
        db, corpus, block_starts, block_ends, fid_a, p_a,
        block_anchored=block_anchored, block_final=block_final,
        eod_only=eod_only, chain_ctx=chain_ctx, chain_out=chain_out,
        ranges_out=ranges_out, prefilter_out=prefilter_out,
    )


@spanned("hs.windows")
def finish_confirmed(
    db, corpus: np.ndarray, block_starts: np.ndarray,
    block_ends: np.ndarray, fid_a: np.ndarray, p_a: np.ndarray,
    block_anchored: np.ndarray = None, block_final: np.ndarray = None,
    eod_only: bool = False,
    chain_ctx: Dict = None, chain_out: Dict = None,
    ranges_out: List = None,
    prefilter_out: Dict = None,
) -> Set[Record]:
    """Window building + validation over exact-confirmed (fid, pos)
    pairs (reference: the rose literal program stage after confirm).

    `prefilter_out` (block mode), when given, collects engine-prefilter
    hits: {pattern_idx: set of block indices where some mandatory "pre"
    factor of that pattern occurred} — the block orchestrator then runs
    the pattern's general engine only over those blocks (the literal-cut
    degradation for patterns whose gaps don't fit the chain machinery;
    reference: Rose's literal cut feeding arbitrary engines,
    ng_violet.cpp:3053)."""
    lit = db.lit
    nb = block_starts.shape[0]
    if block_anchored is None:
        block_anchored = np.ones(nb, dtype=bool)
    if block_final is None:
        block_final = np.ones(nb, dtype=bool)
    recs: Set[Record] = set()
    if fid_a.size == 0:
        # carried chain evidence can produce matches without any new
        # candidate in this extent (a trailing-gap run keeps firing, or
        # a pending role end connects at the extent boundary)
        if chain_ctx and not eod_only:
            recs |= resolve_chains(
                lit, corpus, block_starts, block_ends, block_anchored,
                block_final, (np.zeros(0, np.int64),) * 5,
                chain_ctx=chain_ctx, chain_out=chain_out,
                ranges_out=ranges_out,
            )
        return recs

    # vectorized (confirmed factor) x (pattern ref) expansion
    (r_off, r_eidx, r_s2f, r_f2e, r_kind) = _ref_tables(lit)
    cnt = r_off[fid_a + 1] - r_off[fid_a]
    total = int(cnt.sum())
    rep = np.repeat(np.arange(len(fid_a)), cnt)
    within = np.arange(total) - np.repeat(np.cumsum(cnt) - cnt, cnt)
    ridx = r_off[fid_a][rep] + within
    eidx_p = r_eidx[ridx]
    kind_p = r_kind[ridx]
    fe_p = p_a[rep] + 1  # factor end (exclusive), flat
    b_p = np.searchsorted(block_starts, p_a, side="right")[rep] - 1
    bs_p = block_starts[b_p]
    be_p = block_ends[b_p]
    ws_p = np.maximum(bs_p, fe_p - r_s2f[ridx] - WINDOW_SLACK)
    we_p = np.minimum(be_p, fe_p + r_f2e[ridx] + WINDOW_SLACK)

    # kind -1: engine-prefilter hits (no records; flags blocks)
    if prefilter_out is not None and not eod_only:
        m = kind_p == -1
        if m.any():
            for (e, b) in zip(eidx_p[m].tolist(), b_p[m].tolist()):
                prefilter_out.setdefault(e, set()).add(b)

    # kind 0: factor == whole match
    if not eod_only:
        m = kind_p == 0
        if m.any():
            for (b, e, to) in zip(
                b_p[m].tolist(), eidx_p[m].tolist(), (fe_p[m] - bs_p[m]).tolist()
            ):
                recs.add((b, e, to, 0))

    # kind 1: window validation — batched for non-SOM validators,
    # per-pattern for SOM / eod_only passes
    m = kind_p == 1
    if m.any():
        som_eidx = set(lit.rev_validators)
        old_path = eod_only or False
        sel = np.flatnonzero(m)
        if som_eidx or eod_only:
            slow = np.asarray(
                [eod_only or (int(e) in som_eidx) for e in eidx_p[sel]],
                dtype=bool,
            )
        else:
            slow = np.zeros(len(sel), dtype=bool)
        fast = sel[~slow]
        if fast.size:
            recs |= validate_windows_batched(
                lit, corpus, eidx_p[fast], ws_p[fast], we_p[fast],
                b_p[fast], block_starts, block_ends, block_anchored,
                block_final,
            )
        windows: Dict[int, List[Tuple[int, int, int]]] = {}
        for i in sel[slow].tolist():
            windows.setdefault(int(eidx_p[i]), []).append(
                (int(ws_p[i]), int(we_p[i]), int(b_p[i]))
            )
        for eidx, spans in windows.items():
            v = lit.validators[eidx]
            recs |= validate_windows(
                v, eidx, corpus, spans, block_starts, block_ends,
                block_anchored, block_final, eod_only=eod_only,
                som_rev=lit.rev_validators.get(eidx),
            )

    # factor-anchored refs: head byte checks + anchored suffix scan
    ma = kind_p >= ANCHOR_KIND_BASE
    if ma.any() and not eod_only:
        recs |= _validate_anchored(
            lit, corpus, kind_p[ma] - ANCHOR_KIND_BASE, fe_p[ma],
            b_p[ma], bs_p[ma], be_p[ma], block_final)

    # kinds 2..65: chain roles (SEG <gap> SEG <gap> ...)
    mm = np.flatnonzero((kind_p >= 2) & (kind_p < ANCHOR_KIND_BASE))
    if (len(mm) or chain_ctx) and not eod_only:
        recs |= resolve_chains(
            lit, corpus, block_starts, block_ends, block_anchored,
            block_final,
            (eidx_p[mm], kind_p[mm] - 2, ws_p[mm], we_p[mm], b_p[mm]),
            chain_ctx=chain_ctx, chain_out=chain_out,
            ranges_out=ranges_out,
        )
    return recs


ANCHOR_KIND_BASE = 1000  # kind "a<idx>" -> 1000 + idx (anchored refs)


def _kind_code(k: str) -> int:
    if k == "pre":
        return -1  # engine prefilter: factor hits gate general engines
    if k == "equiv":
        return 0
    if k == "win":
        return 1
    if k.startswith("a"):
        return ANCHOR_KIND_BASE + int(k[1:])
    assert k.startswith("c"), k
    return 2 + int(k[1:])  # chain role r -> 2 + r


def _ref_tables(lit):
    """Flattened factor_refs as parallel arrays for vectorized
    candidate-to-window expansion."""
    if hasattr(lit, "_ref_tab"):
        return lit._ref_tab
    off = [0]
    eidx: List[int] = []
    s2f: List[int] = []
    f2e: List[int] = []
    kind: List[int] = []
    for refs in lit.factor_refs:
        for (e, a, b, k) in refs:
            eidx.append(e)
            s2f.append(a)
            f2e.append(b)
            kind.append(_kind_code(k))
        off.append(len(eidx))
    lit._ref_tab = (
        np.asarray(off, dtype=np.int64),
        np.asarray(eidx, dtype=np.int64),
        np.asarray(s2f, dtype=np.int64),
        np.asarray(f2e, dtype=np.int64),
        np.asarray(kind, dtype=np.int64),
    )
    return lit._ref_tab


def _packed_validators(lit):
    """All non-SOM validator DFAs packed into one global table set, so
    every pattern's windows advance in ONE lockstep scan (the device/
    vector analogue of the Rose literal program: per-candidate work no
    longer pays a per-pattern Python round trip).

    Reference analogue: rose program interpretation over literal matches
    (src/rose/program_runtime.c), re-architected as table-packed DFAs.
    """
    if hasattr(lit, "_vpack"):
        return lit._vpack
    eids = sorted(e for e in lit.validators if e not in lit.rev_validators)
    vid_map: Dict[int, int] = {e: i for i, e in enumerate(eids)}
    V = len(eids)
    if V == 0:
        lit._vpack = None
        return None
    cmax = max(lit.validators[e].trans.shape[1] for e in eids)
    # content-deduplicated table regions: isomorphic validators (same
    # class-indexed tables, different byte remap) share one transition
    # region — b2c stays per pattern, states are global ids either way
    # (reference analogue: leftfix dedupe, rose_build_merge.cpp)
    tid_base: Dict[bytes, int] = {}
    tparts: List = []
    b2c_all = np.zeros((V, 256), dtype=np.int64)
    start_g = np.zeros(V, dtype=np.int64)
    float_g = np.zeros(V, dtype=np.int64)
    total = 0
    for i, e in enumerate(eids):
        v = lit.validators[e]
        key = (v.trans.shape, v.trans.tobytes(), v.accept_id.tobytes(),
               v.accept_eod_id.tobytes())
        base = tid_base.get(key)
        if base is None:
            base = total
            tid_base[key] = base
            tparts.append(v)
            total += v.trans.shape[0]
        b2c_all[i] = v.byte_to_class
        start_g[i] = base + v.start_state
        float_g[i] = base + v.float_state
    trans_all = np.zeros((total, cmax), dtype=np.int64)
    acc_all = np.zeros(total, dtype=np.int64)
    acce_all = np.zeros(total, dtype=np.int64)
    base = 0
    for v in tparts:
        S, C = v.trans.shape
        trans_all[base : base + S, :C] = v.trans.astype(np.int64) + base
        acc_all[base : base + S] = v.accept_id
        acce_all[base : base + S] = v.accept_eod_id
        base += S
    max_e = max(eids)
    vid_arr = np.full(max_e + 1, -1, dtype=np.int64)
    for e, i in vid_map.items():
        vid_arr[e] = i
    # shim engine over the packed tables for the native batch scan
    # (window bytes are pre-mapped to class ids, so byte_to_class is the
    # identity)
    import types

    shim = types.SimpleNamespace(
        trans=trans_all.astype(np.int32),
        byte_to_class=np.arange(256, dtype=np.int32),
        accept_id=acc_all.astype(np.int32),
    )
    lit._vpack = (vid_arr, trans_all, acc_all, acce_all, b2c_all,
                  start_g, float_g, shim)
    return lit._vpack


def _merge_windows(g, b, ws, we, ncorp: int):
    """Merge the overlapping or touching windows [ws, we) of each (g, b)
    group: sort, then a running-max scan with per-group offsets so that
    groups cannot interact. Returns the merged (g, b, ws, we), sorted."""
    o = np.lexsort((ws, b, g))
    g, b, ws, we = g[o], b[o], ws[o], we[o]
    new = np.ones(len(g), dtype=bool)
    new[1:] = (g[1:] != g[:-1]) | (b[1:] != b[:-1])
    off = (np.cumsum(new) - 1) * np.int64(ncorp + (1 << 12))
    runmax = np.maximum.accumulate(we + off)
    head = np.ones(len(g), dtype=bool)
    head[1:] = ws[1:] + off[1:] > runmax[:-1]
    hp = np.flatnonzero(head)
    we = np.maximum.reduceat(we, hp) if len(hp) else we
    return g[hp], b[hp], ws[hp], we


def validate_windows_batched(
    lit, corpus: np.ndarray,
    eidx_w: np.ndarray, ws: np.ndarray, we: np.ndarray, b_w: np.ndarray,
    block_starts: np.ndarray, block_ends: np.ndarray,
    block_anchored: np.ndarray, block_final: np.ndarray,
) -> Set[Record]:
    """One lockstep DFA scan over ALL patterns' windows at once, using
    the packed global tables (per-byte cost: two fancy-index gathers over
    every live window, regardless of pattern count)."""
    recs: Set[Record] = set()
    pack = _packed_validators(lit)
    if pack is None or eidx_w.size == 0:
        return recs

    from ..native import validate_windows_native

    nat = validate_windows_native(
        lit, corpus, eidx_w, ws, we, b_w,
        block_starts, block_ends, block_anchored, block_final,
    )
    if nat is not None:
        return nat

    (vid_arr, trans_all, acc_all, acce_all, b2c_all, start_g, float_g,
     shim) = pack

    ncorp = corpus.shape[0]
    m_e, m_b, m_ws, m_we = _merge_windows(eidx_w, b_w, ws, we, ncorp)
    lens = m_we - m_ws
    vids = vid_arr[m_e]
    bs = block_starts[m_b]
    be = block_ends[m_b]
    anch = (m_ws == bs) & block_anchored[m_b]

    # length buckets bound lockstep padding waste to 2x
    wmax_all = int(lens.max()) if len(lens) else 0
    lo = 0
    wcap = 16
    while lo < len(lens):
        sel = np.flatnonzero((lens > (wcap // 2 if wcap > 16 else 0))
                             & (lens <= wcap))
        lo += len(sel)
        if len(sel) == 0:
            wcap *= 2
            continue
        wmax = min(wcap, wmax_all)
        sws = m_ws[sel]
        slen = lens[sel]
        svid = vids[sel]
        win = corpus[np.minimum(sws[:, None] + np.arange(wmax)[None, :],
                                ncorp - 1)]
        states = np.where(anch[sel], start_g[svid], float_g[svid])
        cls = b2c_all[svid[:, None], win.astype(np.int64)]
        # native batch scan over the pre-class-mapped windows (the
        # per-byte numpy loop costs microseconds of interpreter per step)
        from .smallwrite import dfa_scan_host

        hits, states = dfa_scan_host(
            shim, cls.astype(np.uint8), slen.astype(np.int32),
            init_states=states.astype(np.int32),
        )
        for i in range(len(sel)):
            hp, hv = hits[i]
            if not len(hp):
                continue
            gi = sel[i]
            v = lit.validators[int(m_e[gi])]
            base_to = int(m_ws[gi]) + 1 - int(bs[gi])
            blen = int(be[gi]) - int(bs[gi])
            for k in range(len(hp)):
                for (eidx, adj) in v.expand_set(int(hv[k])):
                    to_local = int(hp[k]) + base_to + adj
                    if 0 <= to_local <= blen:
                        recs.add((int(m_b[gi]), eidx, to_local, 0))
        at_eod = (m_we[sel] == be[sel]) & block_final[m_b[sel]]
        eod_aids = np.where(at_eod, acce_all[states], 0)
        for i in np.flatnonzero(eod_aids).tolist():
            gi = sel[i]
            blen = int(be[gi]) - int(bs[gi])
            v = lit.validators[int(m_e[gi])]
            for (eidx, adj) in v.expand_set(int(eod_aids[i])):
                to_local = blen + adj
                if 0 <= to_local <= blen:
                    recs.add((int(m_b[gi]), eidx, to_local, 0))
        wcap *= 2
    return recs


# --------------------------------------------------------------------------
# Factor-anchored validation (kind "a<idx>" refs): a confirmed factor
# inside the pattern's fixed head pins the match start exactly; validation
# is a vectorized head-byte check plus ONE anchored suffix-DFA scan from
# the head end. Suffix automata are shared across vocabulary families
# (reference analogue: Rose zero-lag left context + suffix engines,
# src/rose/rose_graph.h LeftEngInfo; the whole-pattern validator route
# above re-scans the literal spelling per family member instead).
# --------------------------------------------------------------------------


def _aref_tables(lit):
    """Flattened anchored-ref parameters as parallel arrays (cached)."""
    if hasattr(lit, "_arefs"):
        return lit._arefs
    ars = lit.anchored_refs
    n = len(ars)
    a_eidx = np.zeros(n, np.int64)
    a_d = np.zeros(n, np.int64)
    a_H = np.zeros(n, np.int64)
    a_svid = np.zeros(n, np.int64)
    a_sfxw = np.zeros(n, np.int64)
    p_off = np.zeros(n + 1, np.int64)
    pj: List[int] = []
    pv: List[int] = []
    pm: List[int] = []
    for k, (eidx, d, H, prefix, svid, sfxw) in enumerate(ars):
        a_eidx[k], a_d[k], a_H[k] = eidx, d, H
        a_svid[k], a_sfxw[k] = svid, sfxw
        for (j, v, m) in prefix:
            pj.append(j)
            pv.append(v)
            pm.append(m)
        p_off[k + 1] = len(pj)
    lit._arefs = (
        a_eidx, a_d, a_H, a_svid, a_sfxw, p_off,
        np.asarray(pj, np.int64), np.asarray(pv, np.int64),
        np.asarray(pm, np.int64),
    )
    return lit._arefs


def _packed_sfx(lit):
    """Suffix validators packed into one global table set (cached):
    content-identical engines share a region, exactly like
    _packed_validators — but here the accept expansion takes the
    expression index from the REF, so one region serves every family
    member."""
    if hasattr(lit, "_spack"):
        return lit._spack
    engs = lit.sfx_validators
    V = len(engs)
    if V == 0:
        lit._spack = None
        return None
    cmax = max(e.trans.shape[1] for e in engs)
    tid_base: Dict[bytes, int] = {}
    tparts: List = []
    b2c_all = np.zeros((V, 256), dtype=np.int64)
    start_g = np.zeros(V, dtype=np.int64)
    total = 0
    for i, v in enumerate(engs):
        key = (v.trans.shape, v.trans.tobytes(), v.accept_id.tobytes())
        base = tid_base.get(key)
        if base is None:
            base = total
            tid_base[key] = base
            tparts.append(v)
            total += v.trans.shape[0]
        b2c_all[i] = v.byte_to_class
        start_g[i] = base + v.start_state
    trans_all = np.zeros((total, cmax), dtype=np.int64)
    acc_all = np.zeros(total, dtype=np.int64)
    base = 0
    for v in tparts:
        S, C = v.trans.shape
        trans_all[base : base + S, :C] = v.trans.astype(np.int64) + base
        acc_all[base : base + S] = v.accept_id
        base += S
    import types

    shim = types.SimpleNamespace(
        trans=trans_all.astype(np.int32),
        byte_to_class=np.arange(256, dtype=np.int32),
        accept_id=acc_all.astype(np.int32),
    )
    lit._spack = (b2c_all, start_g, shim)
    return lit._spack


def _validate_anchored(
    lit, corpus: np.ndarray, aidx: np.ndarray, fe: np.ndarray,
    b_w: np.ndarray, bs_w: np.ndarray, be_w: np.ndarray,
    block_final: np.ndarray,
) -> Set[Record]:
    """Validate anchored refs: head byte checks, then one anchored
    suffix scan per surviving candidate. `fe` is the exclusive factor
    end; the match start is fe - d and the suffix scan starts at the
    head end (fe + (H - d))."""
    recs: Set[Record] = set()
    if aidx.size == 0:
        return recs
    (a_eidx, a_d, a_H, a_svid, a_sfxw, p_off, pj, pv, pm) = \
        _aref_tables(lit)
    ncorp = corpus.shape[0]
    d = a_d[aidx]
    H = a_H[aidx]
    s = fe - d  # match start (absolute)
    # the whole head must lie inside the block
    valid = (s >= bs_w) & (s + H <= be_w)
    # vectorized head-byte checks (factor bytes were exactly verified)
    cnt = p_off[aidx + 1] - p_off[aidx]
    total = int(cnt.sum())
    if total:
        rep = np.repeat(np.arange(len(aidx)), cnt)
        within = np.arange(total) - np.repeat(np.cumsum(cnt) - cnt, cnt)
        fl = p_off[aidx][rep] + within
        pos = s[rep] + pj[fl]
        byte = corpus[np.minimum(np.maximum(pos, 0), ncorp - 1)]
        okb = ((byte & pm[fl]) == pv[fl]) & (pos >= 0) & (pos < ncorp)
        fails = np.bincount(rep, weights=(~okb).astype(np.int64),
                            minlength=len(aidx)) > 0
        valid &= ~fails
    sel = np.flatnonzero(valid)
    if sel.size == 0:
        return recs
    # empty suffix: the match IS the head
    svid = a_svid[aidx[sel]]
    emp = svid < 0
    for i in np.flatnonzero(emp).tolist():
        g = sel[i]
        recs.add((int(b_w[g]), int(a_eidx[aidx[g]]),
                  int(s[g] + H[g] - bs_w[g]), 0))
    # suffix scans, deduped per (svid, start, block, eidx)
    sub = sel[~emp]
    if sub.size == 0:
        return recs
    pack = _packed_sfx(lit)
    b2c_all, start_g, shim = pack
    starts = s[sub] + H[sub]
    lens = np.minimum(be_w[sub] - starts, a_sfxw[aidx[sub]])
    key = np.stack([a_svid[aidx[sub]], starts, b_w[sub],
                    a_eidx[aidx[sub]]], axis=1)
    _, first = np.unique(key, axis=0, return_index=True)
    sub = sub[first]
    starts = starts[first]
    lens = lens[first]
    svid = a_svid[aidx[sub]]
    eidx_w = a_eidx[aidx[sub]]
    # the suffix is non-vacuous by construction, so a zero-length window
    # (the head ends exactly at the block boundary) cannot match
    keep = lens >= 1
    sub, starts, lens = sub[keep], starts[keep], lens[keep]
    svid, eidx_w = svid[keep], eidx_w[keep]
    if starts.size == 0:
        return recs
    from .smallwrite import dfa_scan_host

    # length buckets bound lockstep padding waste to 2x
    lmax_all = int(lens.max())
    wcap, lo = 16, 0
    while lo < lmax_all:
        pick = np.flatnonzero((lens > lo) & (lens <= wcap))
        if len(pick) == 0:
            lo = wcap
            wcap *= 2
            continue
        wmax = min(wcap, lmax_all)
        sws = starts[pick]
        win = corpus[np.minimum(sws[:, None] + np.arange(wmax)[None, :],
                                ncorp - 1)]
        sv = svid[pick]
        cls = b2c_all[sv[:, None], win.astype(np.int64)]
        states = start_g[sv]
        hits, _st = dfa_scan_host(
            shim, cls.astype(np.uint8), lens[pick].astype(np.int32),
            init_states=states.astype(np.int32),
        )
        for i in range(len(pick)):
            hp, hv = hits[i]
            if not len(hp):
                continue
            gi = pick[i]
            g = sub[gi]
            v = lit.sfx_validators[int(svid[gi])]
            e_r = int(eidx_w[gi])
            base_to = int(starts[gi]) + 1 - int(bs_w[g])
            blen = int(be_w[g]) - int(bs_w[g])
            for k in range(len(hp)):
                for (_e, adj) in v.expand_set(int(hv[k])):
                    to_local = int(hp[k]) + base_to + adj
                    if 0 <= to_local <= blen:
                        recs.add((int(b_w[g]), e_r, to_local, 0))
        lo = wcap
        wcap *= 2
    return recs


# --------------------------------------------------------------------------
# Chain resolution: SEG0 <gap> SEG1 <gap> ... (reference: the Rose role
# graph runtime — literal hits trigger prefix/infix/suffix engine checks,
# src/rose/match.c + catchup; here roles resolve left to right with a
# vectorized gap-run check between consecutive boundaries)
# --------------------------------------------------------------------------


def _lastbad(corpus: np.ndarray, gap_bits: np.ndarray, cache: Dict) -> np.ndarray:
    """lastbad[i] = last index <= i whose byte is NOT in the gap class
    (-1 if none): bytes [p, s) are all in-class iff p > lastbad[s-1]."""
    key = (0, gap_bits.tobytes())
    if key not in cache:
        idx = np.arange(corpus.shape[0], dtype=np.int64)
        bad = ~gap_bits[corpus]
        cache[key] = np.maximum.accumulate(np.where(bad, idx, -1))
    return cache[key]


def _firstbad(corpus: np.ndarray, gap_bits: np.ndarray, cache: Dict) -> np.ndarray:
    """firstbad[i] = first index >= i whose byte is NOT in the gap class
    (n if none): bytes [p, e) are all in-class iff e <= firstbad[p]."""
    key = (1, gap_bits.tobytes())
    if key not in cache:
        n = corpus.shape[0]
        idx = np.arange(n, dtype=np.int64)
        bad = ~gap_bits[corpus]
        cache[key] = np.minimum.accumulate(
            np.where(bad, idx, n)[::-1]
        )[::-1]
    return cache[key]


# chain_ctx boundary key for the leading-gap run (streaming carried state)
LEAD_BOUNDARY = -1


def chain_ctx_record(lit, eidx: int, r: int, c_ends, c_run, base_abs):
    """Build one streaming chain_ctx value from carried chain_state.

    General-infix boundaries carry the infix NFA mask at c_ends[0] — an
    arbitrary-width Python int (multi-word infixes exceed int64;
    np.asarray on it raises OverflowError, found by the collider at a
    fresh seed) — so their evidence stays a Python list; class-gap
    boundaries pack to int64 arrays for the vectorized merge."""
    ch = lit.chains.get(eidx)
    if ch is not None and getattr(ch, "infix", None) \
            and r in ch.infix:
        return (list(c_ends), c_run, base_abs)
    return (np.asarray(c_ends, dtype=np.int64), c_run, base_abs)


def _ints_from_words(a: np.ndarray) -> list:
    """Combine a trailing little-endian uint64 word axis into Python
    ints (one per leading row). 1-D input is the legacy single-word
    layout of round-3 databases."""
    a = np.asarray(a).astype(np.uint64)
    if a.ndim == 1:
        return a.tolist()
    flat = a.reshape(-1, a.shape[-1])
    out = flat[:, 0].tolist()
    for w in range(1, flat.shape[1]):
        out = [x | (y << (64 * w)) for x, y in zip(out, flat[:, w].tolist())]
    return out


def _infix_tables(spec):
    """Python-int step tables cached on the spec (per-byte stepping in
    the injection scan runs on host ints, not numpy scalars — and
    Python ints make the scan width-agnostic: multi-word infix masks
    assemble into one arbitrary-precision value here)."""
    if not hasattr(spec, "_pyt"):
        co = spec.chunk_or
        if co.ndim == 2:  # legacy [nck, 256] single-word tables
            chunks = [row.tolist() for row in co]
        else:  # [nck, 256, Wn]
            chunks = [_ints_from_words(row) for row in co]
        spec._pyt = (
            chunks,
            _ints_from_words(spec.reach),
            int(spec.start),
            int(spec.accept),
        )
    return spec._pyt


def _infix_connect(spec, corpus, E, S, block_end: int,
                   init_mask: int = 0, init_pos: int = 0,
                   capture_at: int = None):
    """Forward injection scan of a general-gap NFA: start states are
    injected at every previous-role end in E, accept liveness is read at
    every candidate next-role start in S; returns (connected subset of
    S, mask at `capture_at`). Exact: mask at position p holds the union
    of all live part-scans data[e:p) over injected e (reference:
    triggered infix engine execution, src/rose/infix.h; monotone in the
    injection set). Bytes are only consumed while some state is live —
    gaps that die fast (the common case) cost a handful of steps per
    injection.

    Streaming: `init_mask` is the carried NFA state valid at `init_pos`
    (the extent start), and `capture_at` asks for the evolved mask at
    that position (the next write's extent start) — the O(1) carried
    infix stream state (reference analogue: LeftEngInfo infix stream
    state, rose_graph.h:140)."""
    chunks, reach, start, accept = _infix_tables(spec)
    conn = set()
    E_l = [int(x) for x in E]
    S_set = set(int(x) for x in S)
    if spec.nullable:
        conn |= set(E_l) & S_set
    if (init_mask & accept) and init_pos in S_set:
        # the carried mask is accept-live AT the extent start: a span
        # ending exactly there connects a role start at that position
        # (the history-cut boundary — older ends live only in the mask)
        conn.add(init_pos)
    s_max = min(int(S[-1]), block_end) if len(S) else init_pos
    scan_to = s_max if capture_at is None else max(s_max, capture_at)
    scan_to = min(scan_to, block_end)
    i_e = 0
    mask = init_mask
    p = init_pos
    cap_mask = 0
    captured = capture_at is None
    if not captured and p >= capture_at:
        cap_mask = init_mask
        captured = True
    n_ck = len(chunks)
    while True:
        if mask == 0:
            # dead: jump to the next injection (bytes between are free)
            if i_e >= len(E_l) or E_l[i_e] >= scan_to:
                break
            nxt = max(p, E_l[i_e])
            if not captured and nxt >= capture_at:
                captured = True  # dead through the capture point
            p = nxt
        while i_e < len(E_l) and E_l[i_e] == p:
            mask |= start
            i_e += 1
        if not captured and p == capture_at:
            cap_mask = mask
            captured = True
        if p >= scan_to:
            break
        # step: follow-union of live positions, masked by byte reach
        f = 0
        m = mask
        k = 0
        while m and k < n_ck:
            f |= chunks[k][m & 255]
            m >>= 8
            k += 1
        mask = f & reach[corpus[p]]
        p += 1
        if (mask & accept) and p in S_set:
            conn.add(p)
        if not captured and p == capture_at:
            cap_mask = mask
            captured = True
    return conn, cap_mask


def lit_history_required(lit) -> int:
    """History bytes needed so candidates, confirm bytes and windows of
    matches ending in a new chunk stay inside history+chunk (reference:
    RoseEngine historyRequired). Cached per lit table set."""
    if hasattr(lit, "_hist_req"):
        return lit._hist_req
    h = 0
    for fid, refs in enumerate(lit.factor_refs):
        flen = len(lit.factor_atoms[fid])
        for (_e, max_s2f, max_f2e, _le) in refs:
            h = max(h, max_f2e + max(max_s2f + WINDOW_SLACK, flen) + 2)
    lit._hist_req = h
    return h


# boundary kinds: the gap a role's start connects through
_B_NONE = 0   # role 0 without a leading gap (anchoring kept)
_B_LEAD = 1   # role 0 after a leading gap-class run
_B_CLASS = 2  # a single-class gap after role r-1
_B_INFIX = 3  # a general-gap infix NFA after role r-1

# carried evidence older than the extent lies at negative offsets from
# its start; they are clamped to -_OLD_SPAN (every query bound lies
# above it: gap bounds are small and ends below the run start are
# dropped first)
_OLD_SPAN = np.int64(1 << 40)


@dataclasses.dataclass
class _RolePack:
    """Every chain role of a literal table set, packed (see
    _packed_roles). Role ids k run over the chains in expression order,
    roles left to right."""

    rbase: np.ndarray   # [max_e+1] role id of a chain's role 0, else -1
    nroles: np.ndarray  # [max_e+1] a chain's role count, else 0
    role_e: np.ndarray  # [K] expression of each role
    role_r: np.ndarray  # [K] index of each role within its chain
    bkind: np.ndarray   # [K] _B_* kind of the gap before each role
    bgap: np.ndarray    # [K] class (index into gaps) of a lead or class gap
    glo: np.ndarray     # [K] that gap's least length
    ghi: np.ndarray     # [K] its greatest, -1 = unbounded
    fb2c: np.ndarray    # [K, 256] uint8 byte classes of the forward DFA
    rb2c: np.ndarray    # [K, 256] uint8 byte classes of the reverse DFA
    fstart: np.ndarray  # [K] global anchored start of the forward DFA
    ffloat: np.ndarray  # [K] global float state of the forward DFA
    rstart: np.ndarray  # [K] global start of the reverse DFA, -1 = none
    tgap: np.ndarray    # [max_e+1] trailing-gap class, -1 = none
    tlo: np.ndarray     # [max_e+1] trailing gap's least length
    thi: np.ndarray     # [max_e+1] its greatest, -1 = unbounded
    gaps: List[np.ndarray]  # distinct gap classes, [256] bool each
    infix: Set[Tuple[int, int]]  # (expression, boundary) of infix gaps
    shim: object        # packed tables for dfa_scan_host
    set_off: np.ndarray  # [sets+1] global accept sets ...
    set_adj: np.ndarray  # ... as adjusts alone (a role reports its chain)


def _packed_roles(lit) -> "_RolePack":
    """Every chain role's forward and reverse DFA packed into one global
    table set (cached on `lit`, as _packed_validators packs the
    validators), so that the roles of all chain expressions advance in
    one lockstep scan per pass. Content-identical DFAs share a region;
    accept sets keep only their adjusts, since a role reports its own
    chain. Reference analogue: the Rose role graph's engines
    (rose_graph.h), here table-packed across expressions."""
    if hasattr(lit, "_rpack"):
        return lit._rpack
    eids = sorted(lit.chains)
    max_e = eids[-1] if eids else -1
    K = sum(lit.chains[e].num_roles for e in eids)
    i64 = np.int64
    rbase = np.full(max_e + 1, -1, i64)
    nroles = np.zeros(max_e + 1, i64)
    tgap = np.full(max_e + 1, -1, i64)
    tlo = np.zeros(max_e + 1, i64)
    thi = np.full(max_e + 1, -1, i64)
    role_e, role_r, bkind = (np.zeros(K, i64) for _ in range(3))
    bgap = np.full(K, -1, i64)
    glo = np.zeros(K, i64)
    ghi = np.full(K, -1, i64)
    fb2c = np.zeros((K, 256), np.uint8)
    rb2c = np.zeros((K, 256), np.uint8)
    fstart, ffloat = np.zeros(K, i64), np.zeros(K, i64)
    rstart = np.full(K, -1, i64)
    gap_ids: Dict[bytes, int] = {}
    gaps: List[np.ndarray] = []
    infix: Set[Tuple[int, int]] = set()
    regions: Dict[tuple, int] = {}
    parts: List = []
    nstates = 0

    def gap_id(bits) -> int:
        key = np.asarray(bits, bool).tobytes()
        if key not in gap_ids:
            gap_ids[key] = len(gaps)
            gaps.append(np.asarray(bits, bool))
        return gap_ids[key]

    def place(eng) -> int:
        nonlocal nstates
        key = (eng.trans.shape, eng.trans.tobytes(),
               eng.accept_id.tobytes(), eng.set_offsets.tobytes(),
               eng.set_adjusts.tobytes())
        base = regions.get(key)
        if base is None:
            base = regions[key] = nstates
            parts.append(eng)
            nstates += eng.trans.shape[0]
        return base

    k = 0
    for e in eids:
        ch = lit.chains[e]
        rbase[e] = k
        nroles[e] = ch.num_roles
        inf = getattr(ch, "infix", None) or {}
        infix |= {(e, int(bnd)) for bnd in inf}
        if ch.trail is not None:
            gi, lo, hi = ch.trail
            tgap[e], tlo[e] = gap_id(ch.gap_bits[gi]), lo
            thi[e] = -1 if hi is None else hi
        for r, role in enumerate(ch.roles):
            role_e[k], role_r[k] = e, r
            if r == 0 and ch.lead is not None:
                gi, lo, _hi = ch.lead  # a bounded hi adds no constraint
                bkind[k], glo[k] = _B_LEAD, lo
                bgap[k] = gap_id(ch.gap_bits[gi])
            elif r == 0:
                bkind[k] = _B_NONE
            elif (r - 1) in inf:
                bkind[k] = _B_INFIX
            else:
                bkind[k] = _B_CLASS
                bgap[k] = gap_id(ch.gap_bits[r - 1])
                glo[k] = ch.gap_lo[r - 1]
                hi = ch.gap_hi[r - 1]
                ghi[k] = -1 if hi is None else hi
            base = place(role.fwd)
            fb2c[k] = role.fwd.byte_to_class
            fstart[k] = base + role.fwd.start_state
            ffloat[k] = base + role.fwd.float_state
            if role.rev is not None:
                base = place(role.rev)
                rb2c[k] = role.rev.byte_to_class
                rstart[k] = base + role.rev.start_state
            k += 1
    cmax = max((p.trans.shape[1] for p in parts), default=1)
    trans = np.zeros((nstates, cmax), np.int32)
    acc = np.zeros(nstates, np.int32)
    offs: List[np.ndarray] = []
    adjs: List[np.ndarray] = [np.zeros(0, i64)]
    base = nsets = nadj = 0
    for p in parts:
        S, C = p.trans.shape
        trans[base:base + S, :C] = p.trans + base
        acc[base:base + S] = np.where(p.accept_id > 0,
                                      p.accept_id + nsets, 0)
        so = p.set_offsets.astype(i64)
        offs.append(so[:-1] + nadj)
        adjs.append(p.set_adjusts.astype(i64))
        base += S
        nsets += len(so) - 1
        nadj += int(so[-1])
    import types

    shim = types.SimpleNamespace(
        trans=trans, byte_to_class=np.arange(256, dtype=np.int32),
        accept_id=acc,
    )
    lit._rpack = _RolePack(
        rbase=rbase, nroles=nroles, role_e=role_e, role_r=role_r,
        bkind=bkind, bgap=bgap, glo=glo, ghi=ghi, fb2c=fb2c, rb2c=rb2c,
        fstart=fstart, ffloat=ffloat, rstart=rstart, tgap=tgap, tlo=tlo,
        thi=thi, gaps=gaps, infix=infix, shim=shim,
        set_off=np.concatenate(offs + [np.asarray([nadj], i64)]),
        set_adj=np.concatenate(adjs),
    )
    return lit._rpack


def _scan_rows(pk: _RolePack, b2c: np.ndarray, corpus: np.ndarray,
               k: np.ndarray, pos0: np.ndarray, lens: np.ndarray,
               init: np.ndarray, reverse: bool):
    """One packed pass: row i steps role k[i]'s DFA (classes b2c[k[i]])
    from global state init[i] over lens[i] corpus bytes from pos0[i],
    forwards, or backwards when `reverse`. Returns the accepts as flat
    (row, step, set id) arrays. Rows reach the native scan in length
    buckets, so padding is at most 2x."""
    from .smallwrite import dfa_scan_host

    count("chain_passes")
    ncorp = corpus.shape[0]
    out = []
    lmax = int(lens.max()) if len(lens) else 0
    lo, cap = 0, 16
    while lo < lmax:
        sel = np.flatnonzero((lens > lo) & (lens <= cap))
        if len(sel):
            off = np.arange(min(cap, lmax))
            idx = pos0[sel, None] + (-off if reverse else off)
            cls = b2c[k[sel, None], corpus[np.clip(idx, 0, ncorp - 1)]]
            (hr, hp, ha), _st = dfa_scan_host(
                pk.shim, cls, lens[sel].astype(np.int32),
                init_states=init[sel].astype(np.int32), flat=True,
            )
            out.append((sel[hr], hp, ha))
        lo, cap = cap, cap * 2
    if not out:
        z = np.zeros(0, np.int64)
        return z, z, z
    return tuple(np.concatenate(c) for c in zip(*out))


def _expand(pk: _RolePack, aid: np.ndarray):
    """Members of the accept sets `aid`: (index into aid, adjust)."""
    lo = pk.set_off[aid]
    cnt = pk.set_off[aid + 1] - lo
    rep = np.repeat(np.arange(len(aid)), cnt)
    idx = np.repeat(lo - (np.cumsum(cnt) - cnt), cnt) + np.arange(len(rep))
    return rep, pk.set_adj[idx]


def _sorted_unique(e, b, p):
    """(e, b, p) rows sorted, duplicates dropped."""
    o = np.lexsort((p, b, e))
    e, b, p = e[o], b[o], p[o]
    keep = np.ones(len(e), bool)
    keep[1:] = (e[1:] != e[:-1]) | (b[1:] != b[:-1]) | (p[1:] != p[:-1])
    return e[keep], b[keep], p[keep]


def _runs(e, b):
    """Start and end indices of the runs of equal (e, b) rows."""
    new = np.ones(len(e), bool)
    new[1:] = (e[1:] != e[:-1]) | (b[1:] != b[:-1])
    st = np.flatnonzero(new)
    return st, np.append(st[1:], len(e))


def _group_ids(nb: int, *ebs):
    """Compact joint ids of (expression, block) keys, ordered as the
    keys: one array of ids per (e, b) pair of arrays given."""
    keys = [e * nb + b for (e, b) in ebs]
    _u, inv = np.unique(np.concatenate(keys), return_inverse=True)
    out, at = [], 0
    for key in keys:
        out.append(inv[at:at + len(key)].astype(np.int64))
        at += len(key)
    return out


def _any_in(g, v, qg, lo, hi, span):
    """Whether group qg holds a value of v in [lo, hi]: (g, v) sorted,
    every v, lo and hi inside [0, span) where lo <= hi."""
    codes = g * span + v
    return (np.searchsorted(codes, qg * span + hi, side="right")
            > np.searchsorted(codes, qg * span + lo, side="left"))


def _prev_bad(pk, corpus, s, gap, cache):
    """For starts s with gap classes `gap`: the last offset before s
    whose byte is out of the class (-1 if none)."""
    out = np.full(len(s), -1, np.int64)
    for g in np.unique(gap).tolist():
        m = gap == g
        lb = _lastbad(corpus, pk.gaps[g], cache)
        sm = s[m]
        out[m] = np.where(sm > 0, lb[np.maximum(sm - 1, 0)], -1)
    return out


class _Carried:
    """A write's carried chain context (streaming), split once by
    boundary kind: leading-run floors, infix records and class-run end
    evidence as flat rows."""

    def __init__(self, pk: _RolePack, chain_ctx, block_starts):
        nb = len(block_starts)
        ne = len(pk.nroles)
        lead_eb: List[int] = []
        lead_floor: List[int] = []
        self.infix: Dict[Tuple[int, int], Dict[int, tuple]] = {}
        meta: List[Tuple[int, int, int, int, int]] = []
        vals: List[np.ndarray] = []
        for (b, e, bnd), rec in (chain_ctx or {}).items():
            if e >= ne or not pk.nroles[e]:
                continue
            if bnd == LEAD_BOUNDARY:
                _c, c_run, base_abs = rec
                lead_eb.append(e * nb + b)
                lead_floor.append(int(block_starts[b])
                                  - (base_abs - int(c_run)))
            elif (e, bnd) in pk.infix:
                self.infix.setdefault((e, bnd), {})[b] = rec
            else:
                arr = np.asarray(rec[0], dtype=np.int64)
                if len(arr):
                    meta.append((e, bnd, b, int(rec[1]), int(rec[2])))
                    vals.append(arr)
        o = np.argsort(np.asarray(lead_eb, np.int64), kind="stable")
        self.lead_eb = np.asarray(lead_eb, np.int64)[o]
        self.lead_floor = np.asarray(lead_floor, np.int64)[o]
        m = np.asarray(meta, np.int64).reshape(-1, 5)
        cnt = np.asarray([len(v) for v in vals], np.int64)
        # one row per carried end: e, boundary, block, end, run, base
        self.ce, self.cbnd, self.cb = (np.repeat(m[:, i], cnt)
                                       for i in range(3))
        self.crun = np.repeat(m[:, 3], cnt)
        self.cbase = np.repeat(m[:, 4], cnt)
        self.cabs = np.concatenate(vals) if vals else np.zeros(0, np.int64)

    def floors(self, eb: np.ndarray, default: np.ndarray) -> np.ndarray:
        """Flat lower bound of a leading run carried into each (e, b)."""
        if not len(self.lead_eb):
            return default
        i = np.minimum(np.searchsorted(self.lead_eb, eb),
                       len(self.lead_eb) - 1)
        return np.where(self.lead_eb[i] == eb, self.lead_floor[i], default)

    def split(self, bnd_of_e: np.ndarray, block_starts: np.ndarray):
        """Class-run evidence of the boundary bnd_of_e[e] of each chain
        (-1 = none): its ends inside the extent in flat offsets (e, b,
        pos), and the older ones that may still connect (e, b, end, run,
        base), sorted by (e, b, end)."""
        sel = bnd_of_e[self.ce] == self.cbnd
        ce, cb, ca = self.ce[sel], self.cb[sel], self.cabs[sel]
        crun, cbase = self.crun[sel], self.cbase[sel]
        inx = ca >= cbase
        new = (ce[inx], cb[inx], ca[inx] - cbase[inx] + block_starts[cb[inx]])
        old = ~inx & (ca >= crun)
        o = np.lexsort((ca[old], cb[old], ce[old]))
        older = tuple(a[old][o] for a in (ce, cb, ca, crun, cbase))
        return new, older


def _trail_ranges(pk, corpus, e, b, e0, run_end, block_starts, block_ends):
    """Trailing-gap match ranges (MPV-puff analogue): every offset that
    the gap-class run after a final-role end e0 covers within the gap's
    bounds, the run ending at run_end. Overlapping and adjacent ranges of
    one (e, b) coalesce. Returns (e, b, lo, hi) flat, sorted."""
    bs, be = block_starts[b], block_ends[b]
    hi = np.minimum(run_end, be)
    bounded = pk.thi[e] >= 0
    hi = np.where(bounded, np.minimum(hi, e0 + pk.thi[e]), hi)
    lo = np.maximum(e0 + pk.tlo[e], bs)
    ok = hi >= lo
    e, b, lo, hi = e[ok], b[ok], lo[ok], hi[ok]
    if not len(e):
        return e, b, lo, hi
    o = np.lexsort((hi, lo, b, e))
    e, b, lo, hi = e[o], b[o], lo[o], hi[o]
    span = np.int64(corpus.shape[0] + 2)
    (g,) = _group_ids(len(block_starts), (e, b))
    runmax = np.maximum.accumulate(g * span + hi)
    head = np.ones(len(e), bool)
    head[1:] = g[1:] * span + lo[1:] > runmax[:-1] + 1
    hp = np.flatnonzero(head)
    return e[hp], b[hp], lo[hp], np.maximum.reduceat(hi, hp)


def _next_bad(pk, corpus, p, gap, cache):
    """For offsets p with gap classes `gap`: the first offset at or
    after p whose byte is out of the class (p itself past the corpus)."""
    n = corpus.shape[0]
    out = p.copy()
    for g in np.unique(gap).tolist():
        m = (gap == g) & (p < n)
        if m.any():
            out[m] = _firstbad(corpus, pk.gaps[g], cache)[p[m]]
    return out


def _trail(pk, corpus, r, fin, carried, trail_e, block_starts, block_ends,
           cache, ranges_out, recs) -> None:
    """Trailing gaps of the chains whose final role is r (`trail_e`):
    final-role ends `fin` and the pending ends carried from earlier
    writes fire every offset their gap-class run covers."""
    if not trail_e.any():
        return
    new, older = carried.split(np.where(trail_e, r, -1), block_starts)
    e, b, e0 = _sorted_unique(*(np.concatenate([a, n])
                                for a, n in zip(fin, new)))
    run = _next_bad(pk, corpus, e0, pk.tgap[e], cache)
    # pre-extent pending ends: the run is alive through the carried
    # region (pruned by its run start) into this extent's prefix
    ce, cb, ca, _crun, cbase = older
    cbs = block_starts[cb]
    e = np.concatenate([e, ce])
    b = np.concatenate([b, cb])
    e0 = np.concatenate([e0, cbs + (ca - cbase)])
    run = np.concatenate([run, _next_bad(pk, corpus, cbs, pk.tgap[ce],
                                         cache)])
    e, b, lo, hi = _trail_ranges(pk, corpus, e, b, e0, run, block_starts,
                                 block_ends)
    bs = block_starts[b]
    if ranges_out is not None:
        ranges_out.extend(zip(b.tolist(), e.tolist(), (lo - bs).tolist(),
                              (hi - bs).tolist()))
        return
    for bi, ei, l, h, s in zip(b.tolist(), e.tolist(), lo.tolist(),
                               hi.tolist(), bs.tolist()):
        recs.update((bi, ei, t - s, 0) for t in range(l, h + 1))


@spanned("hs.chains")
def resolve_chains(
    lit, corpus: np.ndarray, block_starts: np.ndarray,
    block_ends: np.ndarray, block_anchored: np.ndarray,
    block_final: np.ndarray,
    chain_windows: Tuple[np.ndarray, ...],
    chain_ctx: Dict = None, chain_out: Dict = None,
    ranges_out: List = None,
) -> Set[Record]:
    """Multi-segment chain resolution over all chain expressions at once.

    `chain_windows` = (eidx, r, ws, we, b) arrays: a candidate window of
    role r of chain eidx in block b. `chain_ctx[(b, eidx, r)]`
    (streaming) carries boundary-r end evidence as `(ends_abs,
    run_start_abs, base_abs)`; boundary LEAD_BOUNDARY carries the
    leading-gap run, boundary R-1 carries trailing-gap pending ends, an
    infix boundary its NFA mask and recent ends. `chain_out[(b, eidx,
    r)]` receives this write's flat boundary ends for the state update
    (an "imask" record at an infix boundary). Trailing-gap dense match
    ends are appended to `ranges_out` as (b, eidx, lo_local, hi_local)
    when given, else expanded into the returned records.

    The role scans do not depend on the previous role's ends, so they
    run as two packed passes over every active (expression, role): a
    forward pass over the merged windows (role matches; role 0 keeps its
    anchoring) and a reverse pass from every match end of a role that
    connects through a gap (role starts). The connection then runs role
    position by role position, vectorized across expressions by
    (expression, block) keys; an infix gap runs its injection scan per
    (expression, block).
    """
    recs: Set[Record] = set()
    pk = _packed_roles(lit)
    streaming = chain_out is not None
    nb = len(block_starts)
    w_e, w_r, w_s, w_t, w_b = (np.asarray(a, np.int64)
                               for a in chain_windows)
    ne = len(pk.nroles)
    chain = w_e < ne
    chain[chain] = pk.nroles[w_e[chain]] > 0
    w_e, w_r, w_s, w_t, w_b = (a[chain] for a in (w_e, w_r, w_s, w_t, w_b))
    carried = _Carried(pk, chain_ctx, block_starts)
    active = set(np.unique(w_e).tolist())
    if chain_ctx:
        active |= {e for (_b, e, _r) in chain_ctx
                   if e < ne and pk.nroles[e]}
    if not streaming:  # a final role without windows can't match
        active &= set(np.unique(w_e[w_r == pk.nroles[w_e] - 1]).tolist())
    count("chain_exprs", len(active))
    if not active:
        return recs
    act = np.zeros(ne, bool)
    act[list(active)] = True
    keep = act[w_e]
    w_k = pk.rbase[w_e[keep]] + w_r[keep]
    w_s, w_t, w_b = w_s[keep], w_t[keep], w_b[keep]

    m_k, m_b, m_s, m_t = _merge_windows(w_k, w_b, w_s, w_t, corpus.shape[0])
    m_bs = block_starts[m_b]

    # pass 1: every role's matches (accept pairs: window row, byte index)
    kind = pk.bkind[m_k]
    init = np.where((kind == _B_NONE) & (m_s == m_bs) & block_anchored[m_b],
                    pk.fstart[m_k], pk.ffloat[m_k])
    f_row, f_t, f_aid = (_scan_rows(pk, pk.fb2c, corpus, m_k, m_s,
                                    m_t - m_s, init, reverse=False)
                         if len(m_k) else (np.zeros(0, np.int64),) * 3)
    f_k = m_k[f_row]
    f_e, f_r, f_b = pk.role_e[f_k], pk.role_r[f_k], m_b[f_row]
    f_end = m_s[f_row] + f_t  # flat offset of the match's last byte

    # pass 2: every start of each match of a role after a gap
    pair = np.flatnonzero(pk.bkind[f_k] != _B_NONE)
    if len(pair):
        r_row, r_step, r_aid = _scan_rows(
            pk, pk.rb2c, corpus, f_k[pair], f_end[pair], f_t[pair] + 1,
            pk.rstart[f_k[pair]], reverse=True)
        rep, adj = _expand(pk, r_aid)
        s_pair = pair[r_row[rep]]  # index into the f_* arrays
        s_pos = f_end[s_pair] - r_step[rep] + adj
    else:
        s_pair = s_pos = np.zeros(0, np.int64)
    s_e, s_r, s_b = f_e[s_pair], f_r[s_pair], f_b[s_pair]

    def ends_of(hits):
        """Flat ends (e, b, pos) of the matches f_*[hits], sorted."""
        rep, adj = _expand(pk, f_aid[hits])
        h = hits[rep]
        pos = f_end[h] + 1 + adj
        b = f_b[h]
        ok = (pos >= block_starts[b]) & (pos <= block_ends[b])
        return _sorted_unique(f_e[h][ok], b[ok], pos[ok])

    def write_out(ends, r):
        e, b, p = ends
        st, en = _runs(e, b)
        for i, j in zip(st.tolist(), en.tolist()):
            chain_out[(int(b[i]), int(e[i]), r)] = p[i:j]

    lastbad_cache: Dict = {}
    hist_req = lit_history_required(lit) if streaming else None
    conn = np.zeros(len(f_e), bool)  # match connected to its left context
    z = np.zeros(0, np.int64)
    ends = (z, z, z)
    R = pk.nroles
    for r in range(int(R[act].max())):
        at_r = np.flatnonzero(f_r == r)
        if r == 0:
            conn[at_r[pk.bkind[f_k[at_r]] == _B_NONE]] = True
            sel = np.flatnonzero(
                (s_r == 0) & (pk.bkind[pk.rbase[s_e]] == _B_LEAD))
            if len(sel):
                # leading gap: a class run of length >= lo right before
                # the start (Castle-prefix analogue)
                s, b, e = s_pos[sel], s_b[sel], s_e[sel]
                k = pk.rbase[e]
                bs = block_starts[b]
                prevb = _prev_bad(pk, corpus, s, pk.bgap[k], lastbad_cache)
                floor = carried.floors(e * nb + b, bs)
                run_start = np.where(prevb >= bs, prevb + 1, floor)
                conn[s_pair[sel[(s - run_start) >= pk.glo[k]]]] = True
        else:
            ekind = np.zeros(ne, np.int64)
            live = R > r
            ekind[live] = pk.bkind[pk.rbase[live] + r]
            starts = (s_e, s_b, s_pos, s_r, s_pair)
            _connect_class(pk, corpus, r, ekind, ends, carried, starts,
                           conn, block_starts, lastbad_cache)
            _connect_infix(lit, r, ekind, ends, carried, starts, conn,
                           corpus, block_starts, block_ends, hist_req,
                           chain_out)
        ends = ends_of(at_r[conn[at_r]])
        final = R[ends[0]] == r + 1
        fin = tuple(a[final] for a in ends)
        ends = tuple(a[~final] for a in ends)
        trail = pk.tgap[fin[0]] >= 0
        if streaming:
            # boundary r: mid-gap ends, or pending trailing-gap ends
            write_out(ends, r)
            write_out(tuple(a[trail] for a in fin), r)
        # final-role ends -> match reports
        fe, fb, fp = (a[~trail] for a in fin)
        recs.update(zip(fb.tolist(), fe.tolist(),
                        (fp - block_starts[fb]).tolist(),
                        itertools.repeat(0)))
        _trail(pk, corpus, r, tuple(a[trail] for a in fin), carried,
               act & (R == r + 1) & (pk.tgap >= 0), block_starts,
               block_ends, lastbad_cache, ranges_out, recs)
    return recs


def _connect_class(pk, corpus, r, ekind, ends, carried, starts, conn,
                   block_starts, lastbad_cache):
    """Role-r starts (`starts`: expression, block, offset, role, match)
    behind a single-class gap connect to a role r-1 end (or one carried
    from earlier writes) through an all-in-class run of the gap's
    length: marks their matches in `conn`. `ekind[e]` is the kind of
    chain e's gap before role r."""
    s_e, s_b, s_pos, s_r, s_pair = starts
    sel = np.flatnonzero((s_r == r) & (ekind[s_e] == _B_CLASS))
    bnd = np.where(ekind == _B_CLASS, r - 1, -1)
    new, older = carried.split(bnd, block_starts)
    if not len(sel):
        return
    cls = ekind[ends[0]] == _B_CLASS
    E = _sorted_unique(*(np.concatenate([a[cls], n])
                         for a, n in zip(ends, new)))
    s, b, e = s_pos[sel], s_b[sel], s_e[sel]
    k = pk.rbase[e] + r
    bs = block_starts[b]
    glo, ghi = pk.glo[k], pk.ghi[k]
    prevb = _prev_bad(pk, corpus, s, pk.bgap[k], lastbad_cache)
    p_lo = np.maximum(bs, prevb + 1)
    p_lo = np.where(ghi >= 0, np.maximum(p_lo, s - ghi), p_lo)
    p_hi = s - glo
    ok = p_hi >= p_lo
    gE, gS, gC = _group_ids(len(block_starts), (E[0], E[1]), (e, b),
                            (older[0], older[1]))
    span = np.int64(corpus.shape[0] + 2)
    hit = ok & _any_in(gE, E[2], gS, np.where(ok, p_lo, 0),
                       np.where(ok, p_hi, 0), span)
    if len(older[0]):
        # pre-extent evidence connects iff no bad byte precedes the
        # start inside the extent (pruning kept it clean up to the
        # extent start); offsets relative to the extent start
        c_rel = np.maximum(older[2] - older[4], -_OLD_SPAN) + _OLD_SPAN
        i = np.minimum(np.searchsorted(gC, gS), len(gC) - 1)
        has = gC[i] == gS
        run_rel = older[3][i] - older[4][i]
        rel = s - bs
        pl = np.where(ghi >= 0, np.maximum(run_rel, rel - ghi), run_rel)
        pl = np.maximum(pl, -_OLD_SPAN)
        ph = np.minimum(rel - glo, -1)
        okc = has & ((s == bs) | (prevb < bs)) & (ph >= pl)
        hit |= okc & _any_in(gC, c_rel, gS,
                             np.where(okc, pl + _OLD_SPAN, 0),
                             np.where(okc, ph + _OLD_SPAN, 0),
                             _OLD_SPAN + 1)
    conn[s_pair[sel[hit]]] = True


def _connect_infix(lit, r, ekind, ends, carried, starts, conn, corpus,
                   block_starts, block_ends, hist_req, chain_out):
    """Role-r starts behind a general-gap infix connect to role r-1 ends
    through the infix NFA (forward injection scan, per expression and
    block). Streaming carries the infix engine's state across writes:
    the NFA mask captured at the next extent's start plus recent end
    positions whose factor context will be trimmed out of the rescanable
    history (reference analogue: LeftEngInfo infix stream state,
    rose_graph.h:140)."""
    s_e, s_b, s_pos, s_r, s_pair = starts
    streaming = chain_out is not None
    bnd = r - 1
    sel = np.flatnonzero((s_r == r) & (ekind[s_e] == _B_INFIX))
    inf = ekind[ends[0]] == _B_INFIX
    # per (expression, block): the role r-1 ends, and the role-r starts
    # with their matches (a handful each: Python lists beat numpy here)
    E_at: Dict[Tuple[int, int], List[int]] = {}
    for e, b, p in zip(*(a[inf].tolist() for a in ends)):
        E_at.setdefault((e, b), []).append(p)
    S_at: Dict[Tuple[int, int], List[Tuple[int, int]]] = {}
    for e, b, p, i in zip(s_e[sel].tolist(), s_b[sel].tolist(),
                          s_pos[sel].tolist(), s_pair[sel].tolist()):
        S_at.setdefault((e, b), []).append((p, i))
    groups = set(E_at) | set(S_at)
    for (e, bnd_c), recs_b in carried.infix.items():
        if bnd_c == bnd and ekind[e] == _B_INFIX:
            groups |= {(e, b) for b in recs_b}
    hits: List[int] = []
    for (e, b) in sorted(groups):
        spec = lit.chains[e].infix[bnd]
        bs = int(block_starts[b])
        be = int(block_ends[b])
        E_set = set(E_at.get((e, b), ()))
        mask0 = 0
        rec = carried.infix.get((e, bnd), {}).get(b)
        if rec is not None:
            arr, _cap_abs, base_abs = rec
            # arr[0] is the carried NFA mask, an arbitrary-width Python
            # int (chain_ctx_record keeps infix records as lists)
            lst = [int(x) for x in arr]
            if lst:
                mask0 = lst[0]
                E_set |= {bs + (x - base_abs) for x in lst[1:]}
        starts = S_at.get((e, b), [])
        if not E_set and not mask0 and not streaming:
            continue
        capture_at = max(bs, be - hist_req) if streaming else None
        ok, cap_mask = _infix_connect(
            spec, corpus, sorted(E_set), sorted({p for p, _i in starts}),
            be, init_mask=mask0, init_pos=bs, capture_at=capture_at,
        )
        if streaming:
            keeps = sorted(x for x in E_set if x >= capture_at)[-4096:]
            chain_out[(b, e, bnd)] = (
                "imask", int(cap_mask), keeps, int(capture_at))
        if ok:
            hits.extend(i for p, i in starts if p in ok)
    conn[hits] = True
