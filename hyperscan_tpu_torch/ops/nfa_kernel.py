"""Layered position-parallel bit-NFA scan on a torch device — the device
LimEx analogue.

Reference analogues: the LimEx bitvector NFA (src/nfa/limex_internal.h:
71-160) and Rose's 8/32-byte mask checks (src/rose/rose_build_add_mask.cpp,
CHECK_MASK instructions). This is the port of the JAX package's
`hyperscan_tpu/ops/nfa_kernel.py`.

A bounded-width scanning NFA is acyclic, so its activation recurrence

    A_p[t] = reach_p[x[t]] & valid[t] & (float_p | anch_p & anch[t]
                                         | OR_{u -> p} A_u[t-1])

unrolls into a sweep over the positions in topological order, each a few
bitwise operations over the whole corpus: no sequential byte loop. A
block's first byte takes no activation from the byte before it (the
reference puts one dead byte between blocks; here the blocks lie head to
head in the flat corpus and the chain is cut at each block start), and
`anch` is set only at the first byte of an anchored block. Each byte with
an accepting position active is a record (pos, OR of 1 << (g-1) over its
accept sets g); each block gets the OR of its EOD accept sets at its last
byte. A position of depth d looks back d-1 bytes, so a body scanned after
a halo of at least max_depth - 1 bytes is exact.

One kernel covers every eligible engine: `nfa_layered`
(csrc/nfa_layered.cu, kernel D) takes the engine's plan as small
tensors, so no build per database is needed: a program of one record a
position (`kernel_program`: class, flags, predecessors in a register or
in slots allotted by liveness, accept groups) and a byte -> class
membership table (`membership_words`, from the class bitmaps `lut` that
the plain version reads). The JAX package unrolls the engine into the
traced program instead: a Pallas kernel for P <= 48 and an XLA sweep
(`_make_scan_fn`) for the rest. The wrapper launches the kernel for a
CUDA tensor and counts the launch in `LAUNCHES`; for a CPU tensor it runs
the plain PyTorch version `nfa_layered_plain`, which is also what the
kernel is held against on the card.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from ..trace import count
from ._build import LAUNCHES
from .teddy import (_check_corpus, _p2, get_capacity_hint,
                    set_capacity_hint, upload_blocks)

MAX_NFA_DEPTH = 1024  # halo bound
MAX_NFA_POSITIONS = 512
MAX_NFA_RANGES = 1024
MAX_DEVICE_SETS = 31  # accept-set bitmasks must fit int32
WORD = 32  # bytes per kernel word (one bit each)
# bytes of plane memory the plain version holds per tile
_PLAIN_TILE_BUDGET = 1 << 28

# bit fields of one position's packed info word
_CLASS_MASK = 0x3FF
_FLOAT = 1 << 10
_ANCH = 1 << 11
_GID_SHIFT = 12
_EOD_SHIFT = 17


def nfa_device_eligible(engine) -> bool:
    meta = _engine_meta(engine)
    return (
        engine.acyclic
        and engine.max_depth is not None
        and engine.max_depth <= MAX_NFA_DEPTH
        and engine.num_positions <= MAX_NFA_POSITIONS
        and engine.num_sets <= MAX_DEVICE_SETS
        and meta["total_ranges"] <= MAX_NFA_RANGES
    )


def _class_ranges(bits: np.ndarray) -> List[Tuple[int, int]]:
    """Runs of set bytes in a [256] bool class bitmap."""
    idx = np.flatnonzero(bits)
    if len(idx) == 0:
        return []
    breaks = np.flatnonzero(np.diff(idx) > 1)
    starts = np.concatenate([[idx[0]], idx[breaks + 1]])
    ends = np.concatenate([idx[breaks], [idx[-1]]])
    return [(int(a), int(b)) for a, b in zip(starts, ends)]


def _engine_meta(engine):
    """Host-side compile of the layered plan: per-position class id,
    predecessor lists, topological order, class ranges (cached on the
    engine under this package's own attribute name)."""
    if "_torch_nfa_meta" not in engine.__dict__:
        P = engine.num_positions
        # position p's byte set = {bytes b : class_reach[b2c[b], p]}
        reach = engine.class_reach  # [C, P]
        b2c = engine.byte_to_class.astype(np.int64)
        pos_bits = reach[b2c, :]  # [256, P] bool
        uniq, inv = np.unique(pos_bits.T, axis=0, return_inverse=True)
        ranges = [_class_ranges(uniq[k]) for k in range(uniq.shape[0])]
        preds: List[List[int]] = [[] for _ in range(P)]
        F = engine.follow
        for u in range(P):
            for v in np.flatnonzero(F[u]):
                preds[int(v)].append(u)
        engine._torch_nfa_meta = {
            "pos_class": inv.reshape(P),
            "ranges": ranges,
            "total_ranges": sum(len(r) for r in ranges),
            "preds": preds,
            "order": [int(p) for p in engine.topo_order],
        }
    return engine._torch_nfa_meta


def _halo(engine) -> int:
    """Look-back bytes scanned before a body: at least the deepest
    position's look-back (max_depth - 1), in whole kernel words. The
    reference rounds to 1024 so that its tiles stay a multiple of its
    extraction chunk, a TPU layout not carried over."""
    d = int(engine.max_depth)
    return max(WORD, -(-d // WORD) * WORD)


@dataclasses.dataclass
class NfaPlan:
    """The layered plan of one engine, positions renumbered by their
    topological rank (every predecessor has a lower rank)."""

    halo: int
    # on the host, for the plain version's control flow
    info_np: np.ndarray  # [P] int32 packed: class | flags | gid | eod gid
    preds: List[List[int]]
    lut: torch.Tensor  # [K, 256] bool, the class bitmaps as lookups
    # kernel D's form of the plan (`kernel_program`)
    prog: torch.Tensor  # [P, 4] int32, one record a position
    extra: torch.Tensor  # [X] int32, slot predecessors past two
    gvals: torch.Tensor  # [2 * MAX_DEVICE_SETS] int32, group -> bit
    mem: torch.Tensor  # [ceil(K / 32), 256] int32, byte -> classes
    slots: int  # live words a thread keeps besides r - 1's
    groups: Tuple[int, int]  # distinct accept and EOD accept sets

    @property
    def P(self) -> int:
        return int(self.info_np.shape[0])

    @property
    def K(self) -> int:
        return int(self.lut.shape[0])

    @property
    def E(self) -> int:
        return sum(len(q) for q in self.preds)


# bit fields of one position's record in kernel D's program (x word)
_P_PREV = 1 << 12  # r - 1 is a predecessor (its word is in a register)
_P_OUT = 1 << 13  # the word is kept in a slot for a later successor
_P_ACC_SHIFT = 14  # accept group index + 1 (0 = none), 5 bits
_P_EOD_SHIFT = 19  # EOD accept group index + 1, 5 bits
_P_PLAIN = 1 << 24  # PREV alone (and at most an accept of the one set)


def membership_words(lut: np.ndarray) -> np.ndarray:
    """The byte -> class-membership table kernel D looks bytes up in:
    word w of byte b holds bit c - 32 w for every class c in 32 w ..
    32 w + 31 that contains b. [ceil(K / 32), 256] int32, from the
    class bitmaps `lut` [K, 256] bool."""
    K = lut.shape[0]
    kw = max(1, -(-K // 32))
    bits = np.zeros((kw * 32, 256), np.uint64)
    bits[:K] = lut
    shifts = (np.arange(kw * 32, dtype=np.uint64) % 32)[:, None]
    words = (bits << shifts).reshape(kw, 32, 256).sum(1)
    return words.astype(np.uint32).view(np.int32)


def kernel_program(info: np.ndarray, preds: List[List[int]]):
    """Kernel D's form of a plan: one 4-word record a position, the
    predecessor slots past two of each, the accept-group values, the
    number of slots and of groups.

    The kernel keeps each position's word of the current 32 bytes only
    as long as a later position reads it: in a register when the only
    reader is the next position (a chain), else in a slot. A slot is
    taken at the position's step and freed after its last reader's
    (reads come before the write within a step, so the reader may take
    it over). Record: x = class | float | anch | PREV (r - 1 is a
    predecessor) | OUT (the word goes to a slot) | accept group + 1 <<
    14 | EOD group + 1 << 19 | PLAIN (PREV and nothing else but an accept
    where there is at most one accept set: the kernel's short path);
    y = out slot | number of slot predecessors << 16; z = the first two
    slot predecessors (16 bits each); w = where the rest start in
    `extra`. gvals[q] = 1 << (g - 1) of accept group q,
    gvals[MAX_DEVICE_SETS + q] that of EOD group q."""
    P = len(preds)
    last = [-1] * P  # last reader of each position
    later = [False] * P  # read by a position other than the next one
    for r, q in enumerate(preds):
        for u in q:
            last[u] = max(last[u], r)
            if u != r - 1:
                later[u] = True
    acc_g = sorted({(int(v) >> _GID_SHIFT) & 31 for v in info} - {0})
    eod_g = sorted({(int(v) >> _EOD_SHIFT) & 31 for v in info} - {0})
    prog = np.zeros((P, 4), np.int64)
    extra: List[int] = []
    slot_of = [-1] * P
    free: List[int] = []
    n_slots = 0
    for r in range(P):
        v = int(info[r])
        x = v & (_CLASS_MASK | _FLOAT | _ANCH)
        ins = [slot_of[u] for u in preds[r] if u != r - 1]
        if (r - 1) in preds[r]:
            x |= _P_PREV
        for u in preds[r]:
            if slot_of[u] >= 0 and last[u] == r:
                free.append(slot_of[u])
        out = 0
        if later[r]:
            if free:
                out = free.pop()
            else:
                out, n_slots = n_slots, n_slots + 1
            slot_of[r] = out
            x |= _P_OUT
        g = (v >> _GID_SHIFT) & 31
        if g:
            x |= (acc_g.index(g) + 1) << _P_ACC_SHIFT
        ge = (v >> _EOD_SHIFT) & 31
        if ge:
            x |= (eod_g.index(ge) + 1) << _P_EOD_SHIFT
        if (x & ~_CLASS_MASK & ~(31 << _P_ACC_SHIFT) == _P_PREV
                and not ins and len(acc_g) <= 1):
            x |= _P_PLAIN
        z = 0
        for k, sl in enumerate(ins[:2]):
            z |= sl << (16 * k)
        prog[r] = (x, out | (len(ins) << 16), z, len(extra))
        extra.extend(ins[2:])
    gvals = np.zeros(2 * MAX_DEVICE_SETS, np.int64)
    for q, g in enumerate(acc_g):
        gvals[q] = 1 << (g - 1)
    for q, g in enumerate(eod_g):
        gvals[MAX_DEVICE_SETS + q] = 1 << (g - 1)
    return (prog.astype(np.uint32).view(np.int32),
            np.asarray(extra or [0], np.int32),
            gvals.astype(np.uint32).view(np.int32), n_slots,
            (len(acc_g), len(eod_g)))


def device_plan(engine, device) -> NfaPlan:
    """The engine's plan as tensors on `device`, cached on the engine."""
    device = torch.device(device)
    cache = engine.__dict__.setdefault("_torch_nfa_plan", {})
    key = str(device)
    if key not in cache:
        meta = _engine_meta(engine)
        order = meta["order"]
        P = len(order)
        rank = np.empty(P, np.int64)
        rank[np.asarray(order, np.int64)] = np.arange(P)
        info = np.zeros(P, np.int64)
        preds: List[List[int]] = []
        for r, p in enumerate(order):
            info[r] = (int(meta["pos_class"][p])
                       | (_FLOAT if engine.float_mask[p] else 0)
                       | (_ANCH if engine.anch_mask[p] else 0)
                       | (int(engine.accept_gid[p]) << _GID_SHIFT)
                       | (int(engine.accept_eod_gid[p]) << _EOD_SHIFT))
            preds.append(sorted(int(rank[u]) for u in meta["preds"][p]))
        lut = np.zeros((len(meta["ranges"]), 256), bool)
        for k, rs in enumerate(meta["ranges"]):
            for (a, b) in rs:
                lut[k, a:b + 1] = True
        prog, extra, gvals, n_slots, groups = kernel_program(info, preds)

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        cache[key] = NfaPlan(
            _halo(engine), info.astype(np.int32), preds, t(lut), t(prog),
            t(extra), t(gvals),
            t(membership_words(lut)), n_slots, groups)
    return cache[key]


# --------------------------------------------------------------------------
# kernel D: the layered sweep
# --------------------------------------------------------------------------


def _check_blocks(bstart: torch.Tensor, bend: torch.Tensor,
                  banch: torch.Tensor) -> None:
    if bstart.dtype != torch.int64 or bend.dtype != torch.int64 \
            or banch.dtype != torch.uint8:
        raise ValueError("block bounds must be int64 and anchors uint8")
    if not (bstart.shape == bend.shape == banch.shape) \
            or bstart.dim() != 1:
        raise ValueError("block bounds and anchors must be flat tensors "
                         "of one length")


def _tile(plan: NfaPlan) -> int:
    """Body bytes per tile of the plain version: its planes (P positions,
    K classes, a few masks, one byte each) stay inside the budget."""
    t = _PLAIN_TILE_BUDGET // (plan.P + plan.K + 8)
    return max(WORD, t // WORD * WORD)


def nfa_layered_plain(corpus_u8: torch.Tensor, plan: NfaPlan,
                      bstart: torch.Tensor, bend: torch.Tensor,
                      banch: torch.Tensor, capacity: int):
    """Plain PyTorch version of kernel D (same contract as
    `nfa_layered`): the plane sweep of the reference's `_make_scan_fn`
    over tiles of the span, each after a halo, so that its memory stays
    bounded. Records come ordered by position."""
    dev = corpus_u8.device
    nb = bstart.numel()
    recs_l: List[torch.Tensor] = []
    eod_out = torch.zeros(nb, dtype=torch.int32, device=dev)
    if nb:
        lo_span = int(bstart[0]) // WORD * WORD
        hi_span = int(bend[-1])
        tile = _tile(plan)
        info = plan.info_np.tolist()
        last = bend - 1
        for t0 in range(lo_span, hi_span, tile):
            t1 = min(t0 + tile, hi_span)
            e0 = max(lo_span, t0 - plan.halo)
            pos = torch.arange(e0, t1, device=dev)
            x = corpus_u8[e0:t1].long()
            bi = (torch.searchsorted(bstart, pos, right=True) - 1).clamp(
                min=0)
            valid = (pos >= bstart[bi]) & (pos < bend[bi])
            start = valid & (pos == bstart[bi])
            anch = start & (banch[bi] != 0)
            cont = valid & ~start
            zero = torch.zeros(1, dtype=torch.bool, device=dev)
            cls = plan.lut[:, x]  # [K, L]
            planes: List[torch.Tensor] = []
            acc = torch.zeros(t1 - e0, dtype=torch.int32, device=dev)
            eod = torch.zeros(t1 - e0, dtype=torch.int32, device=dev)
            for r, v in enumerate(info):
                inp = torch.zeros_like(valid)
                if plan.preds[r]:
                    pred = planes[plan.preds[r][0]]
                    for u in plan.preds[r][1:]:
                        pred = pred | planes[u]
                    inp = torch.cat([zero, pred[:-1]]) & cont
                if v & _FLOAT:
                    inp = inp | valid
                if v & _ANCH:
                    inp = inp | anch
                a = inp & cls[v & _CLASS_MASK] & valid
                planes.append(a)
                g = (v >> _GID_SHIFT) & 31
                if g:
                    acc |= a.int() << (g - 1)
                ge = (v >> _EOD_SHIFT) & 31
                if ge:
                    eod |= a.int() << (ge - 1)
            body = acc[t0 - e0:]
            nz = torch.nonzero(body).squeeze(1)
            recs_l.append(torch.stack([nz + t0, body[nz].long()], 1))
            ends = (last >= t0) & (last < t1)
            eod_out[ends] = eod[last[ends] - e0]
    recs_all = (torch.cat(recs_l) if recs_l
                else torch.zeros((0, 2), dtype=torch.int64, device=dev))
    total = recs_all.shape[0]
    k = min(total, capacity)
    recs = torch.zeros((capacity, 2), dtype=torch.int32, device=dev)
    recs[:k] = recs_all[:k].int()
    return recs, torch.tensor([total], dtype=torch.int32, device=dev), \
        eod_out


def _lib():
    from ._build import library

    lib = library("nfa_layered")
    if not getattr(lib, "_typed", False):
        vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.hs_nfa_layered.restype = ci
        lib.hs_nfa_layered.argtypes = [
            vp, cll, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, vp, vp, vp, ci,
            cll, cll, ci, ci, vp, ci, vp, vp, vp]
        lib.hs_nfa_layered_error.restype = ctypes.c_char_p
        lib.hs_nfa_layered_error.argtypes = [ci]
        lib._typed = True
    return lib


def segment_bytes(halo: int) -> int:
    """The least body bytes a kernel thread scans: four halos, so the
    halo re-read stays under a fifth of the work. The launch raises it
    so that the span's segments fill one wave of the card's resident
    threads."""
    return 4 * halo


def nfa_layered(corpus_u8: torch.Tensor, plan: NfaPlan,
                bstart: torch.Tensor, bend: torch.Tensor,
                banch: torch.Tensor, capacity: int):
    """Kernel D: the layered bit-NFA sweep over blocks of a flat corpus.

    corpus_u8 : flat uint8 tensor of n bytes (n < 2^31)
    plan      : NfaPlan on the corpus's device
    bstart, bend : int64 [nb], the non-empty blocks to scan, ascending
                and disjoint, inside the corpus; bytes outside them are
                dead
    banch     : uint8 [nb], 1 where the block's first byte is anchored
    capacity  : record slots
    Returns (recs int32 [capacity, 2] = (pos, accept bits) for the first
    min(total, capacity) records, total int32 [1] = the exact record
    count, eod int32 [nb] = each block's EOD accept bits). The kernel's
    record order is arbitrary (one atomic counter); callers sort."""
    _check_corpus(corpus_u8)
    _check_blocks(bstart, bend, banch)
    if capacity < 1:
        raise ValueError("capacity must be positive")
    if corpus_u8.device.type == "cpu":
        return nfa_layered_plain(corpus_u8, plan, bstart, bend, banch,
                                 capacity)
    if corpus_u8.device.type != "cuda":
        raise ValueError(f"unsupported device {corpus_u8.device}")
    if corpus_u8.data_ptr() % 16:
        raise ValueError("corpus must be 16-byte aligned (vector loads)")
    for t in (plan.prog, bstart, bend, banch):
        if t.device != corpus_u8.device:
            raise ValueError("corpus, plan and blocks lie on different "
                             "devices")
    lib = _lib()
    dev = corpus_u8.device
    nb = bstart.numel()
    recs = torch.empty((capacity, 2), dtype=torch.int32, device=dev)
    total = torch.zeros(1, dtype=torch.int32, device=dev)
    eod = torch.zeros(nb, dtype=torch.int32, device=dev)
    if nb == 0:
        return recs, total, eod
    lo_span = int(bstart[0]) // WORD * WORD
    hi_span = int(bend[-1])
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.hs_nfa_layered(
        corpus_u8.data_ptr(), corpus_u8.numel(), plan.prog.data_ptr(),
        plan.extra.data_ptr(), plan.gvals.data_ptr(), plan.mem.data_ptr(),
        plan.P, plan.K, plan.slots, plan.groups[0], plan.groups[1],
        plan.extra.numel(), bstart.data_ptr(), bend.data_ptr(),
        banch.data_ptr(), nb, lo_span, hi_span - lo_span, plan.halo,
        segment_bytes(plan.halo), recs.data_ptr(), capacity,
        total.data_ptr(), eod.data_ptr(), stream)
    if rc:
        raise RuntimeError("nfa_layered launch failed: "
                           + lib.hs_nfa_layered_error(rc).decode())
    LAUNCHES["nfa_layered"] += 1
    return recs, total, eod


def block_bounds(starts, lens, block_anchored, device):
    """(bstart, bend, banch, nonempty index) tensors of the non-empty
    blocks, for `nfa_layered`."""
    starts = np.asarray(starts, np.int64)
    lens = np.asarray(lens, np.int64)
    ne = np.flatnonzero(lens > 0)
    anch = np.asarray(block_anchored, bool)[:len(lens)]
    return (torch.from_numpy(starts[ne].copy()).to(device),
            torch.from_numpy((starts + lens)[ne]).to(device),
            torch.from_numpy(anch[ne].astype(np.uint8)).to(device), ne)


def nfa_scan_corpus(engine, corpus_t: torch.Tensor, starts, lens,
                    block_anchored, capacity: int = 1 << 14):
    """`nfa_scan_corpus_device` over blocks of an uploaded flat corpus."""
    dev = corpus_t.device
    plan = device_plan(engine, dev)
    bstart, bend, banch, ne = block_bounds(starts, lens, block_anchored,
                                           dev)
    cap = max(capacity, get_capacity_hint(engine, "nfa"))
    while True:
        recs, total, eod = nfa_layered(corpus_t, plan, bstart, bend, banch,
                                       cap)
        tot = int(total)
        if tot <= cap:
            break
        count("redispatches")
        cap = _p2(tot)
    set_capacity_hint(engine, "nfa", cap)
    r = recs[:tot].long()
    r = r[torch.argsort(r[:, 0])].cpu().numpy()
    starts = np.asarray(starts, np.int64)
    bi = np.searchsorted(starts[ne], r[:, 0], side="right") - 1
    bi = ne[bi] if len(bi) else bi
    eod_bits = np.zeros(len(starts), np.int32)
    eod_bits[ne] = eod.cpu().numpy()
    return (bi.astype(np.int64), r[:, 0] - starts[bi], r[:, 1]), eod_bits


def nfa_scan_corpus_device(
    engine, blocks: List[bytes], block_anchored: np.ndarray,
    capacity: int = 1 << 14, *, device="cuda",
):
    """Scan concatenated blocks with a layered bit-NFA.

    Returns (records as parallel arrays (block_idx, pos_local,
    accept_set_bitmask), eod_bits [n_blocks] int32).
    """
    _corpus, corpus_t, starts, lens = upload_blocks(blocks, device)
    return nfa_scan_corpus(engine, corpus_t, starts, lens, block_anchored,
                           capacity)
