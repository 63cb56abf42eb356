"""Teddy multi-literal filter, candidate compaction and hash confirm on
a torch device: the kernels and tables that the literal path's families
(`teddy_families`) are made of.

Reference analogue: the FDR/Teddy literal matchers (src/fdr/teddy.c) and
the confirm step that follows them (do_confirm_fdr, src/fdr/fdr.c:330).
This is the port of `hyperscan_tpu/ops/teddy.py`'s filter and confirm
kernels:

  candidate at byte p  <=>  OR_w AND_{m<M} tab[m][w][key(p - m)] != 0

where key(q) is the byte at q (byte tables) or its class under the
byte->class remap (class tables, `_class_split`), with a zero byte before
offset 0. Kernel A (`filter_compact`) emits per 64 KiB cell the exact
candidate count and the first `capc` positions; its plane mode
(`filter_plane`) writes a candidacy plane instead; the same filter over
the gate's flagged rows is `teddy_gate.rescan_rows` (its own kernel).
Kernel B (`hash_confirm`) probes each candidate's masked 8-byte tail
against the open-addressed tables of
`runtime.lit_runtime.confirm_device_tables` and emits (class + 1, pos)
pairs.

Every kernel is written by hand for sm_90a (`csrc/`). Each wrapper
launches its kernel for a CUDA tensor and counts the launch in
`LAUNCHES`; for a CPU tensor it runs the plain PyTorch version beside it
(`*_plain`), which is also what the kernels are held against on the card.

The corpus is a flat uint8 tensor: none of the TPU layouts (128-lane
rows, halo row, cell bucketing) are carried over.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..trace import spanned
# the launch counters of every kernel of the port (one shared registry)
from ._build import LAUNCHES, reset_launches  # noqa: F401

CELL = 65536  # bytes per filter cell (one CUDA block); the reference's
# ROWS_PER_CELL * 128, so per-cell counts compare with it directly
ROW = 128  # bytes per gate row: the reference's survivor unit, in which
# GATE_ROW_FRAC is defined
EXTRACT_CHUNK = 256  # bytes per chunk of the dense extraction (reference
# EXTRACT_CHUNK, hyperscan_tpu/ops/teddy.py:997)
# cells per step of the plain filter: bounds its memory at any corpus size
_PLAIN_CHUNK_CELLS = 256


def _p2(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def get_capacity_hint(obj, key: str) -> int:
    """Learned record capacity of one engine route (0 = none yet), kept
    on the engine under this package's own attribute name (reference:
    get_capacity_hint, hyperscan_tpu/ops/teddy.py:856)."""
    return getattr(obj, "_torch_cap_hints", {}).get(key, 0)


def set_capacity_hint(obj, key: str, capacity: int) -> None:
    obj.__dict__.setdefault("_torch_cap_hints", {})[key] = int(capacity)


@spanned("hs.assemble")
def flatten_blocks(blocks) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Blocks head to head in one flat uint8 corpus, with no gap: returns
    (corpus, starts int64 [B], lens int64 [B])."""
    lens = np.asarray([len(b) for b in blocks], dtype=np.int64)
    starts = np.zeros(len(blocks), dtype=np.int64)
    if len(blocks) > 1:
        np.cumsum(lens[:-1], out=starts[1:])
    corpus = (np.concatenate([np.frombuffer(b, dtype=np.uint8)
                              for b in blocks])
              if int(lens.sum()) else np.zeros(0, dtype=np.uint8))
    return corpus, starts, lens


@spanned("hs.upload")
def corpus_tensor(corpus: np.ndarray, device) -> torch.Tensor:
    """Flat uint8 corpus tensor on `device` (a view of the array on the
    CPU, an upload otherwise)."""
    corpus = np.ascontiguousarray(corpus, dtype=np.uint8)
    if not corpus.flags.writeable:
        corpus = corpus.copy()
    return torch.from_numpy(corpus).to(device)


def upload_blocks(blocks, device):
    """`flatten_blocks` plus the upload: (corpus, corpus tensor on
    `device`, starts, lens). A CUDA device must exist."""
    from ..runtime.scan import resolve_device

    corpus, starts, lens = flatten_blocks(blocks)
    return corpus, corpus_tensor(corpus, resolve_device(device)), starts, \
        lens


def _class_split(masks: np.ndarray):
    """Byte->class remap + per-class mask tables, or None when the
    alphabet does not compress below 128 classes.

    Two bytes are equivalent iff every (m, w) mask word agrees on them;
    real rulesets compress 256 bytes to a few dozen classes, so the
    class kernel's tables are half the byte tables' size.
    Returns (b2c [8, 128] int32 (rows 0-1 = bytes 0-127 / 128-255),
    cmasks [M, W, 128] int32)."""
    M, W, _ = masks.shape
    stack = masks.reshape(M * W, 256).T  # [256, M*W]
    u, inv = np.unique(stack, axis=0, return_inverse=True)
    C = len(u)
    if C > 128:
        return None
    b2c = np.zeros((8, 128), np.int32)
    b2c[0] = inv[:128]
    b2c[1] = inv[128:]
    cmasks = np.zeros((M, W, 128), np.int32)
    cmasks[:, :, :C] = u.T.reshape(M, W, C)
    return b2c, cmasks


def padded_width(W: int) -> int:
    """Wp: the kernels' table width for W words, 1, 2, 4 or 8."""
    if not 1 <= W <= 8:
        raise ValueError(f"W={W} bucket words outside 1..8")
    return 1 if W == 1 else 2 if W == 2 else 4 if W <= 4 else 8


def pack_tables(tab: torch.Tensor) -> torch.Tensor:
    """The kernels' layout of [M, W, K] int32 filter tables: [M, K, Wp],
    the W words of one (m, key) side by side and zero-padded to Wp
    (`padded_width`), so a kernel reads them with one vector load. A
    permutation plus zero padding: packed[m, k, w] = tab[m, w, k] for
    w < W, 0 for W <= w < Wp."""
    M, W, K = (int(d) for d in tab.shape)
    out = tab.new_zeros((M, K, padded_width(W)))
    out[:, :, :W] = tab.permute(0, 2, 1)
    return out


@dataclasses.dataclass
class FilterTables:
    """The filter's tables on one device: the byte tables always, the
    class tables when the alphabet compresses to 128 classes or fewer.

    `masks` and `cmasks` are [M, W, K] (K = 256 bytes or 128 classes):
    word w of suffix offset m and key k, as the plain versions read them.
    `packed` and `cpacked` hold the same words in the kernels' layout
    (`pack_tables`), built once beside them by `filter_tables`; tables
    made without them (a plain version's input) cannot feed a kernel."""

    masks: torch.Tensor  # [M, W, 256] int32
    b2c: Optional[torch.Tensor]  # [256] uint8 byte -> class id
    cmasks: Optional[torch.Tensor]  # [M, W, 128] int32
    packed: Optional[torch.Tensor] = None  # [M, 256, Wp] int32
    cpacked: Optional[torch.Tensor] = None  # [M, 128, Wp] int32

    @property
    def M(self) -> int:
        return int(self.masks.shape[0])

    @property
    def W(self) -> int:
        return int(self.masks.shape[1])


def filter_tables(masks: torch.Tensor, b2c: Optional[torch.Tensor] = None,
                  cmasks: Optional[torch.Tensor] = None) -> FilterTables:
    """FilterTables with the kernels' layout of each table built beside
    it."""
    return FilterTables(masks, b2c, cmasks, pack_tables(masks),
                        None if cmasks is None else pack_tables(cmasks))


def mask_tables(masks: np.ndarray, device) -> FilterTables:
    """FilterTables of the [M, W, 256] byte masks (`lit.masks`) on
    `device`: the byte tables, and the class tables beside them when the
    alphabet compresses to 128 classes or fewer (`_class_split`)."""
    masks = np.ascontiguousarray(masks, dtype=np.int32)
    split = _class_split(masks)
    if split is None:
        return filter_tables(torch.from_numpy(masks.copy()).to(device))
    b2c = np.concatenate([split[0][0], split[0][1]]).astype(np.uint8)
    return filter_tables(
        torch.from_numpy(masks.copy()).to(device),
        torch.from_numpy(b2c).to(device),
        torch.from_numpy(np.ascontiguousarray(split[1])).to(device))


@dataclasses.dataclass
class ConfirmTables:
    """`confirm_device_tables` on one device: one open-addressed slot
    table per (tail length, tail mask) group, all back to back in
    `slots` (int32: sig12 << 20 | class id + 1; 0 = empty)."""

    groups: Tuple[Tuple[int, int, int, int, int, int], ...]
    # (cl, mlo, mhi, T, probes, offset) per group, as Python ints
    meta: torch.Tensor  # [G, 6] int32, the same (mlo/mhi as bit patterns)
    slots: torch.Tensor  # [sum T] int32


def _i32(v: int) -> int:
    """uint32 bit pattern as a signed int32 value."""
    v = int(v) & 0xFFFFFFFF
    return v - (1 << 32) if v >= (1 << 31) else v


def device_tables(lit, device) -> Tuple[FilterTables, ConfirmTables]:
    """Upload-once filter and confirm tables, cached on the lit object
    per device (under this package's own attribute name)."""
    from ..runtime.lit_runtime import confirm_device_tables

    device = torch.device(device)
    cache = lit.__dict__.setdefault("_torch_tables", {})
    key = str(device)
    if key not in cache:
        ft = mask_tables(lit.masks, device)
        groups, parts, off = [], [], 0
        for (cl, mlo, mhi, slots, _dummy, probes) in confirm_device_tables(lit):
            T = int(slots.shape[0])
            groups.append((int(cl), int(mlo), int(mhi), T, int(probes), off))
            parts.append(np.asarray(slots, np.int32))
            off += T
        meta = np.asarray(
            [(cl, _i32(mlo), _i32(mhi), T, pr, o)
             for (cl, mlo, mhi, T, pr, o) in groups],
            np.int32).reshape(-1, 6)
        slots_all = (np.concatenate(parts) if parts
                     else np.zeros(1, np.int32))
        ct = ConfirmTables(tuple(groups),
                           torch.from_numpy(meta).to(device),
                           torch.from_numpy(slots_all).to(device))
        cache[key] = (ft, ct)
    return cache[key]


# --------------------------------------------------------------------------
# kernel A: filter + per-cell compaction
# --------------------------------------------------------------------------


def _n_cells(n: int) -> int:
    return max(1, -(-n // CELL))


def _check_corpus(corpus_u8: torch.Tensor) -> None:
    if corpus_u8.dtype != torch.uint8 or corpus_u8.dim() != 1:
        raise ValueError("corpus must be a flat uint8 tensor")
    if not corpus_u8.is_contiguous():
        raise ValueError("corpus must be contiguous")
    if corpus_u8.numel() >= (1 << 31):
        raise ValueError("corpus must be shorter than 2^31 bytes "
                         "(positions are int32)")


def _candidates_plain(corpus: torch.Tensor, tables: FilterTables,
                      use_classes: bool, lo: int, hi: int) -> torch.Tensor:
    """Candidacy (bool) of positions [lo, hi), with zero bytes before 0."""
    M = tables.M
    start = max(0, lo - (M - 1))
    seg = corpus[start:hi].long()
    pad = (M - 1) - (lo - start)
    if pad:
        seg = torch.cat([seg.new_zeros(pad), seg])
    # seg[k] is the byte at lo - (M - 1) + k
    if use_classes:
        key, tab = tables.b2c.long()[seg], tables.cmasks
    else:
        key, tab = seg, tables.masks
    L = hi - lo
    cand = torch.zeros(L, dtype=torch.bool, device=corpus.device)
    for w in range(tables.W):
        acc = None
        for m in range(M):
            v = tab[m, w][key[M - 1 - m:M - 1 - m + L]]
            acc = v if acc is None else acc & v
        cand |= acc != 0
    return cand


def filter_compact_plain(corpus_u8: torch.Tensor, tables: FilterTables,
                         capc: int, *, use_classes: bool,
                         row_flags: Optional[torch.Tensor] = None):
    """Plain PyTorch version of kernel A (same contract as
    `filter_compact`; with `row_flags`, of the survivor rescan
    `teddy_gate.rescan_rows`: only candidates in flagged 128-byte rows
    count); works chunk by chunk so its memory stays bounded at any
    corpus size. Slots past a cell's count hold 0."""
    n = corpus_u8.numel()
    n_cells = _n_cells(n)
    dev = corpus_u8.device
    pos = torch.zeros((n_cells, capc), dtype=torch.int32, device=dev)
    counts = torch.zeros(n_cells, dtype=torch.int32, device=dev)
    for c0 in range(0, n_cells, _PLAIN_CHUNK_CELLS):
        c1 = min(n_cells, c0 + _PLAIN_CHUNK_CELLS)
        lo, hi = c0 * CELL, min(n, c1 * CELL)
        if hi <= lo:
            break
        nz = torch.nonzero(
            _candidates_plain(corpus_u8, tables, use_classes, lo, hi)
        ).squeeze(1) + lo
        if row_flags is not None:
            nz = nz[row_flags[torch.div(nz, ROW, rounding_mode="floor")]
                    != 0]
        cell = torch.div(nz, CELL, rounding_mode="floor")
        cnt = torch.bincount(cell - c0, minlength=c1 - c0)
        counts[c0:c1] = cnt.int()
        first = torch.cumsum(cnt, 0) - cnt
        rank = torch.arange(nz.numel(), device=dev) - first[cell - c0]
        keep = rank < capc
        pos[cell[keep], rank[keep]] = nz[keep].int()
    return pos, counts


def _filter_lib():
    from ._build import library

    lib = library("teddy_filter_compact")
    if not getattr(lib, "_typed", False):
        vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.hs_teddy_filter_compact.restype = ci
        lib.hs_teddy_filter_compact.argtypes = [
            vp, cll, vp, vp, ci, ci, ci, ci, vp, vp, ci, vp]
        lib.hs_teddy_filter_plane.restype = ci
        lib.hs_teddy_filter_plane.argtypes = [
            vp, cll, vp, vp, ci, ci, ci, vp, cll, ci, vp]
        lib.hs_teddy_filter_compact_error.restype = ctypes.c_char_p
        lib.hs_teddy_filter_compact_error.argtypes = [ci]
        lib._typed = True
    return lib


def _on_card(corpus_u8: torch.Tensor, tables: FilterTables,
             use_classes: bool) -> bool:
    """Check a filter kernel's corpus and tables; True when the kernel
    runs (a CUDA corpus), False when the plain version does (a CPU one)."""
    _check_corpus(corpus_u8)
    if use_classes and tables.cmasks is None:
        raise ValueError("class tables requested but the alphabet does "
                         "not compress to 128 classes")
    if not 1 <= tables.M <= 8:
        raise ValueError(f"suffix depth M={tables.M} outside 1..8")
    if corpus_u8.device.type == "cpu":
        return False
    if corpus_u8.device.type != "cuda":
        raise ValueError(f"unsupported device {corpus_u8.device}")
    if corpus_u8.data_ptr() % 16:
        raise ValueError("corpus must be 16-byte aligned (vector loads)")
    tab = tables.cpacked if use_classes else tables.packed
    if tab is None:
        raise ValueError("tables without the kernels' layout (build them "
                         "with filter_tables)")
    if tab.device != corpus_u8.device:
        raise ValueError("tables and corpus lie on different devices")
    return True


def _table_args(tables: FilterTables, use_classes: bool):
    """(b2c pointer or None, packed table pointer, M, Wp, classes flag)."""
    tab = tables.cpacked if use_classes else tables.packed
    return (tables.b2c.data_ptr() if use_classes else None, tab.data_ptr(),
            tables.M, int(tab.shape[2]), int(use_classes))


def _raise_on(rc: int, lib, what: str) -> None:
    if rc:
        raise RuntimeError(f"{what} launch failed: "
                           + lib.hs_teddy_filter_compact_error(rc).decode())


def filter_compact(corpus_u8: torch.Tensor, tables: FilterTables,
                   capc: int, *, use_classes: bool):
    """Kernel A: Teddy filter + per-cell candidate compaction.

    corpus_u8 : flat uint8 tensor of n bytes (n < 2^31)
    tables    : FilterTables on the corpus's device
    capc      : position slots per 64 KiB cell
    Returns (pos [n_cells, capc] int32 absolute candidate positions,
    ascending, valid for slots j < min(count, capc); counts [n_cells]
    int32, the exact candidate count of each cell), n_cells =
    max(1, ceil(n / 65536)). Positions >= n are never candidates."""
    if capc < 1:
        raise ValueError("capc must be positive")
    if not _on_card(corpus_u8, tables, use_classes):
        return filter_compact_plain(corpus_u8, tables, capc,
                                    use_classes=use_classes)
    lib = _filter_lib()
    n = corpus_u8.numel()
    n_cells = _n_cells(n)
    pos = torch.empty((n_cells, capc), dtype=torch.int32,
                      device=corpus_u8.device)
    counts = torch.empty(n_cells, dtype=torch.int32,
                         device=corpus_u8.device)
    stream = torch.cuda.current_stream(corpus_u8.device).cuda_stream
    rc = lib.hs_teddy_filter_compact(
        corpus_u8.data_ptr(), n, *_table_args(tables, use_classes),
        capc, pos.data_ptr(), counts.data_ptr(), n_cells, stream)
    _raise_on(rc, lib, "teddy_filter_compact")
    LAUNCHES["teddy_filter_compact"] += 1
    return pos, counts


def plane_len(n: int) -> int:
    """Bytes of the candidacy plane of an n-byte corpus: n rounded up to
    whole extraction chunks."""
    return -(-n // EXTRACT_CHUNK) * EXTRACT_CHUNK


def filter_plane_plain(corpus_u8: torch.Tensor, tables: FilterTables, *,
                       use_classes: bool) -> torch.Tensor:
    """Plain PyTorch version of `filter_plane` (same contract)."""
    n = corpus_u8.numel()
    plane = torch.zeros(plane_len(n), dtype=torch.uint8,
                        device=corpus_u8.device)
    step = _PLAIN_CHUNK_CELLS * CELL
    for lo in range(0, n, step):
        hi = min(n, lo + step)
        plane[lo:hi] = _candidates_plain(corpus_u8, tables, use_classes,
                                         lo, hi).to(torch.uint8)
    return plane


def filter_plane(corpus_u8: torch.Tensor, tables: FilterTables, *,
                 use_classes: bool) -> torch.Tensor:
    """Kernel A in plane mode (the dense family's filter, reference: the
    pallas_call at hyperscan_tpu/ops/teddy.py:1116 with capc = 0).

    Returns the candidacy plane, uint8 [plane_len(n)]: 1 where a
    candidate ends, 0 elsewhere (and at and past n)."""
    if not _on_card(corpus_u8, tables, use_classes):
        return filter_plane_plain(corpus_u8, tables, use_classes=use_classes)
    lib = _filter_lib()
    n = corpus_u8.numel()
    plane = torch.empty(plane_len(n), dtype=torch.uint8,
                        device=corpus_u8.device)
    stream = torch.cuda.current_stream(corpus_u8.device).cuda_stream
    rc = lib.hs_teddy_filter_plane(
        corpus_u8.data_ptr(), n, *_table_args(tables, use_classes),
        plane.data_ptr(), plane.numel(), _n_cells(n), stream)
    _raise_on(rc, lib, "teddy_filter_plane")
    LAUNCHES["teddy_filter_plane"] += 1
    return plane


def _cell_slots(counts: torch.Tensor, capc: int, cap: int):
    """Slot k of one list gathered from per-cell lists of `capc` entries
    (the first min(count, capc) of each cell valid, cells in order) ->
    (cell, index within the cell, valid), in plain torch over O(n_cells)
    counts: slot rank -> owning cell by a searchsorted over the count
    cumsum (reference: compact_combine, hyperscan_tpu/ops/teddy.py:1243)."""
    n_cells = counts.shape[0]
    eff = counts.clamp(max=capc).long()
    cum = torch.cumsum(eff, 0)
    slot = torch.arange(cap, dtype=torch.int64, device=counts.device)
    cell = torch.searchsorted(cum, slot, right=True).clamp(max=n_cells - 1)
    within = (slot - (cum[cell] - eff[cell])).clamp(0, capc - 1)
    return cell, within, slot < cum[-1]


def compact_combine(pos: torch.Tensor, counts: torch.Tensor, capc: int,
                    cap1: int):
    """Per-cell compacted positions -> one list of `cap1` candidate
    positions (-1 past the valid ones).

    Returns (meta1 int64 [2] = (exact candidate total, max cell count),
    positions int32 [cap1])."""
    cell, within, have = _cell_slots(counts, capc, cap1)
    got = pos[cell, within]
    out = torch.where(have, got, torch.full_like(got, -1))
    meta1 = torch.stack([counts.long().sum(), counts.long().max()])
    return meta1, out


# --------------------------------------------------------------------------
# kernel B: hash confirm
# --------------------------------------------------------------------------


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for int64 tensors a in [0, 2^32) and a constant
    c < 2^32, without int64 overflow (torch has no wrapping uint32
    multiply on the CPU)."""
    a0 = a & 0xFFFF
    a1 = a >> 16
    return (a0 * c + (((a1 * c) & 0xFFFF) << 16)) & 0xFFFFFFFF


def _tail_words(corpus_u8: torch.Tensor, p: torch.Tensor, valid):
    """(lo_w, hi_w) int64 words of the 8 bytes ending at p: lo_w = bytes
    p-7..p-4, hi_w = bytes p-3..p (newest on top), zero before offset 0
    (reference: _hash_confirm_stage, hyperscan_tpu/ops/teddy.py:1299)."""
    n = corpus_u8.numel()
    tb = []
    for k in range(8):
        q = p - k
        ok = valid & (q >= 0) & (q < n)
        b = corpus_u8[q.clamp(0, max(n - 1, 0))].long() if n else \
            torch.zeros_like(q)
        tb.append(torch.where(ok, b, torch.zeros_like(b)))
    lo = tb[7] | (tb[6] << 8) | (tb[5] << 16) | (tb[4] << 24)
    hi = tb[3] | (tb[2] << 8) | (tb[1] << 16) | (tb[0] << 24)
    return lo, hi


def hash_confirm_plain(corpus_u8: torch.Tensor, pos: torch.Tensor,
                       tables: ConfirmTables, cap2: int):
    """Plain PyTorch version of kernel B (same contract as
    `hash_confirm`); its pairs come ordered by (pos, class)."""
    dev = pos.device
    p = pos.long()
    valid = p >= 0
    lo, hi = _tail_words(corpus_u8, p, valid)
    slots = tables.slots.long() & 0xFFFFFFFF
    cls_l, pos_l = [], []
    for (cl, mlo, mhi, T, probes, off) in tables.groups:
        h = _mul32(lo & mlo, 0x9E3779B1) ^ _mul32(hi & mhi, 0x85EBCA6B)
        # avalanche finalizer — mirrors lit_runtime._avalanche32
        h = h ^ (h >> 15)
        h = _mul32(h, 0x2C1B3C6D)
        h = h ^ (h >> 13)
        sig = h >> 20
        ok = valid & (p >= cl - 1)
        for k in range(probes):
            sl = slots[off + ((h + k) & (T - 1))]
            hit = ok & (sl != 0) & ((sl >> 20) == sig)
            cls_l.append((sl & 0xFFFFF)[hit])
            pos_l.append(p[hit])
    if cls_l:
        cls_a, pos_a = torch.cat(cls_l), torch.cat(pos_l)
    else:
        cls_a = pos_a = torch.zeros(0, dtype=torch.int64, device=dev)
    order = torch.argsort((pos_a << 20) | cls_a)
    total = cls_a.numel()
    k = min(total, cap2)
    pairs = torch.zeros((cap2, 2), dtype=torch.int32, device=dev)
    pairs[:k, 0] = cls_a[order[:k]].int()
    pairs[:k, 1] = pos_a[order[:k]].int()
    return pairs, torch.tensor([total], dtype=torch.int32, device=dev)


def _confirm_lib():
    from ._build import library

    lib = library("teddy_hash_confirm")
    if not getattr(lib, "_typed", False):
        vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        for fn in (lib.hs_teddy_hash_confirm,
                   lib.hs_teddy_hash_confirm_launch):
            fn.restype = ci
            fn.argtypes = [vp, cll, vp, ci, vp, ci, vp, vp, ci, vp, vp]
        lib.hs_teddy_hash_confirm_error.restype = ctypes.c_char_p
        lib.hs_teddy_hash_confirm_error.argtypes = [ci]
        lib._typed = True
    return lib


def confirm_args(corpus_u8: torch.Tensor, pos: torch.Tensor,
                 tables: ConfirmTables):
    """Checks kernel B's inputs and returns the arguments of its entry
    points up to the slot tables: (corpus, n, positions, n_pos, group
    records, G, slot tables). `pos` must be contiguous."""
    _check_corpus(corpus_u8)
    if pos.dtype != torch.int32 or pos.dim() != 1 or \
            not pos.is_contiguous():
        raise ValueError("positions must be a flat contiguous int32 "
                         "tensor")
    dev = corpus_u8.device
    if pos.device != dev or tables.slots.device != dev:
        raise ValueError("corpus, positions and tables lie on different "
                         "devices")
    return (corpus_u8.data_ptr(), corpus_u8.numel(), pos.data_ptr(),
            pos.numel(), tables.meta.data_ptr(), len(tables.groups),
            tables.slots.data_ptr())


def hash_confirm(corpus_u8: torch.Tensor, pos: torch.Tensor,
                 tables: ConfirmTables, cap2: int):
    """Kernel B: hash confirm of candidate positions.

    corpus_u8 : flat uint8 corpus tensor
    pos       : int32 [cap1] candidate positions, -1 = empty slot
    tables    : ConfirmTables on the same device (any number of groups)
    Returns (pairs int32 [cap2, 2] = (class id + 1, pos) for the first
    min(total, cap2) rows, total int32 [1] = the exact number of
    hash-matched pairs). The kernel's row order is arbitrary;
    `confirm_finish` sorts. On the card the entry point zeroes `total`
    and launches the kernel: nothing else runs on the card."""
    if cap2 < 1:
        raise ValueError("cap2 must be positive")
    pos = pos.contiguous()
    if corpus_u8.device.type == "cpu":
        confirm_args(corpus_u8, pos, tables)
        return hash_confirm_plain(corpus_u8, pos, tables, cap2)
    if corpus_u8.device.type != "cuda":
        raise ValueError(f"unsupported device {corpus_u8.device}")
    args = confirm_args(corpus_u8, pos, tables)
    lib = _confirm_lib()
    pairs = torch.empty((cap2, 2), dtype=torch.int32,
                        device=corpus_u8.device)
    total = torch.empty(1, dtype=torch.int32, device=corpus_u8.device)
    stream = torch.cuda.current_stream(corpus_u8.device).cuda_stream
    rc = lib.hs_teddy_hash_confirm(*args, pairs.data_ptr(), cap2,
                                   total.data_ptr(), stream)
    if rc:
        raise RuntimeError("teddy_hash_confirm launch failed: "
                           + lib.hs_teddy_hash_confirm_error(rc).decode())
    if args[3] and args[5]:
        LAUNCHES["teddy_hash_confirm"] += 1
    return pairs, total
