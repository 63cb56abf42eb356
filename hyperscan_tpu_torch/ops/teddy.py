"""Teddy multi-literal filter, per-cell candidate compaction and hash
confirm on a torch device.

Reference analogue: the FDR/Teddy literal matchers (src/fdr/teddy.c) and
the confirm step that follows them (do_confirm_fdr, src/fdr/fdr.c:330).
This is the port of the JAX package's ungated compact family
(`hyperscan_tpu/ops/teddy.py`: `filter_confirm_body` with `capc > 0`,
`compact_combine` and `_hash_confirm_stage`):

  candidate at byte p  <=>  OR_w AND_{m<M} tab[m][w][key(p - m)] != 0

where key(q) is the byte at q (byte tables) or its class under the
byte->class remap (class tables, `_class_split`), with a zero byte before
offset 0. Per 64 KiB cell the filter emits the exact candidate count and
the first `capc` candidate positions in ascending order; the combine
turns those into one `cap1` position list; the hash confirm probes each
candidate's masked 8-byte tail against the open-addressed tables of
`runtime.lit_runtime.confirm_device_tables` and emits (class + 1, pos)
pairs.

Two kernels carry it, written by hand for sm_90a (`csrc/`):
`filter_compact` (teddy_filter_compact.cu) and `hash_confirm`
(teddy_hash_confirm.cu). Each wrapper launches its kernel for a CUDA
tensor and counts the launch in `LAUNCHES`; for a CPU tensor it runs the
plain PyTorch version beside it (`*_plain`), which is also what the
kernels are held against on the card.

The corpus is a flat uint8 tensor: none of the TPU layouts (128-lane
rows, halo row, cell bucketing) are carried over.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

# the launch counters of every kernel of the port (one shared registry)
from ._build import LAUNCHES, reset_launches  # noqa: F401

CELL = 65536  # bytes per filter cell (one CUDA block); the reference's
# ROWS_PER_CELL * 128, so per-cell counts compare with it directly

# learned-capacity floors: capc is the per-cell compaction capacity,
# cap1 the candidate list, cap2 the confirmed-pair buffer
CAPC_FLOOR = 128
CAP1_FLOOR = 1024
CAP2_FLOOR = 1024
# cells per step of the plain filter: bounds its memory at any corpus size
_PLAIN_CHUNK_CELLS = 256


def _p2(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


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


@dataclasses.dataclass
class FilterTables:
    """The filter's tables on one device: the byte tables always, the
    class tables when the alphabet compresses to 128 classes or fewer."""

    masks: torch.Tensor  # [M, W, 256] int32
    b2c: Optional[torch.Tensor]  # [256] uint8 byte -> class id
    cmasks: Optional[torch.Tensor]  # [M, W, 128] int32

    @property
    def M(self) -> int:
        return int(self.masks.shape[0])

    @property
    def W(self) -> int:
        return int(self.masks.shape[1])


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
        masks = np.ascontiguousarray(lit.masks, dtype=np.int32)
        split = _class_split(masks)
        if split is not None:
            b2c = np.concatenate([split[0][0], split[0][1]]).astype(np.uint8)
            ft = FilterTables(
                torch.from_numpy(masks).to(device),
                torch.from_numpy(b2c).to(device),
                torch.from_numpy(np.ascontiguousarray(split[1])).to(device))
        else:
            ft = FilterTables(torch.from_numpy(masks).to(device), None, None)
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
                         capc: int, *, use_classes: bool):
    """Plain PyTorch version of kernel A (same contract as
    `filter_compact`); works chunk by chunk so its memory stays bounded
    at any corpus size. Slots past a cell's count hold 0."""
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
        lib.hs_teddy_filter_compact_error.restype = ctypes.c_char_p
        lib.hs_teddy_filter_compact_error.argtypes = [ci]
        lib._typed = True
    return lib


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
    _check_corpus(corpus_u8)
    if use_classes and tables.cmasks is None:
        raise ValueError("class tables requested but the alphabet does "
                         "not compress to 128 classes")
    if not 1 <= tables.M <= 8:
        raise ValueError(f"suffix depth M={tables.M} outside 1..8")
    if capc < 1:
        raise ValueError("capc must be positive")
    if corpus_u8.device.type == "cpu":
        return filter_compact_plain(corpus_u8, tables, capc,
                                    use_classes=use_classes)
    if corpus_u8.device.type != "cuda":
        raise ValueError(f"unsupported device {corpus_u8.device}")
    if corpus_u8.data_ptr() % 16:
        raise ValueError("corpus must be 16-byte aligned (vector loads)")
    tab = tables.cmasks if use_classes else tables.masks
    if tab.device != corpus_u8.device:
        raise ValueError("tables and corpus lie on different devices")
    lib = _filter_lib()
    n = corpus_u8.numel()
    n_cells = _n_cells(n)
    pos = torch.empty((n_cells, capc), dtype=torch.int32,
                      device=corpus_u8.device)
    counts = torch.empty(n_cells, dtype=torch.int32,
                         device=corpus_u8.device)
    stream = torch.cuda.current_stream(corpus_u8.device).cuda_stream
    rc = lib.hs_teddy_filter_compact(
        corpus_u8.data_ptr(), n,
        tables.b2c.data_ptr() if use_classes else None,
        tab.data_ptr(), tables.M, tables.W, int(use_classes),
        capc, pos.data_ptr(), counts.data_ptr(), n_cells, stream)
    if rc:
        raise RuntimeError("teddy_filter_compact launch failed: "
                           + lib.hs_teddy_filter_compact_error(rc).decode())
    LAUNCHES["teddy_filter_compact"] += 1
    return pos, counts


def compact_combine(pos: torch.Tensor, counts: torch.Tensor, capc: int,
                    cap1: int):
    """Per-cell compacted positions -> one list of `cap1` candidate
    positions (-1 past the valid ones), in plain torch over O(n_cells)
    counts: slot rank -> owning cell by a searchsorted over the count
    cumsum (reference: compact_combine, hyperscan_tpu/ops/teddy.py:1243).

    Returns (meta1 int64 [2] = (exact candidate total, max cell count),
    positions int32 [cap1])."""
    n_cells = counts.shape[0]
    eff = counts.clamp(max=capc).long()
    cum = torch.cumsum(eff, 0)
    slot = torch.arange(cap1, dtype=torch.int64, device=pos.device)
    cell = torch.searchsorted(cum, slot, right=True).clamp(max=n_cells - 1)
    within = (slot - (cum[cell] - eff[cell])).clamp(0, capc - 1)
    got = pos[cell, within]
    have = slot < cum[-1]
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
        lib.hs_teddy_hash_confirm.restype = ci
        lib.hs_teddy_hash_confirm.argtypes = [
            vp, cll, vp, ci, vp, ci, vp, vp, ci, vp, vp]
        lib.hs_teddy_hash_confirm_error.restype = ctypes.c_char_p
        lib.hs_teddy_hash_confirm_error.argtypes = [ci]
        lib._typed = True
    return lib


def hash_confirm(corpus_u8: torch.Tensor, pos: torch.Tensor,
                 tables: ConfirmTables, cap2: int):
    """Kernel B: hash confirm of candidate positions.

    corpus_u8 : flat uint8 corpus tensor
    pos       : int32 [cap1] candidate positions, -1 = empty slot
    tables    : ConfirmTables on the same device
    Returns (pairs int32 [cap2, 2] = (class id + 1, pos) for the first
    min(total, cap2) rows, total int32 [1] = the exact number of
    hash-matched pairs). The kernel's row order is arbitrary (one atomic
    counter); `confirm_finish` sorts."""
    _check_corpus(corpus_u8)
    if pos.dtype != torch.int32 or pos.dim() != 1:
        raise ValueError("positions must be a flat int32 tensor")
    if cap2 < 1:
        raise ValueError("cap2 must be positive")
    if corpus_u8.device.type == "cpu":
        return hash_confirm_plain(corpus_u8, pos, tables, cap2)
    if corpus_u8.device.type != "cuda":
        raise ValueError(f"unsupported device {corpus_u8.device}")
    if pos.device != corpus_u8.device or \
            tables.slots.device != corpus_u8.device:
        raise ValueError("corpus, positions and tables lie on different "
                         "devices")
    lib = _confirm_lib()
    pos = pos.contiguous()
    pairs = torch.empty((cap2, 2), dtype=torch.int32,
                        device=corpus_u8.device)
    total = torch.zeros(1, dtype=torch.int32, device=corpus_u8.device)
    stream = torch.cuda.current_stream(corpus_u8.device).cuda_stream
    rc = lib.hs_teddy_hash_confirm(
        corpus_u8.data_ptr(), corpus_u8.numel(), pos.data_ptr(),
        pos.numel(), tables.meta.data_ptr(), len(tables.groups),
        tables.slots.data_ptr(), pairs.data_ptr(), cap2, total.data_ptr(),
        stream)
    if rc:
        raise RuntimeError("teddy_hash_confirm launch failed: "
                           + lib.hs_teddy_hash_confirm_error(rc).decode())
    if pos.numel():
        LAUNCHES["teddy_hash_confirm"] += 1
    return pairs, total


# --------------------------------------------------------------------------
# the fused pipeline: start / finish / scan
# --------------------------------------------------------------------------


def _caps_for(lit, capacity: int) -> Tuple[int, int, int]:
    """(cap1, capc, cap2) for the next dispatch, learned from the running
    max of observed loads (~2x margins; cap1 1.25x, as in the reference's
    `_caps_for`) and kept on the lit object under this package's own
    attribute name."""
    obs = getattr(lit, "_torch_cap_obs", None)
    if obs is None:
        return (max(capacity, CAP1_FLOOR), CAPC_FLOOR,
                max(capacity // 4, CAP2_FLOOR))
    t1, h1, t2 = obs
    return (max(CAP1_FLOOR, _p2(5 * t1 // 4)),
            min(CELL, max(CAPC_FLOOR, _p2(2 * h1))),
            max(CAP2_FLOOR, _p2(2 * t2)))


def get_capacity_hint(obj, key: str) -> int:
    """Learned record capacity of one engine route (0 = none yet), kept
    on the engine under this package's own attribute name (reference:
    get_capacity_hint, hyperscan_tpu/ops/teddy.py:856)."""
    return getattr(obj, "_torch_cap_hints", {}).get(key, 0)


def set_capacity_hint(obj, key: str, capacity: int) -> None:
    obj.__dict__.setdefault("_torch_cap_hints", {})[key] = int(capacity)


def _observe_caps(lit, t1: int, h1: int, t2: int) -> None:
    obs = getattr(lit, "_torch_cap_obs", (0, 0, 0))
    lit._torch_cap_obs = tuple(max(a, b) for a, b in zip(obs, (t1, h1, t2)))


@dataclasses.dataclass
class ConfirmHandle:
    """A dispatched filter + confirm whose results are still on the
    device."""

    lit: object
    corpus: torch.Tensor
    n_valid: int
    caps: Tuple[int, int, int]  # (cap1, capc, cap2)
    meta: torch.Tensor  # int64 [3] = (candidate total, max cell, pairs)
    pairs: torch.Tensor  # int32 [cap2, 2] = (class id + 1, pos)


def confirm_start(corpus_u8: torch.Tensor, lit, n_valid: int,
                  capacity: int = 1 << 14) -> ConfirmHandle:
    """Dispatch filter, compaction, combine and hash confirm over the
    first `n_valid` bytes of a device corpus without waiting for them.
    The class tables are used whenever the alphabet compresses to 128
    classes or fewer, the byte tables otherwise."""
    if not 0 <= n_valid <= corpus_u8.numel():
        raise ValueError("n_valid outside the corpus")
    ft, ct = device_tables(lit, corpus_u8.device)
    cap1, capc, cap2 = _caps_for(lit, capacity)
    corpus = corpus_u8[:n_valid]
    pos_c, counts = filter_compact(corpus, ft, capc,
                                   use_classes=ft.cmasks is not None)
    meta1, pos = compact_combine(pos_c, counts, capc, cap1)
    pairs, total2 = hash_confirm(corpus, pos, ct, cap2)
    meta = torch.cat([meta1, total2.long()])
    return ConfirmHandle(lit, corpus_u8, n_valid, (cap1, capc, cap2),
                         meta, pairs)


def confirm_finish(handle: ConfirmHandle) -> Tuple[np.ndarray, np.ndarray]:
    """Fetch a started scan's hash-matched pairs as (fid_array,
    pos_array) — callers must exact-verify with
    runtime.lit_runtime.verify_pairs.

    Overflow never drops a match: when a cell's exact count is above
    capc, the candidate total above cap1 or the confirmed total above
    cap2, the scan is dispatched again on the device with the learned
    capacities (each at least the next power of two of what overflowed).
    capc cannot grow past one cell, so this ends."""
    from ..runtime.lit_runtime import expand_confirm_classes

    while True:
        t1, h1, t2 = (int(x) for x in handle.meta.tolist())
        _observe_caps(handle.lit, t1, h1, t2)
        cap1, capc, cap2 = handle.caps
        if h1 <= capc and t1 <= cap1 and t2 <= cap2:
            break
        handle = confirm_start(handle.corpus, handle.lit, handle.n_valid)
    if t2 == 0:
        z = np.zeros(0, dtype=np.int64)
        return z, z
    pairs = handle.pairs[:t2].long()
    key = torch.sort((pairs[:, 1] << 20) | pairs[:, 0]).values.cpu().numpy()
    cls = (key & 0xFFFFF) - 1
    pos = key >> 20
    return expand_confirm_classes(handle.lit, cls, pos)


def confirm_scan(corpus_u8: torch.Tensor, lit, n_valid: int,
                 capacity: int = 1 << 14) -> Tuple[np.ndarray, np.ndarray]:
    """Filter + hash confirm over a device corpus: hash-matched
    (fid_array, pos_array) pairs (see confirm_finish)."""
    return confirm_finish(confirm_start(corpus_u8, lit, n_valid, capacity))
