"""The kconfirm family on a torch device: the Teddy filter with the hash
confirm inside the kernel, over bucket-row confirm tables.

Reference counterpart: the in-kernel confirm of the JAX package
(`_confirm_epilogue`, hyperscan_tpu/ops/teddy.py:258, run by the
pallas_call at :1081), its tables `dev_confirm_planes` (:1506) and its
combine `kconf_combine` (:1156). Kernel: `csrc/teddy_kconfirm.cu`, one
library for the scan path and the stage modes (the stage is a kernel
argument).

The tables are the reference's bucket rows: per confirm group, every
distinct masked tail value lives in row `hash & (t_rows - 1)` with the
16-bit signature `hash >> 16`, rows filled in the reference's order. Its
bf16 signature halves are a TPU layout; here a slot holds one uint16
signature and its class, and each row its fill count. The kernel
confirms every candidate of a cell, so the reference's capc, its XLA
sidecar for cells past capc (kconf_combine :1206-1231) and its limit of
two matches per row probe have no counterpart: the hash-matched set
equals the reference's wherever the reference needed no sidecar.

`filter_kconfirm(..., stage=s)` cuts the kernel after each part of the
confirm, for the stage probe (tools/kconf_probe.py; the counterpart of
the reference's stage-bisect probes and its `_KCONF_STAGE` knob, which
is not an environment variable, and neither is this): stages 0-2 return
per-cell (candidates, checksum, matches), see `filter_kconfirm_stage_plain`.
No scan path passes a stage.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ._build import LAUNCHES
from .teddy import (CELL, _PLAIN_CHUNK_CELLS, FilterTables,
                    _candidates_plain, _cell_slots, _i32, _mul32, _n_cells,
                    _on_card, _table_args, _tail_words)

# the reference's limits (hyperscan_tpu/ops/teddy.py:214-219), unchanged
CAPC2 = 128  # matches a cell keeps in the kconfirm family
KCONF_TABLE_BUDGET = 6 << 20  # the reference's table budget (bytes of its
# two bf16 signature planes), which decides whether kconfirm exists
_MAX_GROUPS = 64  # the kernel's shared group table (the reference's
# limit: 2 planes a group, at most 128)
_PLAIN_BATCH = 1 << 15  # candidates per step of the plain row compare


@dataclasses.dataclass
class KconfTables:
    """Bucket-row confirm tables on one device. Group g's rows start at
    row base_g / 128 of the shared arrays."""

    groups: Tuple[Tuple[int, int, int, int, int], ...]
    # (cl, mlo, mhi, t_rows, base slot) per group, as Python ints
    meta: torch.Tensor  # [G, 5] int32, the same (mlo/mhi as bit patterns)
    sigs: torch.Tensor  # int16 [S]: each slot's 16-bit signature
    fills: torch.Tensor  # uint8 [S / 128]: occupied slots of each row
    cls: torch.Tensor  # int32 [S]: each slot's class id + 1 (0 = empty)


def _build_planes(lit):
    """The bucket-row tables in numpy, or None past the reference's
    limits (its table budget, more than 64 groups, 2^24 slots or more)."""
    from ..runtime.lit_runtime import _avalanche32, _confirm_index

    packed, _flen = _confirm_index(lit)
    groups, sigs, fills, clss = [], [], [], []
    base = next_cls = 0
    for (cl, mask64, vals, _fids, _long) in packed:
        shift = np.uint64(8 * (8 - cl))
        mask_f = int(mask64) << int(shift)
        uvals = np.unique(vals << shift)
        F = len(uvals)
        # class ids follow confirm_device_tables' numbering (np.unique
        # order), so the host's class expansion is shared
        cids = np.arange(next_cls, next_cls + F, dtype=np.int64)
        next_cls += F
        lo = (uvals & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        hi = (uvals >> np.uint64(32)).astype(np.uint32)
        hm = _avalanche32(
            (lo * np.uint32(0x9E3779B1)) ^ (hi * np.uint32(0x85EBCA6B)))
        t_rows = 8
        while t_rows * 80 < F:  # at most ~62% row load
            t_rows *= 2
        while True:  # the reference's row fill (dev_confirm_planes)
            rows_i = (hm & np.uint32(t_rows - 1)).astype(np.int64)
            order = np.argsort(rows_i, kind="stable")
            lane = np.zeros(F, np.int64)
            fill = np.zeros(t_rows, np.int64)
            ok = True
            for j in order.tolist():
                r = rows_i[j]
                if fill[r] >= 128:
                    ok = False
                    break
                lane[j] = fill[r]
                fill[r] += 1
            if ok:
                break
            t_rows *= 2
        sig = np.zeros(t_rows * 128, np.uint16)
        cls = np.zeros(t_rows * 128, np.int32)
        sig[rows_i * 128 + lane] = (hm >> np.uint32(16)).astype(np.uint16)
        cls[rows_i * 128 + lane] = cids + 1
        groups.append((int(cl), mask_f & 0xFFFFFFFF,
                       (mask_f >> 32) & 0xFFFFFFFF, t_rows, base))
        sigs.append(sig)
        fills.append(fill.astype(np.uint8))
        clss.append(cls)
        base += t_rows * 128
    plane_bytes = 4 * base  # the reference's two bf16 planes a slot
    if plane_bytes > KCONF_TABLE_BUDGET or len(groups) > _MAX_GROUPS \
            or base >= (1 << 24):
        return None

    def cat(parts, dtype):
        return np.concatenate(parts) if parts else np.zeros(128, dtype)

    return (tuple(groups), cat(sigs, np.uint16), cat(fills, np.uint8),
            cat(clss, np.int32))


def confirm_planes(lit, device) -> Optional[KconfTables]:
    """The kconfirm tables on `device`, or None when they pass the
    reference's limits (then kconfirm is never chosen). Cached on the lit
    object per device."""
    device = torch.device(device)
    cache = lit.__dict__.setdefault("_torch_kconf", {})
    if "numpy" not in cache:
        cache["numpy"] = _build_planes(lit)
    key = str(device)
    if key not in cache:
        built = cache["numpy"]
        if built is None:
            cache[key] = None
        else:
            groups, sigs, fills, cls = built
            meta = np.asarray([(cl, _i32(mlo), _i32(mhi), tr, b)
                               for (cl, mlo, mhi, tr, b) in groups],
                              np.int32).reshape(-1, 5)
            if not len(groups):
                meta = np.zeros((1, 5), np.int32)
            cache[key] = KconfTables(
                groups, torch.from_numpy(meta).to(device),
                torch.from_numpy(sigs.view(np.int16)).to(device),
                torch.from_numpy(fills).to(device),
                torch.from_numpy(cls).to(device))
    return cache[key]


def _hash(lo: torch.Tensor, hi: torch.Tensor, mlo: int, mhi: int):
    """The confirm hash of masked tail words (int64 holding uint32
    values), mirroring runtime.lit_runtime._avalanche32."""
    h = _mul32(lo & mlo, 0x9E3779B1) ^ _mul32(hi & mhi, 0x85EBCA6B)
    h = h ^ (h >> 15)
    h = _mul32(h, 0x2C1B3C6D)
    return h ^ (h >> 13)


def _matches_plain(corpus_u8, p: torch.Tensor, kt: KconfTables):
    """(pos, global slot) of every hash match of the candidates p."""
    lo_w, hi_w = _tail_words(corpus_u8, p,
                             torch.ones_like(p, dtype=torch.bool))
    sigs = kt.sigs.long() & 0xFFFF
    fills = kt.fills.long()
    lanes = torch.arange(128, device=p.device)
    out_p, out_s = [], []
    for (cl, mlo, mhi, t_rows, base) in kt.groups:
        h = _hash(lo_w, hi_w, mlo, mhi)
        row = base // 128 + (h & (t_rows - 1))
        sig = h >> 16
        ok = p >= cl - 1
        for b0 in range(0, p.numel(), _PLAIN_BATCH):
            sl = slice(b0, b0 + _PLAIN_BATCH)
            slot = row[sl, None] * 128 + lanes[None, :]
            m = (sigs[slot] == sig[sl, None]) \
                & (lanes[None, :] < fills[row[sl]][:, None]) & ok[sl, None]
            i, lane = torch.nonzero(m, as_tuple=True)
            out_p.append(p[sl][i])
            out_s.append(slot[i, lane])
    if not out_p:
        z = torch.zeros(0, dtype=torch.int64, device=p.device)
        return z, z
    return torch.cat(out_p), torch.cat(out_s)


def filter_kconfirm_plain(corpus_u8: torch.Tensor, tables: FilterTables,
                          kt: KconfTables, *, use_classes: bool):
    """Plain PyTorch version of `filter_kconfirm` (same contract, the
    same (pos, slot) order inside a cell)."""
    n = corpus_u8.numel()
    n_cells = _n_cells(n)
    dev = corpus_u8.device
    cand = torch.zeros(n_cells, dtype=torch.int32, device=dev)
    conf = torch.zeros(n_cells, dtype=torch.int32, device=dev)
    out_pos = torch.zeros((n_cells, CAPC2), dtype=torch.int32, device=dev)
    out_cls = torch.zeros((n_cells, CAPC2), dtype=torch.int32, device=dev)
    for c0 in range(0, n_cells, _PLAIN_CHUNK_CELLS):
        c1 = min(n_cells, c0 + _PLAIN_CHUNK_CELLS)
        lo, hi = c0 * CELL, min(n, c1 * CELL)
        if hi <= lo:
            break
        p = torch.nonzero(
            _candidates_plain(corpus_u8, tables, use_classes, lo, hi)
        ).squeeze(1) + lo
        cand[c0:c1] = torch.bincount(torch.div(p, CELL, rounding_mode="floor")
                                     - c0, minlength=c1 - c0).int()
        mp, ms = _matches_plain(corpus_u8, p, kt)
        order = torch.argsort((mp << 24) | ms)
        mp, ms = mp[order], ms[order]
        cell = torch.div(mp, CELL, rounding_mode="floor")
        cnt = torch.bincount(cell - c0, minlength=c1 - c0)
        conf[c0:c1] = cnt.int()
        first = torch.cumsum(cnt, 0) - cnt
        rank = torch.arange(mp.numel(), device=dev) - first[cell - c0]
        keep = rank < CAPC2
        out_pos[cell[keep], rank[keep]] = mp[keep].int()
        out_cls[cell[keep], rank[keep]] = kt.cls[ms[keep]]
    return cand, conf, out_pos, out_cls


STAGES = (0, 1, 2, 3)  # the kernel's stage modes; 3 is the full kernel


def _as_i32(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensors of the same bits."""
    return torch.where(v >= 1 << 31, v - (1 << 32), v).int()


def filter_kconfirm_stage_plain(corpus_u8: torch.Tensor,
                                tables: FilterTables, kt: KconfTables, *,
                                use_classes: bool, stage: int):
    """Plain PyTorch version of `filter_kconfirm` at stage 0, 1 or 2.

    Returns int32 [n_cells] each:
    - cand: the exact candidates of each cell (every stage);
    - chk: stages 1-2, the sum mod 2^32 (as int32 bits) over the cell's
      candidates p and the confirm groups (cl, mlo, mhi) with
      p >= cl - 1 of the group's avalanche hash of p's 8 tail bytes;
      0 at stage 0;
    - conf: stage 2, the exact hash matches of each cell (the count that
      stage 3 returns); 0 at stages 0-1."""
    if stage not in (0, 1, 2):
        raise ValueError(f"stage {stage} is not a stage mode (0, 1, 2)")
    n = corpus_u8.numel()
    n_cells = _n_cells(n)
    dev = corpus_u8.device
    cand = torch.zeros(n_cells, dtype=torch.int64, device=dev)
    chk = torch.zeros(n_cells, dtype=torch.int64, device=dev)
    conf = torch.zeros(n_cells, dtype=torch.int64, device=dev)
    for c0 in range(0, n_cells, _PLAIN_CHUNK_CELLS):
        c1 = min(n_cells, c0 + _PLAIN_CHUNK_CELLS)
        lo, hi = c0 * CELL, min(n, c1 * CELL)
        if hi <= lo:
            break
        p = torch.nonzero(
            _candidates_plain(corpus_u8, tables, use_classes, lo, hi)
        ).squeeze(1) + lo
        cell = torch.div(p, CELL, rounding_mode="floor")
        cand[c0:c1] = torch.bincount(cell - c0, minlength=c1 - c0)
        if stage == 0:
            continue
        lo_w, hi_w = _tail_words(corpus_u8, p,
                                 torch.ones_like(p, dtype=torch.bool))
        for (cl, mlo, mhi, _t_rows, _base) in kt.groups:
            h = _hash(lo_w, hi_w, mlo, mhi) * (p >= cl - 1)
            chk.index_add_(0, cell, h)
        chk &= 0xFFFFFFFF
        if stage == 2:
            mp, _ms = _matches_plain(corpus_u8, p, kt)
            conf[c0:c1] = torch.bincount(
                torch.div(mp, CELL, rounding_mode="floor") - c0,
                minlength=c1 - c0)
    return cand.int(), _as_i32(chk), conf.int()


def _lib():
    from ._build import library

    lib = library("teddy_kconfirm")
    if not getattr(lib, "_typed", False):
        vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.hs_teddy_kconfirm.restype = ci
        lib.hs_teddy_kconfirm.argtypes = [
            vp, cll, vp, vp, ci, ci, ci, vp, ci, vp, vp, vp, ci, vp, vp, vp,
            vp, vp, ci, vp]
        lib.hs_teddy_kconfirm_error.restype = ctypes.c_char_p
        lib.hs_teddy_kconfirm_error.argtypes = [ci]
        lib._typed = True
    return lib


def filter_kconfirm(corpus_u8: torch.Tensor, tables: FilterTables,
                    kt: KconfTables, *, use_classes: bool, stage: int = 3):
    """Kernel 4: Teddy filter + hash confirm of every candidate.

    Returns (cand_counts int32 [n_cells]: exact candidates a cell;
    conf_counts int32 [n_cells]: exact hash matches a cell; pos, cls
    int32 [n_cells, CAPC2]: the cell's first CAPC2 matches as (position,
    class id + 1), in (position, slot) order).

    `stage` 0, 1 or 2 runs the kernel cut after that part of the confirm
    (the stage probe's modes, counted under `teddy_kconfirm_stage`) and
    returns (cand, chk, conf) as `filter_kconfirm_stage_plain` does."""
    if stage not in STAGES:
        raise ValueError(f"stage {stage} is not one of {STAGES}")
    if not _on_card(corpus_u8, tables, use_classes):
        if stage == 3:
            return filter_kconfirm_plain(corpus_u8, tables, kt,
                                         use_classes=use_classes)
        return filter_kconfirm_stage_plain(corpus_u8, tables, kt,
                                           use_classes=use_classes,
                                           stage=stage)
    if kt.sigs.device != corpus_u8.device:
        raise ValueError("confirm tables and corpus lie on different "
                         "devices")
    lib = _lib()
    n = corpus_u8.numel()
    n_cells = _n_cells(n)
    dev = corpus_u8.device
    cand = torch.empty(n_cells, dtype=torch.int32, device=dev)
    conf = torch.empty(n_cells, dtype=torch.int32, device=dev)
    if stage == 3:
        out_pos = torch.empty((n_cells, CAPC2), dtype=torch.int32,
                              device=dev)
        out_cls = torch.empty((n_cells, CAPC2), dtype=torch.int32,
                              device=dev)
        bufs = (out_pos.data_ptr(), out_cls.data_ptr(), None)
    else:
        chk = torch.empty(n_cells, dtype=torch.int32, device=dev)
        bufs = (None, None, chk.data_ptr())
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.hs_teddy_kconfirm(
        corpus_u8.data_ptr(), n, *_table_args(tables, use_classes),
        kt.meta.data_ptr(), len(kt.groups), kt.sigs.data_ptr(),
        kt.fills.data_ptr(), kt.cls.data_ptr(), stage, cand.data_ptr(),
        conf.data_ptr(), *bufs, n_cells, stream)
    if rc:
        raise RuntimeError("teddy_kconfirm launch failed: "
                           + lib.hs_teddy_kconfirm_error(rc).decode())
    if stage == 3:
        LAUNCHES["teddy_kconfirm"] += 1
        return cand, conf, out_pos, out_cls
    LAUNCHES["teddy_kconfirm_stage"] += 1
    return cand, chk, conf


def kconf_combine(cand: torch.Tensor, conf: torch.Tensor,
                  pos: torch.Tensor, cls: torch.Tensor, cap2: int):
    """Per-cell matches -> one list of `cap2` (class id + 1, pos) pairs
    (0 past the valid ones), in plain torch over O(n_cells) counts
    (reference: kconf_combine, hyperscan_tpu/ops/teddy.py:1156, without
    its sidecar).

    Returns (meta int64 [4] = (candidate total, max cell candidates,
    match total, max cell matches), pairs int32 [cap2, 2])."""
    cell, within, have = _cell_slots(conf, CAPC2, cap2)
    zero = torch.zeros(1, dtype=torch.int32, device=pos.device)
    pairs = torch.stack([torch.where(have, cls[cell, within], zero),
                         torch.where(have, pos[cell, within], zero)], 1)
    meta = torch.stack([cand.long().sum(), cand.long().max(),
                        conf.long().sum(), conf.long().max()])
    return meta, pairs
