"""The gated family's two stages on a torch device: the single-word gate
with one flag per 128-byte row, and the full filter over the flagged rows.

Reference counterpart: `filter_confirm_body_gated`
(hyperscan_tpu/ops/teddy.py:1342) with `_make_kernel_gate` (:649, the
pallas_call at :1381), `dev_gate_table` (:1644) and stage 2's
`_make_kernel_fused_classes` over the survivor rows (the pallas_call at
:1424). Kernels: `csrc/teddy_gate.cu` (`gate_rows`) and
`csrc/teddy_rescan_rows.cu` (`rescan_rows`).

The reference lists the survivors at a learned capacity capK by a cumsum
and a searchsorted over every row, packs (predecessor, row) pairs into a
second rows array for the TPU's cross-row shift, and extracts the
candidates of the packed plane. Here each warp of stage 2 lists the
flagged rows of its own cell and reads each row and its look-back from
the flat corpus, so no survivor list, capacity or packing exists; stage
2 has kernel A's output contract, which `compact_combine` takes as it is.
The survivor count K (flagged rows below n) is still summed, for the
family switch at GATE_ROW_FRAC. The reference's `_hi_class` fast path
(:1633, one remap gather when every high byte shares a class) has no
counterpart: the CUDA kernels remap through one shared-memory lookup
either way.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ._build import LAUNCHES
from .teddy import (CELL, ROW, FilterTables, _candidates_plain,
                    _class_split, _n_cells, _on_card, _table_args,
                    device_tables, filter_compact_plain)

ROWS_PER_CELL = CELL // ROW


@dataclasses.dataclass
class GateTables:
    """The gate on one device: the full masks' byte->class remap and the
    gate word of every class and suffix offset."""

    b2c: torch.Tensor  # [256] uint8 (the filter's class remap)
    gcm: torch.Tensor  # [M, 128] int32
    vec: torch.Tensor  # [256, M] int32, the kernel's form (gate_vectors)

    @property
    def M(self) -> int:
        return int(self.gcm.shape[0])

    @property
    def as_filter(self) -> FilterTables:
        """The gate as a one-word class-table filter (W = 1), the form
        the filter's plain version and checks take. At W = 1 the kernels'
        [M, K, Wp] layout is `gcm` itself (a view: no padded words)."""
        g = self.gcm[:, None, :]
        return FilterTables(g, self.b2c, g, None, self.gcm[:, :, None])


def gate_vectors(b2c: np.ndarray, gcm: np.ndarray) -> np.ndarray:
    """The gate as the kernel reads it: byte b's vector of M words,
    vec[b, m] = gcm[m, b2c[b]] (the class remap folded into the table).
    [256, M] int32 from b2c [256] and gcm [M, 128]."""
    b2c = np.asarray(b2c, np.int64)
    return np.ascontiguousarray(np.asarray(gcm, np.int32)[:, b2c].T)


def gate_tables(b2c: torch.Tensor, gcm: np.ndarray) -> GateTables:
    """GateTables on b2c's device from the remap and the gate words."""
    vec = gate_vectors(b2c.cpu().numpy(), gcm)
    dev = b2c.device
    return GateTables(b2c, torch.from_numpy(np.ascontiguousarray(
        gcm, np.int32)).to(dev), torch.from_numpy(vec).to(dev))


def device_gate_table(lit, device) -> Optional[GateTables]:
    """The gate tables on `device`, or None when the database has no gate
    (`lit.gate_masks` is None) or its alphabet does not compress to 128
    classes (reference: dev_gate_table, hyperscan_tpu/ops/teddy.py:1644).
    The gate bits are ORs of full-mask bucket bits, so the gate word is
    constant within every byte class of the full masks: class c takes the
    gate word of its first byte. Cached on the lit object per device."""
    if getattr(lit, "gate_masks", None) is None:
        return None
    device = torch.device(device)
    cache = lit.__dict__.setdefault("_torch_gate", {})
    key = str(device)
    if key not in cache:
        ft, _ct = device_tables(lit, device)
        split = _class_split(np.ascontiguousarray(lit.masks, np.int32))
        if split is None:
            cache[key] = None
        else:
            inv = np.concatenate([split[0][0], split[0][1]])
            rep = np.zeros(128, np.int64)  # class id -> its first byte
            for b in range(255, -1, -1):
                rep[inv[b]] = b
            cache[key] = gate_tables(ft.b2c, lit.gate_masks[:, 0, rep])
    return cache[key]


def gate_rows_plain(corpus_u8: torch.Tensor, gate: GateTables
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of `gate_rows` (same contract)."""
    n = corpus_u8.numel()
    n_cells = _n_cells(n)
    flags = torch.zeros(n_cells * ROWS_PER_CELL, dtype=torch.uint8,
                        device=corpus_u8.device)
    step = 256 * CELL
    for lo in range(0, n, step):
        hi = min(n, lo + step)
        hit = _candidates_plain(corpus_u8, gate.as_filter, True, lo, hi)
        pad = -(hi - lo) % ROW
        if pad:
            hit = torch.cat([hit, hit.new_zeros(pad)])
        flags[lo // ROW:lo // ROW + hit.numel() // ROW] = \
            hit.reshape(-1, ROW).any(1).to(torch.uint8)
    counts = flags.reshape(n_cells, ROWS_PER_CELL).sum(1, dtype=torch.int32)
    return flags, counts


def _gate_lib():
    from ._build import library

    lib = library("teddy_gate")
    if not getattr(lib, "_typed", False):
        vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.hs_teddy_gate.restype = ci
        lib.hs_teddy_gate.argtypes = [vp, cll, vp, ci, vp, vp, ci, vp]
        lib.hs_teddy_gate_error.restype = ctypes.c_char_p
        lib.hs_teddy_gate_error.argtypes = [ci]
        lib._typed = True
    return lib


def gate_rows(corpus_u8: torch.Tensor, gate: GateTables
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel 5: the single-word gate, one flag per 128-byte row.

    A position p < n passes when AND_{m<M} gcm[m][b2c[byte p - m]] != 0
    (a zero byte before offset 0). Returns (flags uint8 [n_cells * 512]:
    1 for a row with a passing position, 0 otherwise and past n; counts
    int32 [n_cells]: flagged rows per 64 KiB cell). A row whose flag is 0
    holds no candidate of the full filter."""
    if not _on_card(corpus_u8, gate.as_filter, True):
        return gate_rows_plain(corpus_u8, gate)
    lib = _gate_lib()
    n = corpus_u8.numel()
    n_cells = _n_cells(n)
    flags = torch.empty(n_cells * ROWS_PER_CELL, dtype=torch.uint8,
                        device=corpus_u8.device)
    counts = torch.empty(n_cells, dtype=torch.int32, device=corpus_u8.device)
    stream = torch.cuda.current_stream(corpus_u8.device).cuda_stream
    if gate.vec.device != corpus_u8.device or \
            gate.vec.shape != (256, gate.M):
        raise ValueError("gate vectors must be [256, M] on the corpus's "
                         "device")
    rc = lib.hs_teddy_gate(corpus_u8.data_ptr(), n, gate.vec.data_ptr(),
                           gate.M, flags.data_ptr(), counts.data_ptr(),
                           n_cells, stream)
    if rc:
        raise RuntimeError("teddy_gate launch failed: "
                           + lib.hs_teddy_gate_error(rc).decode())
    LAUNCHES["teddy_gate"] += 1
    return flags, counts


def _rescan_lib():
    from ._build import library

    lib = library("teddy_rescan_rows")
    if not getattr(lib, "_typed", False):
        vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.hs_teddy_rescan_rows.restype = ci
        lib.hs_teddy_rescan_rows.argtypes = [
            vp, cll, vp, vp, ci, ci, ci, vp, vp, vp, vp, ci, vp]
        lib.hs_teddy_rescan_rows_error.restype = ctypes.c_char_p
        lib.hs_teddy_rescan_rows_error.argtypes = [ci]
        lib._typed = True
    return lib


def rescan_rows(corpus_u8: torch.Tensor, tables: FilterTables,
                flags: torch.Tensor, capc: int,
                row_counts: Optional[torch.Tensor] = None):
    """Kernel 6: the full class filter over the flagged rows only.

    flags      : uint8 [n_cells * 512] row flags (`gate_rows`)
    row_counts : optional int32 [n_cells], the flagged rows of each cell
                 (`gate_rows`' counts, the sums of `flags`); the kernel
                 then reads no flag of a cell whose count is 0. The plain
                 version ignores it: the output is the same either way.
    Returns kernel A's (pos [n_cells, capc] int32, ascending; counts
    [n_cells] int32, exact) over the candidates inside flagged rows —
    equal to `filter_compact`'s output, since the gate is a superset."""
    if capc < 1:
        raise ValueError("capc must be positive")
    n = corpus_u8.numel()
    n_cells = _n_cells(n)
    if flags.dtype != torch.uint8 or \
            flags.shape != (n_cells * ROWS_PER_CELL,):
        raise ValueError("flags must be uint8 [n_cells * 512]")
    if row_counts is not None and (row_counts.dtype != torch.int32 or
                                   row_counts.shape != (n_cells,)):
        raise ValueError("row_counts must be int32 [n_cells]")
    if not _on_card(corpus_u8, tables, True):
        return filter_compact_plain(corpus_u8, tables, capc,
                                    use_classes=True, row_flags=flags)
    flags = flags.contiguous()
    if flags.device != corpus_u8.device or (
            row_counts is not None and row_counts.device != flags.device):
        raise ValueError("flags, row counts and corpus lie on different "
                         "devices")
    if flags.data_ptr() % 16:
        raise ValueError("flags must be 16-byte aligned (vector loads)")
    lib = _rescan_lib()
    pos = torch.empty((n_cells, capc), dtype=torch.int32,
                      device=corpus_u8.device)
    counts = torch.empty(n_cells, dtype=torch.int32, device=corpus_u8.device)
    stream = torch.cuda.current_stream(corpus_u8.device).cuda_stream
    b2c, tab, M, Wp, _classes = _table_args(tables, True)
    rc = lib.hs_teddy_rescan_rows(
        corpus_u8.data_ptr(), n, b2c, tab, M, Wp, capc, flags.data_ptr(),
        None if row_counts is None else row_counts.contiguous().data_ptr(),
        pos.data_ptr(), counts.data_ptr(), n_cells, stream)
    if rc:
        raise RuntimeError("teddy_rescan_rows launch failed: "
                           + lib.hs_teddy_rescan_rows_error(rc).decode())
    LAUNCHES["teddy_rescan_rows"] += 1
    return pos, counts
