"""The standalone Teddy filter on a torch device: every candidate position
with its W bucket words.

Reference counterpart: `teddy_scan` / `teddy_scan_rows`
(hyperscan_tpu/ops/teddy.py:958, :911) over the Pallas kernel
`_make_kernel` (:37, launched at :762) and `sparse_extract` (:793), and
the per-shard launch of the same kernel in `sharded_teddy_count`
(hyperscan_tpu/parallel/sharded.py:237). For a position p and bucket word
w,

  word_w(p) = AND_{m<M} masks[m][w][byte(p - m)]   (zero bytes before 0)

and p is a candidate when the OR of its words is nonzero. Kernel 7
(`csrc/teddy_words.cu`) has two modes: `filter_words_count` writes each
64 KiB cell's candidate count (and, when asked, each 512-byte segment's),
`filter_words_list` every candidate's position and words at its rank
(the prefix sum of the segment counts), exact and in ascending order,
re-filtering only the segments that hold candidates. Both count their
launches in `LAUNCHES`; for a CPU tensor they run the plain PyTorch
version `filter_words_plain`, which is also what the kernel is held
against on the card.

The tables are `FilterTables` (`teddy.mask_tables`): the raw
`[M, W, 256]` int32 masks (`lit.masks`), and the class tables (`b2c`,
`[M, W, 128]` `cmasks`) beside them when the 256 bytes fall into at
most 128 classes of equal columns; each with its `[M, K, Wp]` packing,
which the kernel reads. Both routes give the same words bit for bit (a
class's column is each of its bytes' column); the class route is the
default where it exists, and `use_classes=` forces either. The sign
bit is in use: words are compared bitwise, never as ordered values. The
corpus is a flat uint8 tensor; the first `start` bytes of it are
look-back only (a shard's view of the bytes before its segment). The
reference's 128-lane rows with a zero halo row and its `bucket_up`
shapes are TPU layout and are not carried over.

This module sits below `teddy_families` beside the other kernel wrappers:
it imports `teddy`, and nothing it imports imports it.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from ..trace import count
from ._build import LAUNCHES
from .teddy import (_PLAIN_CHUNK_CELLS, CELL, FilterTables, _check_corpus,
                    _n_cells, _p2, get_capacity_hint, mask_tables,
                    set_capacity_hint)

HINT_KEY = "teddy"  # the learned list capacity (reference: "teddy")
SEG = 512  # bytes of a count-mode segment: one warp's share of a step


def n_segments(n: int) -> int:
    """Segments of an n-byte corpus: ceil(n / SEG) (0 for n = 0)."""
    return -(-n // SEG)


def _route(tables: FilterTables, use_classes: Optional[bool]) -> bool:
    """The table route of a call: the class tables when asked (they must
    exist) or, by default, where the alphabet compressed to them."""
    if use_classes is None:
        return tables.cmasks is not None
    if use_classes and tables.cmasks is None:
        raise ValueError("class tables requested but the alphabet does "
                         "not compress to 128 classes")
    return bool(use_classes)


def _check(corpus_u8: torch.Tensor, tables: FilterTables, start: int,
           classes: bool) -> bool:
    """Check a kernel-7 call's inputs; True when the kernel runs (a CUDA
    corpus), False when the plain version does (a CPU one)."""
    _check_corpus(corpus_u8)
    masks = tables.masks
    if masks.dtype != torch.int32 or masks.dim() != 3 or \
            masks.shape[2] != 256 or not masks.is_contiguous():
        raise ValueError("masks must be a contiguous int32 [M, W, 256] "
                         "tensor")
    if not 1 <= masks.shape[0] <= 8:
        raise ValueError(f"suffix depth M={masks.shape[0]} outside 1..8")
    if not 0 <= start <= corpus_u8.numel():
        raise ValueError("start outside the corpus")
    if masks.device != corpus_u8.device:
        raise ValueError("masks and corpus lie on different devices")
    if corpus_u8.device.type == "cpu":
        return False
    if corpus_u8.device.type != "cuda":
        raise ValueError(f"unsupported device {corpus_u8.device}")
    if (tables.cpacked if classes else tables.packed) is None:
        raise ValueError("tables without the kernel's layout (build them "
                         "with teddy.mask_tables)")
    if classes and tables.b2c.device != corpus_u8.device:
        raise ValueError("class map and corpus lie on different devices")
    if corpus_u8.data_ptr() % 16:
        raise ValueError("corpus must be 16-byte aligned (vector loads)")
    return True


def _words_plain(corpus_u8: torch.Tensor, tab: torch.Tensor,
                 b2c: Optional[torch.Tensor], lo: int, hi: int
                 ) -> torch.Tensor:
    """int32 [W, hi - lo]: the words of positions lo..hi-1 from the
    [M, W, K] tables `tab`, keyed by the byte or, with `b2c`, by its
    class, with zero bytes before offset 0."""
    M, W = int(tab.shape[0]), int(tab.shape[1])
    first = max(0, lo - (M - 1))
    seg = corpus_u8[first:hi].long()
    pad = (M - 1) - (lo - first)
    if pad:
        seg = torch.cat([seg.new_zeros(pad), seg])
    # seg[k] is the byte at lo - (M - 1) + k
    key = seg if b2c is None else b2c.long()[seg]
    L = hi - lo
    out = []
    for w in range(W):
        acc = tab[0, w][key[M - 1:M - 1 + L]]
        for m in range(1, M):
            acc = acc & tab[m, w][key[M - 1 - m:M - 1 - m + L]]
        out.append(acc)
    return torch.stack(out)


def filter_words_plain(corpus_u8: torch.Tensor, tables: FilterTables,
                       start: int = 0, *, use_classes: bool = False):
    """Plain PyTorch version of kernel 7, both modes at once: returns
    (counts int32 [n_cells], positions int32 [total] ascending, words
    int32 [W, total]); positions are p - start. Reads the byte tables,
    or the class tables with `use_classes` (the same words). Works chunk
    by chunk, so its memory stays bounded by the corpus size and the
    candidates."""
    tab, b2c = ((tables.cmasks, tables.b2c) if use_classes
                else (tables.masks, None))
    n = corpus_u8.numel()
    dev = corpus_u8.device
    W = tables.W
    counts = torch.zeros(_n_cells(n), dtype=torch.int32, device=dev)
    pos_l, words_l = [], []
    step = _PLAIN_CHUNK_CELLS * CELL
    for lo in range(start, n, step):
        hi = min(n, lo + step)
        w = _words_plain(corpus_u8, tab, b2c, lo, hi)
        nz = torch.nonzero((w != 0).any(0)).squeeze(1)
        p = nz + lo
        counts += torch.bincount(torch.div(p, CELL, rounding_mode="floor"),
                                 minlength=counts.numel()).int()
        pos_l.append((p - start).int())
        words_l.append(w[:, nz])
    pos = (torch.cat(pos_l) if pos_l
           else torch.zeros(0, dtype=torch.int32, device=dev))
    words = (torch.cat(words_l, 1) if words_l
             else torch.zeros((W, 0), dtype=torch.int32, device=dev))
    return counts, pos, words


def segment_counts(pos: torch.Tensor, n: int, start: int = 0
                   ) -> torch.Tensor:
    """int32 [n_segments(n)]: the candidates of each SEG-byte segment of
    an n-byte corpus, from the plain version's positions (p - start)."""
    return torch.bincount(torch.div(pos.long() + start, SEG,
                                    rounding_mode="floor"),
                          minlength=n_segments(n)).int()


def _lib():
    from ._build import library

    lib = library("teddy_words")
    if not getattr(lib, "_typed", False):
        vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.hs_teddy_words_count.restype = ci
        lib.hs_teddy_words_count.argtypes = [
            vp, cll, cll, vp, vp, ci, ci, ci, ci, vp, ci, vp, cll, vp]
        lib.hs_teddy_words_list.restype = ci
        lib.hs_teddy_words_list.argtypes = [
            vp, cll, cll, vp, vp, ci, ci, ci, ci, vp, vp, cll, cll, vp, vp,
            vp]
        lib.hs_teddy_words_error.restype = ctypes.c_char_p
        lib.hs_teddy_words_error.argtypes = [ci]
        lib._typed = True
    return lib


def _raise_on(rc: int, lib, what: str) -> None:
    if rc:
        raise RuntimeError(f"{what} launch failed: "
                           + lib.hs_teddy_words_error(rc).decode())


def _table_args(tables: FilterTables, classes: bool):
    """(b2c pointer or None, packed table pointer, M, W, Wp, classes
    flag) of the kernel's call."""
    tab = tables.cpacked if classes else tables.packed
    return (tables.b2c.data_ptr() if classes else None, tab.data_ptr(),
            tables.M, tables.W, int(tab.shape[2]), int(classes))


def filter_words_count(corpus_u8: torch.Tensor, tables: FilterTables,
                       start: int = 0, *, segments: bool = False,
                       use_classes: Optional[bool] = None):
    """Kernel 7, count mode: int32 [n_cells] (n_cells = max(1,
    ceil(n / 65536))), the exact number of candidates among the
    positions start <= p < n of each 64 KiB cell of the tensor. With
    `segments`, returns (that, int32 [n_segments(n)]: the same for each
    SEG-byte segment), the input of list mode."""
    classes = _route(tables, use_classes)
    n = corpus_u8.numel()
    if not _check(corpus_u8, tables, start, classes):
        counts, pos, _w = filter_words_plain(corpus_u8, tables, start,
                                             use_classes=classes)
        return (counts, segment_counts(pos, n, start)) if segments \
            else counts
    lib = _lib()
    dev = corpus_u8.device
    counts = torch.empty(_n_cells(n), dtype=torch.int32, device=dev)
    segs = (torch.empty(n_segments(n), dtype=torch.int32, device=dev)
            if segments else None)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.hs_teddy_words_count(
        corpus_u8.data_ptr(), n, start, *_table_args(tables, classes),
        counts.data_ptr(), counts.numel(),
        None if segs is None else segs.data_ptr(), n_segments(n), stream)
    _raise_on(rc, lib, "teddy_words (count)")
    LAUNCHES["teddy_words_count"] += 1
    return (counts, segs) if segments else counts


def filter_words_list(corpus_u8: torch.Tensor, tables: FilterTables,
                      seg_counts: torch.Tensor, cap: int, start: int = 0,
                      *, use_classes: Optional[bool] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel 7, list mode: the first `cap` candidates of the positions
    start <= p < n, ascending. `seg_counts` is count mode's segment
    output for the same inputs: the kernel re-filters only the segments
    with candidates and places them after the segments before them (the
    plain version recomputes them).

    Returns (positions int32 [cap] = p - start, words int32 [W, cap]);
    slots past the total hold 0."""
    if cap < 1:
        raise ValueError("cap must be positive")
    classes = _route(tables, use_classes)
    on_card = _check(corpus_u8, tables, start, classes)
    dev = corpus_u8.device
    n = corpus_u8.numel()
    if seg_counts.dtype != torch.int32 or seg_counts.device != dev or \
            seg_counts.shape != (n_segments(n),):
        raise ValueError("seg_counts must be count mode's int32 segment "
                         "output for this corpus")
    W = tables.W
    pos = torch.zeros(cap, dtype=torch.int32, device=dev)
    words = torch.zeros((W, cap), dtype=torch.int32, device=dev)
    if not on_card:
        _c, p, w = filter_words_plain(corpus_u8, tables, start,
                                      use_classes=classes)
        k = min(cap, p.numel())
        pos[:k] = p[:k]
        words[:, :k] = w[:, :k]
        return pos, words
    if not seg_counts.numel():
        return pos, words  # an empty corpus: no segment, no launch
    c = seg_counts.long()
    seg_first = torch.cumsum(c, 0) - c
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.hs_teddy_words_list(
        corpus_u8.data_ptr(), n, start, *_table_args(tables, classes),
        seg_counts.data_ptr(), seg_first.data_ptr(), seg_counts.numel(),
        cap, pos.data_ptr(), words.data_ptr(), stream)
    _raise_on(rc, lib, "teddy_words (list)")
    LAUNCHES["teddy_words_list"] += 1
    return pos, words


def teddy_scan_tensor(corpus_u8: torch.Tensor, tables: FilterTables,
                      capacity: int = 1 << 14, hint_obj=None
                      ) -> Tuple[int, np.ndarray, np.ndarray]:
    """Filter a device-resident flat corpus (the counterpart of
    `teddy_scan_rows`, hyperscan_tpu/ops/teddy.py:911): count mode with
    segment counts, then list mode at `capacity` (or the capacity learned
    on `hint_obj`), dispatched again at the next power of two when the
    candidates do not fit; the capacity is learned on `hint_obj`.

    Returns (total, pos[:k] int32 ascending, words[W, k] int32) as numpy,
    k = min(total, capacity) = total: no candidate is dropped."""
    cap = max(capacity, get_capacity_hint(hint_obj, HINT_KEY), 1)
    counts, segs = filter_words_count(corpus_u8, tables, segments=True)
    total_t = counts.long().sum()
    while True:
        pos, words = filter_words_list(corpus_u8, tables, segs, cap)
        total = int(total_t)
        if total <= cap:
            break
        count("redispatches")
        cap = _p2(total)
    if hint_obj is not None:
        set_capacity_hint(hint_obj, HINT_KEY, cap)
    return total, pos[:total].cpu().numpy(), words[:, :total].cpu().numpy()


def teddy_scan(corpus: np.ndarray, masks, capacity: int = 1 << 14,
               hint_obj=None, *, device="cuda"
               ) -> Tuple[int, np.ndarray, np.ndarray]:
    """Run the filter over a host uint8 corpus (uploads it to `device`,
    the card unless the caller asks for the CPU, then filters; the
    counterpart of hyperscan_tpu/ops/teddy.py:958)."""
    from ..runtime.scan import resolve_device
    from .teddy import corpus_tensor

    dev = resolve_device(device)
    return teddy_scan_tensor(corpus_tensor(corpus, dev),
                             mask_tables(masks, dev), capacity, hint_obj)
