"""One-pass extraction of a candidacy plane's nonzero positions on a
torch device: the dense family's candidate list.

Reference counterpart: `sparse_extract` (hyperscan_tpu/ops/teddy.py:793)
as the dense family calls it (:1127, `nz=` the plane, chunk
EXTRACT_CHUNK = 256). Kernel: `csrc/plane_extract.cu` (one launch that
reads the plane once: a block counts and ranks a 64 KiB range while a
decoupled look-back learns the range's first rank, then writes its
positions below cap1; the last ranges write the -1s and the metadata;
one memset before it clears the look-back's status words). The
reference gathered the hit chunks at a learned chunk capacity; here no
chunk capacity exists, so the extraction never clamps.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import LAUNCHES
from .teddy import EXTRACT_CHUNK


def _check(plane: torch.Tensor, cap1: int) -> None:
    if plane.dtype != torch.uint8 or plane.dim() != 1 or \
            not plane.is_contiguous():
        raise ValueError("plane must be a flat contiguous uint8 tensor")
    if plane.numel() % EXTRACT_CHUNK:
        raise ValueError(f"plane length must be a multiple of "
                         f"{EXTRACT_CHUNK}")
    if plane.numel() >= (1 << 31):
        raise ValueError("plane must be shorter than 2^31 bytes")
    if cap1 < 1:
        raise ValueError("cap1 must be positive")


def _meta(counts: torch.Tensor, n_chunks: int):
    """(total, hit chunks) as int64 [2], and the exclusive cumsum of the
    chunk counts (plain torch over n/256 ints)."""
    if n_chunks == 0:
        z = torch.zeros(2, dtype=torch.int64, device=counts.device)
        return z, torch.zeros(0, dtype=torch.int64, device=counts.device)
    c = counts.long()
    cum = torch.cumsum(c, 0)
    meta = torch.stack([cum[-1], (c > 0).sum()])
    return meta, cum - c


def plane_extract_plain(plane: torch.Tensor, n_valid: int, cap1: int):
    """Plain PyTorch version of `plane_extract` (same contract)."""
    _check(plane, cap1)
    n_chunks = plane.numel() // EXTRACT_CHUNK
    chunks = plane.reshape(n_chunks, EXTRACT_CHUNK)
    live = (torch.arange(n_chunks, device=plane.device) * EXTRACT_CHUNK
            < n_valid)
    counts = (chunks != 0).sum(1) * live
    meta, _off = _meta(counts, n_chunks)
    flat = torch.nonzero(((chunks != 0) & live[:, None]).reshape(-1)) \
        .squeeze(1)
    pos = torch.full((cap1,), -1, dtype=torch.int32, device=plane.device)
    k = min(cap1, flat.numel())
    pos[:k] = flat[:k].int()
    return meta, pos


def _lib():
    from ._build import library

    lib = library("plane_extract")
    if not getattr(lib, "_typed", False):
        vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.hs_plane_extract.restype = ci
        lib.hs_plane_extract.argtypes = [vp, cll, cll, ci, vp, vp]
        lib.hs_plane_extract_buffer_bytes.restype = cll
        lib.hs_plane_extract_buffer_bytes.argtypes = [cll, ci]
        lib.hs_plane_extract_error.restype = ctypes.c_char_p
        lib.hs_plane_extract_error.argtypes = [ci]
        lib._typed = True
    return lib


def plane_extract(plane: torch.Tensor, n_valid: int, cap1: int):
    """The first `cap1` nonzero positions of a uint8 plane.

    plane   : flat uint8 tensor, length a multiple of 256
    n_valid : chunks of 256 bytes at or past n_valid are not counted
    Returns (meta int64 [2] = (total nonzero bytes in the counted chunks,
    number of counted chunks holding one), positions int32 [cap1],
    ascending, -1 past min(total, cap1)). On the card both are views of
    one buffer that the kernel's memset and launch fill (one launch in
    `LAUNCHES["plane_extract"]`)."""
    if plane.device.type == "cpu":
        return plane_extract_plain(plane, n_valid, cap1)
    _check(plane, cap1)
    if plane.device.type != "cuda":
        raise ValueError(f"unsupported device {plane.device}")
    if plane.data_ptr() % 16:
        raise ValueError("plane must be 16-byte aligned (vector loads)")
    lib = _lib()
    n = plane.numel()
    buf = torch.empty(lib.hs_plane_extract_buffer_bytes(n, cap1),
                      dtype=torch.uint8, device=plane.device)
    stream = torch.cuda.current_stream(plane.device).cuda_stream
    rc = lib.hs_plane_extract(plane.data_ptr(), n, max(0, n_valid), cap1,
                              buf.data_ptr(), stream)
    if rc:
        raise RuntimeError("plane_extract launch failed: "
                           + lib.hs_plane_extract_error(rc).decode())
    LAUNCHES["plane_extract"] += 1
    return buf[-16:].view(torch.int64), buf[:cap1 * 4].view(torch.int32)
