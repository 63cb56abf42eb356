"""Match extraction: a dense accept-id plane -> fixed-capacity match
buffers, on a torch device.

Port of `hyperscan_tpu/ops/match.py` (XLA ops in the reference, no
Pallas kernel): a cumsum gives every nonzero entry its slot, and one
scatter places the entries below `capacity`. Plain torch on every device;
nothing here waits for the device.
"""

from __future__ import annotations

import torch


def extract_matches(accepts: torch.Tensor, capacity: int):
    """Compact the nonzero entries of a [B, L] accept-id plane.

    Returns:
      total:   int32 scalar tensor, the true number of accepts (it may
               exceed capacity)
      set_ids: int32 [capacity], the accept-set id of each match slot
      blocks:  int32 [capacity], the batch row of each match
      tos:     int32 [capacity], the end offset within the row (one past
               the matching byte, before report adjusts)

    Slots past `total` hold zeros. Matches come in scan order (row-major:
    block, then offset), the reference's callback order within a block.
    """
    B, L = accepts.shape
    dev = accepts.device
    flat = accepts.reshape(-1)
    mask = flat != 0
    total = mask.sum(dtype=torch.int32)
    zeros = torch.zeros(capacity, dtype=torch.int32, device=dev)
    if flat.numel() == 0 or capacity == 0:
        return total, zeros, zeros.clone(), zeros.clone()
    slot = torch.cumsum(mask, 0) - 1
    # entries that are not matches, or past the capacity, go to one
    # extra slot that is dropped
    slot = torch.where(mask & (slot < capacity), slot,
                       torch.full_like(slot, capacity))
    where = torch.zeros(capacity + 1, dtype=torch.int64, device=dev)
    where.scatter_(0, slot, torch.arange(flat.numel(), device=dev))
    where = where[:capacity]
    have = torch.arange(capacity, device=dev) < total
    set_ids = torch.where(have, flat[where].int(), zeros)
    blocks = torch.where(have, torch.div(where, L, rounding_mode="floor")
                         .int(), zeros)
    tos = torch.where(have, (where % L + 1).int(), zeros)
    return total, set_ids, blocks, tos


def count_matches(accepts: torch.Tensor) -> torch.Tensor:
    """Total match count, an int32 scalar tensor (for counting-only scans
    and the cross-device sum)."""
    return (accepts != 0).sum(dtype=torch.int32)
