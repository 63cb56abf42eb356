"""Lockstep DFA scan of a batch of buffers on a torch device.

Port of `hyperscan_tpu/ops/dfa.py:27 dfa_scan_batch` (an XLA `lax.scan`
in the reference: one step per byte, the batch axis across the lanes;
reference analogue: the McClellan byte loop, src/nfa/mcclellan.c). It
returns the dense [B, L] accept plane and the final states, with each
row's state frozen past its length.

- For a CPU tensor it is the lockstep torch loop `dfa_scan_batch_plain`,
  which is also its plain version on the card.
- For a CUDA tensor it is kernel C's row mode (`csrc/dfa_scan.cu`,
  `dfa_scan_rows`): one launch a call, one thread a row stepping from its
  entry state over its whole length, writing every entry of the plane
  (zeros past each row's length), so there is no memset and no host work
  between chunks. Nothing is speculative, so this is exact for any DFA.
"""

from __future__ import annotations

from typing import Optional

import torch

from ._build import LAUNCHES
from .dfa_kernel import DfaTables, _lib, placement_of


def _states0(init_state, B: int, device) -> torch.Tensor:
    s = torch.as_tensor(init_state, dtype=torch.int32, device=device)
    return torch.broadcast_to(s, (B,)).contiguous()


def dfa_scan_batch_plain(trans, byte_to_class, accept_id, init_state, data,
                         lengths):
    """The lockstep loop: one step per byte over all B rows (same
    contract as `dfa_scan_batch`)."""
    B, L = data.shape
    dev = data.device
    C = int(trans.shape[1])
    tflat = trans.reshape(-1).long()
    b2c = byte_to_class.long()
    acc = accept_id.long()
    lens = lengths.long()
    states = _states0(init_state, B, dev).long()
    cols = data.t().contiguous()  # [L, B]: row i is byte i of every row
    accepts = torch.zeros((L, B), dtype=torch.int32, device=dev)
    for i in range(L):
        live = i < lens
        nxt = tflat[states * C + b2c[cols[i].long()]]
        states = torch.where(live, nxt, states)
        accepts[i] = torch.where(live, acc[states], 0).int()
    return accepts.t().contiguous(), states.int()


def dfa_scan_rows(tables: DfaTables, init_state, data, lengths, *,
                  placement: Optional[str] = None):
    """Kernel C's row mode: the lockstep scan of every row of `data` in
    one launch (the contract of `dfa_scan_batch`, over `tables`).

    placement : "shared" or "global" table placement (CUDA only); by
                default `placement_of(tables, None, "rows")`.
    On a CPU tensor it runs the plain version over the same tables."""
    if data.dtype != torch.uint8 or data.dim() != 2:
        raise ValueError("data must be a [B, L] uint8 tensor")
    B, L = data.shape
    dev = data.device
    if dev.type == "cpu":
        return dfa_scan_batch_plain(tables.trans.view(tables.S, tables.C),
                                    tables.b2c, tables.accept, init_state,
                                    data, lengths)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if tables.trans.device != dev:
        raise ValueError("tables and data lie on different devices")
    if not 1 <= tables.C <= 256:
        raise ValueError(f"{tables.C} byte classes outside 1..256")
    if B * L >= 1 << 31:
        raise ValueError("a batch must hold fewer than 2^31 bytes")
    data = data.contiguous()
    lens = lengths.to(device=dev, dtype=torch.int32).contiguous()
    states = _states0(init_state, B, dev)
    plane = torch.empty((B, L), dtype=torch.int32, device=dev)
    finals = torch.empty(B, dtype=torch.int32, device=dev)
    if B == 0:
        return plane, finals
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.hs_dfa_scan_rows(
        data.data_ptr(), B, L, lens.data_ptr(), states.data_ptr(),
        tables.trans.data_ptr(), tables.b2c.data_ptr(),
        tables.accept.data_ptr(), tables.S, tables.C,
        int(placement_of(tables, placement, "rows") == "shared"),
        plane.data_ptr(), finals.data_ptr(), stream)
    if rc:
        raise RuntimeError("dfa_scan_rows launch failed: "
                           + lib.hs_dfa_scan_error(rc).decode())
    LAUNCHES["dfa_scan_rows"] += 1
    return plane, finals


def dfa_scan_batch(trans, byte_to_class, accept_id, init_state, data,
                   lengths):
    """Scan B independent buffers in lockstep.

    Args (tensors on one device):
      trans:         [S, C] int32 transition table
      byte_to_class: [256] int32 alphabet remap
      accept_id:     [S] int32 accept-set id per state (0 = none)
      init_state:    an int or int32 scalar, or [B] int32 per-row entry
                     states (streaming: each row resumes its stream)
      data:          [B, L] uint8 (padded)
      lengths:       [B] int32 valid lengths

    Returns:
      accepts:      [B, L] int32 accept-set id at each byte position (0
                    past the valid length)
      final_states: [B] int32 state at end of data
    """
    if data.dtype != torch.uint8 or data.dim() != 2:
        raise ValueError("data must be a [B, L] uint8 tensor")
    if data.device.type == "cpu":
        return dfa_scan_batch_plain(trans, byte_to_class, accept_id,
                                    init_state, data, lengths)
    S, C = int(trans.shape[0]), int(trans.shape[1])
    tables = DfaTables(trans.reshape(-1).int().contiguous(),
                       byte_to_class.int().contiguous(),
                       accept_id.int().contiguous(), S, C)
    return dfa_scan_rows(tables, init_state, data, lengths)
