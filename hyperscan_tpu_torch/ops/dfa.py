"""Lockstep DFA scan of a batch of buffers on a torch device.

Port of `hyperscan_tpu/ops/dfa.py:27 dfa_scan_batch` (an XLA `lax.scan`
in the reference: one step per byte, the batch axis across the lanes;
reference analogue: the McClellan byte loop, src/nfa/mcclellan.c). It
returns the dense [B, L] accept plane and the final states, with each
row's state frozen past its length.

- For a CPU tensor it is the lockstep torch loop `dfa_scan_batch_plain`,
  which is also its plain version on the card.
- For a CUDA tensor it is kernel C (`csrc/dfa_scan.cu`) in plane mode,
  launched ceil(L / 512) times with no halo: launch k scans bytes
  [512k, 512k + 512) of every row, entering in the finals of launch k - 1
  (the init states for k = 0), and writes each accept id straight into
  the plane at its position. The chunk rows are built on the device from
  the previous finals, so the launches never wait for the host. A chunk
  past its row's length has no live position and keeps its entry state.
  Nothing is speculative, so this is exact for any DFA. A dedicated
  lockstep kernel would run the same one thread a row with one launch;
  chaining the existing kernel needs no new kernel code beyond its plane
  mode.
"""

from __future__ import annotations

import torch

from .dfa_kernel import CHUNK, DfaTables, dfa_scan_plane


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


def dfa_scan_batch_chunks(tables: DfaTables, init_state, data, lengths):
    """Kernel C chained over the rows' 512-byte chunks (plane mode, no
    halo). On a CPU tensor each launch runs kernel C's plain version, so
    the chaining itself is testable there."""
    B, L = data.shape
    dev = data.device
    states = _states0(init_state, B, dev)
    plane = torch.zeros(B * L, dtype=torch.int32, device=dev)
    if B == 0 or L == 0:
        return plane.view(B, L), states
    flat = data.contiguous().reshape(-1)
    row0 = torch.arange(B, dtype=torch.int64, device=dev) * L
    lens = lengths.long().clamp(0, L)
    zero = torch.zeros(B, dtype=torch.int64, device=dev)
    for k in range(-(-L // CHUNK)):
        off = k * CHUNK
        meta = torch.stack([row0 + off, zero, (lens - off).clamp(0, CHUNK),
                            states.long()], 1).int()
        states = dfa_scan_plane(flat, tables, meta, 0, plane)
    return plane.view(B, L), states


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
    return dfa_scan_batch_chunks(tables, init_state, data, lengths)
