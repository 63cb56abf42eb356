"""Host scanning for small buffers — the smallwrite analogue.

Reference: src/smallwrite/ + runSmallWriteEngine (src/runtime.c:282-313):
buffers below a threshold skip the full Rose machinery. Here the threshold
guards *device dispatch latency* instead of engine startup cost: a TPU
round trip costs tens of milliseconds, so small batches run entirely on
host numpy (same tables, same semantics). The native C++ runtime
(hyperscan_tpu/native) accelerates these loops when built.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

# total batch bytes below which scanning stays on host
HOST_SCAN_LIMIT = 1 << 17


def teddy_filter_host(
    corpus: np.ndarray, masks: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Shift-AND candidate filter on host.

    Same contract as ops.teddy.teddy_scan: returns (pos, words[W, n]) for
    nonzero candidate bucket bitmasks; shifted-out leading positions pass
    (the confirm stage rejects false positives at boundaries)."""
    M, W, _ = masks.shape
    n = corpus.shape[0]
    if n == 0:
        return (np.zeros(0, np.int64), np.zeros((W, 0), np.int32))
    from ..native import teddy_filter_native

    native = teddy_filter_native(corpus, masks)
    if native is not None:
        return native
    cand = np.empty((W, n), dtype=np.int32)
    for w in range(W):
        acc = masks[0, w][corpus].copy()
        for m in range(1, M):
            plane = masks[m, w][corpus]
            acc[m:] &= plane[:-m] if m < n else 0
        cand[w] = acc
    nz = cand[0] != 0
    for w in range(1, W):
        nz |= cand[w] != 0
    pos = np.flatnonzero(nz)
    return pos, cand[:, pos]


def dfa_scan_host(
    engine, data: np.ndarray, lengths: np.ndarray,
    init_states: Optional[np.ndarray] = None, flat: bool = False,
) -> Tuple[List[List[Tuple[int, int]]], np.ndarray]:
    """Lockstep numpy DFA over a [B, L] batch.

    Returns (per-row [(pos_index, accept_set_id)...], final_states[B]),
    or with `flat` the accepts as three arrays (row, pos_index,
    accept_set_id), ordered by row, then position.
    Mirrors ops.dfa.dfa_scan_batch but on host (reference: the smallwrite
    McClellan direct exec, src/runtime.c:303-311)."""
    B, L = data.shape
    if init_states is None:
        init_states = np.full(B, engine.start_state, dtype=np.int32)
    from ..native import _split_hits, dfa_scan_batch_native

    native = dfa_scan_batch_native(engine, data, lengths, init_states,
                                   flat=flat)
    if native is not None:
        return native
    trans = engine.trans
    b2c = engine.byte_to_class.astype(np.int64)
    accept_id = engine.accept_id
    states = init_states.astype(np.int64).copy()
    rows: List[np.ndarray] = [np.zeros(0, np.int64)]
    poss: List[np.ndarray] = [np.zeros(0, np.int64)]
    aids: List[np.ndarray] = [np.zeros(0, np.int64)]
    if L:
        cls = b2c[data]
        for t in range(L):
            active = t < lengths
            states = np.where(active, trans[states, cls[:, t]], states)
            aid = np.where(active, accept_id[states], 0)
            nz = np.flatnonzero(aid)
            rows.append(nz)
            poss.append(np.full(len(nz), t, np.int64))
            aids.append(aid[nz].astype(np.int64))
    row = np.concatenate(rows)
    order = np.argsort(row, kind="stable")
    row = row[order]
    pos = np.concatenate(poss)[order]
    val = np.concatenate(aids)[order]
    if flat:
        return (row, pos, val), states
    return _split_hits(len(row), row, pos, val, B), states
