"""The literal path's four families and the choice between them:
start, fetch, finish and scan.

Reference counterpart: `teddy_confirm_start` / `teddy_confirm_finish` /
`teddy_confirm_fetch_many` (hyperscan_tpu/ops/teddy.py:1823-2030) and
the learned state they keep on the database. `confirm_start` runs one of
four families, chosen by the reference's rules (`_choose_family`):

- gated: the single-word gate flags 128-byte rows (`teddy_gate.gate_rows`)
  and the full filter rescans only those (`teddy_gate.rescan_rows`);
- compact: the filter emits per 64 KiB cell the exact candidate count and
  the first `capc` positions (`teddy.filter_compact`);
- kconfirm: the filter hash-confirms every candidate inside the kernel
  (`teddy_kconfirm.filter_kconfirm`);
- dense: the filter writes a candidacy plane (`teddy.filter_plane`) and
  `extract.plane_extract` lists its first `cap1` positions.

All but kconfirm end in `teddy.compact_combine` (or the extraction) and
the hash confirm `teddy.hash_confirm`. This module sits above the kernel
wrappers: it imports them, and none of them imports it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..trace import count, spanned
from .extract import plane_extract
from .teddy import (CELL, ROW, _n_cells, _p2, compact_combine,
                    device_tables, filter_compact, filter_plane,
                    hash_confirm)
from .teddy_gate import device_gate_table, gate_rows, rescan_rows
from .teddy_kconfirm import (CAPC2, confirm_planes, filter_kconfirm,
                             kconf_combine)

# The reference's family thresholds (hyperscan_tpu/ops/teddy.py:1005,
# :214-219, :1781), unchanged: they were set by TPU costs, and retuning
# them for the card is later work.
CAPC_MAX = 4096  # a compact cell past this demotes the database to dense
KCONF_MIN_MEAN = 4.0  # mean candidates a cell from which kconfirm is chosen
KCONF_MAX_CAPC = 512  # kconfirm is not chosen past this learned capc
GATE_ROW_FRAC = 1.0 / 64  # gated family while at most this share of
# 128-byte rows survives the gate

# learned-capacity floors: capc is the per-cell compaction capacity,
# cap1 the candidate list, cap2 the confirmed-pair buffer
CAPC_FLOOR = 128
CAP1_FLOOR = 1024
CAP2_FLOOR = 1024

FAMILIES = ("gated", "compact", "kconfirm", "dense")
# every re-dispatch grows a capacity at least twofold or demotes the
# family, so a scan settles in a few; more means a fault, not a load
_MAX_DISPATCHES = 64


@dataclasses.dataclass
class FamilyState:
    """What a literal database has learned about its families, kept on
    the lit object as `_torch_family` (the reference keeps the same facts
    in loose attributes: `_gate_rate`, `_dense_extract`, `_kconfirm_off`,
    `_kc_mean`, `_cap_obs_c`, `_cap_obs_g`, `_cap_obs`).

    `force` is the forcing knob (`force_family`)."""

    force: Optional[str] = None
    gate_rate: float = 0.0  # worst share of rows that survived the gate
    dense: bool = False  # a compact cell once held more than CAPC_MAX
    kconfirm_off: bool = False  # a kconfirm cell once matched > CAPC2
    kc_mean: Optional[float] = None  # worst mean candidates per cell
    # running max of the observed loads, per family: compact and
    # kconfirm (t1, h1, t2), gated (t1, h1, t2), dense (t1, t2)
    obs: Dict[str, Tuple[int, ...]] = dataclasses.field(
        default_factory=dict)
    # dispatches of each family so far (a scan shows which it ran)
    dispatches: Dict[str, int] = dataclasses.field(
        default_factory=lambda: dict.fromkeys(FAMILIES, 0))


def family_state(lit) -> FamilyState:
    st = lit.__dict__.get("_torch_family")
    if st is None:
        st = lit._torch_family = FamilyState()
    return st


def force_family(lit, family: Optional[str]) -> None:
    """Pin the family of a literal database (the port's counterpart of
    the reference's `_kconfirm_force`, `_dense_extract` and of clearing
    `gate_masks`):

    - None: the reference's rules (the default);
    - "ungated": the reference's rules without the gated family;
    - "gated", "compact", "kconfirm", "dense": that family.

    A forced family still takes the reference's demotions: a compact or
    kconfirm cell past CAPC_MAX moves the database to dense, a kconfirm
    cell past CAPC2 moves it to compact. Forcing a family whose tables
    the database lacks raises at the next `confirm_start`."""
    if family not in (None, "ungated") + FAMILIES:
        raise ValueError(f"unknown literal family {family!r}")
    family_state(lit).force = family


def _learned(obs, floors, margins, ceils):
    return tuple(min(c, max(f, _p2(m * o // 4)))
                 for o, f, m, c in zip(obs, floors, margins, ceils))


def _caps_for(lit, capacity: int, family: str = "compact"
              ) -> Tuple[int, int, int]:
    """(cap1, capc, cap2) for the next compact or kconfirm dispatch (their
    shared loads), or the next gated one (`family="gated"`, its own),
    learned from the running max of observed loads (~2x margins, cap1
    1.25x, as in the reference's `_caps_for`). capc stops at CAPC_MAX in
    the compact family, which then demotes to dense, and at a whole cell
    in the gated family, which never demotes."""
    obs = family_state(lit).obs.get(family)
    if obs is None:
        return (max(capacity, CAP1_FLOOR), CAPC_FLOOR,
                max(capacity // 4, CAP2_FLOOR))
    capc_max = CELL if family == "gated" else CAPC_MAX
    return _learned(obs, (CAP1_FLOOR, CAPC_FLOOR, CAP2_FLOOR), (5, 8, 8),
                    (1 << 62, capc_max, 1 << 62))


def _caps_for_dense(lit, capacity: int) -> Tuple[int, int]:
    """(cap1, cap2) for the next dense dispatch."""
    obs = family_state(lit).obs.get("dense")
    if obs is None:
        return (max(capacity, CAP1_FLOOR), max(capacity // 4, CAP2_FLOOR))
    return _learned(obs, (CAP1_FLOOR, CAP2_FLOOR), (8, 8),
                    (1 << 62, 1 << 62))


def _observe(st: FamilyState, key: str, load: Tuple[int, ...]) -> None:
    old = st.obs.get(key, (0,) * len(load))
    st.obs[key] = tuple(max(a, b) for a, b in zip(old, load))


def _choose_family(lit, device, capacity: int) -> str:
    """The reference's choice (teddy_confirm_start,
    hyperscan_tpu/ops/teddy.py:1839-1888): gated while the database has
    gate tables and its gate survival stays within GATE_ROW_FRAC; else
    dense once demoted; else kconfirm once the mean cell load reaches
    KCONF_MIN_MEAN, if its tables exist, the learned capc is within
    KCONF_MAX_CAPC and no cell overflowed CAPC2; else compact."""
    st = family_state(lit)
    force = st.force
    if force == "gated" or force is None:
        gate = device_gate_table(lit, device) is not None
        if force == "gated":
            if not gate:
                raise ValueError("gated family forced, but the database "
                                 "has no gate tables")
            return "gated"
        if gate and st.gate_rate <= GATE_ROW_FRAC:
            return "gated"
    if st.dense or force == "dense":
        return "dense"
    if force == "compact":
        return "compact"
    if st.kconfirm_off or _caps_for(lit, capacity)[1] > KCONF_MAX_CAPC:
        return "compact"
    if force == "kconfirm":
        if confirm_planes(lit, device) is None:
            raise ValueError("kconfirm family forced, but the database's "
                             "confirm tables exceed its limits")
        return "kconfirm"
    if st.kc_mean is not None and st.kc_mean >= KCONF_MIN_MEAN and \
            confirm_planes(lit, device) is not None:
        return "kconfirm"
    return "compact"


@dataclasses.dataclass
class ConfirmHandle:
    """A dispatched filter + confirm whose results are still on the
    device."""

    lit: object
    corpus: torch.Tensor
    n_valid: int
    family: str  # one of FAMILIES: the family that ran
    caps: Tuple[int, ...]  # (cap1, capc, cap2); dense: (cap1, cap2)
    meta: torch.Tensor  # int64: (candidate total, max cell or hit chunks,
    # pairs total) + the gated survivor rows K / kconfirm max cell matches
    pairs: torch.Tensor  # int32 [cap2, 2] = (class id + 1, pos)


@spanned("hs.dispatch")
def confirm_start(corpus_u8: torch.Tensor, lit, n_valid: int,
                  capacity: int = 1 << 14) -> ConfirmHandle:
    """Dispatch the chosen family's filter, extraction and confirm over
    the first `n_valid` bytes of a device corpus without waiting for
    them (no host synchronisation: every output is sized from learned
    capacities). The class tables are used whenever the alphabet
    compresses to 128 classes or fewer, the byte tables otherwise."""
    if not 0 <= n_valid <= corpus_u8.numel():
        raise ValueError("n_valid outside the corpus")
    dev = corpus_u8.device
    ft, ct = device_tables(lit, dev)
    use_classes = ft.cmasks is not None
    family = _choose_family(lit, dev, capacity)
    family_state(lit).dispatches[family] += 1
    corpus = corpus_u8[:n_valid]
    if family == "kconfirm":
        caps = _caps_for(lit, capacity)
        out = filter_kconfirm(corpus, ft, confirm_planes(lit, dev),
                              use_classes=use_classes)
        meta, pairs = kconf_combine(*out, caps[2])
        return ConfirmHandle(lit, corpus_u8, n_valid, family, caps, meta,
                             pairs)
    extra = []
    if family == "dense":
        caps = cap1, cap2 = _caps_for_dense(lit, capacity)
        meta1, pos = plane_extract(
            filter_plane(corpus, ft, use_classes=use_classes), n_valid,
            cap1)
    else:
        if family == "gated":
            caps = _caps_for(lit, capacity, "gated")
            flags, k_cells = gate_rows(corpus, device_gate_table(lit, dev))
            pos_c, counts = rescan_rows(corpus, ft, flags, caps[1],
                                        row_counts=k_cells)
            extra = [k_cells.long().sum().reshape(1)]
        else:
            caps = _caps_for(lit, capacity)
            pos_c, counts = filter_compact(corpus, ft, caps[1],
                                           use_classes=use_classes)
        cap1, capc, cap2 = caps
        meta1, pos = compact_combine(pos_c, counts, capc, cap1)
    pairs, total2 = hash_confirm(corpus, pos, ct, cap2)
    meta = torch.cat([meta1.long(), total2.long()] + extra)
    return ConfirmHandle(lit, corpus_u8, n_valid, family, caps, meta, pairs)


def _observe_finish(handle: ConfirmHandle, meta: Sequence[int]) -> bool:
    """Record one finished dispatch's loads on the database (the
    reference's teddy_confirm_finish, hyperscan_tpu/ops/teddy.py:1918-
    1980) and say whether its outputs fit its capacities."""
    st = family_state(handle.lit)
    fam, caps = handle.family, handle.caps
    n_cells = _n_cells(handle.n_valid)
    if fam == "gated":
        t1, h1, t2, k_rows = meta
        rate = k_rows / (n_cells * (CELL // ROW))
        st.gate_rate = max(st.gate_rate, rate)
        # observed even past the threshold (the reference stops there):
        # a forced gated family must still learn its capacities
        _observe(st, "gated", (t1, h1, t2))
        # a valid result is used even when the rate just crossed the
        # threshold: the switch applies from the next start
        cap1, capc, cap2 = caps
        return t1 <= cap1 and h1 <= capc and t2 <= cap2
    st.kc_mean = max(st.kc_mean or 0.0, meta[0] / n_cells)
    if fam == "dense":
        t1, _hit_chunks, t2 = meta
        _observe(st, "dense", (t1, t2))
        cap1, cap2 = caps
        return t1 <= cap1 and t2 <= cap2
    t1, h1, t2 = meta[:3]
    if h1 > CAPC_MAX:
        st.dense = True
    _observe(st, "compact", (t1, h1, t2))
    cap1, capc, cap2 = caps
    if fam == "kconfirm":
        # every candidate was confirmed in the kernel, so cap1 and capc
        # bound nothing here; a cell past CAPC2 lost matches
        if meta[3] > CAPC2:
            st.kconfirm_off = True
        return t2 <= cap2 and meta[3] <= CAPC2
    return t1 <= cap1 and h1 <= capc and t2 <= cap2


@spanned("hs.fetch")
def confirm_fetch_many(handles: Sequence[ConfirmHandle]) -> List[np.ndarray]:
    """Fetch several started scans' meta and pair buffers in ONE
    device->host copy (reference: teddy_confirm_fetch_many,
    hyperscan_tpu/ops/teddy.py:2014). Handles on several devices are
    gathered on the first handle's device before the copy. Returns one
    int64 array per handle to pass to `confirm_finish(handle, got=...)`;
    scans whose outputs overflowed are dispatched again by that call."""
    if not handles:
        return []
    dev = handles[0].meta.device
    parts = [t.to(dev) for h in handles
             for t in (h.meta, h.pairs.reshape(-1).long())]
    flat = torch.cat(parts).cpu().numpy()
    out, off = [], 0
    for h in handles:
        size = h.meta.numel() + h.pairs.numel()
        out.append(flat[off:off + size])
        off += size
    return out


@spanned("hs.fetch")
def confirm_finish(handle: ConfirmHandle, got: Optional[np.ndarray] = None
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Fetch a started scan's hash-matched pairs as (fid_array,
    pos_array) — callers must exact-verify with
    runtime.lit_runtime.verify_pairs. `got` is the handle's buffer from
    `confirm_fetch_many`, if it was fetched already.

    Overflow never drops a match: when an output is past its capacity
    (a cell past capc, the candidates past cap1, the pairs past cap2, a
    kconfirm cell past CAPC2), the scan is dispatched again on the device
    with the learned capacities or the demoted family. capc grows at most
    to CAPC_MAX (then dense) or a whole cell (gated), so this ends."""
    from ..runtime.lit_runtime import expand_confirm_classes

    for _ in range(_MAX_DISPATCHES):
        k = handle.meta.numel()
        meta = [int(x) for x in (got[:k] if got is not None
                                 else handle.meta.tolist())]
        if _observe_finish(handle, meta):
            break
        count("redispatches")
        handle = confirm_start(handle.corpus, handle.lit, handle.n_valid)
        got = None
    else:
        raise RuntimeError(f"literal scan did not fit its capacities after "
                           f"{_MAX_DISPATCHES} dispatches ({handle.family}, "
                           f"caps {handle.caps}, loads {meta})")
    t2 = meta[2]
    if t2 == 0:
        z = np.zeros(0, dtype=np.int64)
        return z, z
    if got is not None:
        pairs = got[k:].reshape(-1, 2)[:t2]
    else:
        pairs = handle.pairs[:t2].cpu().numpy().astype(np.int64)
    key = np.sort((pairs[:, 1] << 20) | pairs[:, 0])
    return expand_confirm_classes(handle.lit, (key & 0xFFFFF) - 1, key >> 20)


def confirm_scan(corpus_u8: torch.Tensor, lit, n_valid: int,
                 capacity: int = 1 << 14) -> Tuple[np.ndarray, np.ndarray]:
    """Filter + hash confirm over a device corpus: hash-matched
    (fid_array, pos_array) pairs (see confirm_finish)."""
    return confirm_finish(confirm_start(corpus_u8, lit, n_valid, capacity))
