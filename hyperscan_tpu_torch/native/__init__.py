"""ctypes bindings for the native host scanning runtime.

The shared library is built lazily with g++ (see build()); callers fall
back to numpy implementations when unavailable (no compiler, build
failure). Set HSTPU_NO_NATIVE=1 to force the numpy paths.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False

# array params are declared c_void_p and passed as raw .ctypes.data
# addresses: ndpointer's from_param validation is Python-level and costs
# ~7 us per argument per call, which dominates small streaming writes
# (25+ array args cross the boundary per write batch). Every call site
# guarantees dtype/contiguity via ascontiguousarray right before the
# call; the _ptr helper is the single choke point.
_I32P = ctypes.c_void_p
_I64P = ctypes.c_void_p
_U8P = ctypes.c_void_p
_U64P = ctypes.c_void_p


def _ptr(arr: np.ndarray) -> int:
    return arr.ctypes.data


def _build() -> Optional[ctypes.CDLL]:
    src = pathlib.Path(__file__).with_name("scan.cpp")
    code = src.read_bytes()
    tag = hashlib.sha256(code).hexdigest()[:16]
    cache = pathlib.Path(
        os.environ.get("XDG_CACHE_HOME", os.path.expanduser("~/.cache"))
    ) / "hyperscan_tpu_torch"
    cache.mkdir(parents=True, exist_ok=True)
    so = cache / f"libhstpu_torch_{tag}.so"
    if not so.exists():
        # a temporary name of this process's own: concurrent processes
        # (test workers with a cold cache) compile side by side, and the
        # first to finish installs the library
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [
            "g++", "-O3", "-march=native", "-shared", "-fPIC",
            "-o", str(tmp), str(src),
        ]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        except Exception:
            tmp.unlink(missing_ok=True)
            return None
        if so.exists():
            tmp.unlink()
        else:
            os.replace(tmp, so)
    try:
        lib = ctypes.CDLL(str(so))
    except OSError:
        return None

    lib.hstpu_dfa_scan_batch.restype = ctypes.c_int64
    lib.hstpu_dfa_scan_batch.argtypes = [
        _I32P, ctypes.c_int32, _I32P, _I32P,
        _U8P, ctypes.c_int64, ctypes.c_int64, _I32P,
        _I32P, _I32P, _I32P, _I32P, ctypes.c_int64,
    ]
    lib.hstpu_teddy_filter.restype = ctypes.c_int64
    lib.hstpu_teddy_filter.argtypes = [
        _I32P, ctypes.c_int32, ctypes.c_int32,
        _U8P, ctypes.c_int64, _I64P, _I32P, ctypes.c_int64,
    ]
    lib.hstpu_teddy_filter_pair.restype = ctypes.c_int64
    lib.hstpu_teddy_filter_pair.argtypes = [
        _I32P, ctypes.c_int32, ctypes.c_int32, _U8P,
        _U8P, ctypes.c_int64, _I64P, _I32P, ctypes.c_int64,
    ]
    lib.hstpu_teddy_filter_pair8.restype = ctypes.c_int64
    lib.hstpu_teddy_filter_pair8.argtypes = [
        _I32P, ctypes.c_int32, ctypes.c_int32, _U8P,
        _U8P, ctypes.c_int64, _I64P, _I32P, ctypes.c_int64,
    ]
    lib.hstpu_teddy_filter_nib.restype = ctypes.c_int64
    lib.hstpu_teddy_filter_nib.argtypes = [
        _I32P, ctypes.c_int32, ctypes.c_int32, _U8P, _U8P,
        _U8P, ctypes.c_int64, _I64P, _I32P, ctypes.c_int64,
    ]
    lib.hstpu_confirm.restype = ctypes.c_int64
    lib.hstpu_confirm.argtypes = [
        _U8P, ctypes.c_int64, _I64P, ctypes.c_int64,
        _I64P, ctypes.c_int64, ctypes.c_int32,
        _I32P, _U64P, _I64P, _U64P, _I64P,
        _I64P, _I64P, _U8P, _U8P,
        _I64P, _I64P, ctypes.c_int64,
    ]
    lib.hstpu_validate_windows.restype = ctypes.c_int64
    lib.hstpu_validate_windows.argtypes = [
        _U8P, ctypes.c_int64,
        _I64P, _I64P, _I64P, _I64P, ctypes.c_int64,
        _I64P, _I64P, _U8P, _U8P,
        _I64P, ctypes.c_int64,
        _I32P, ctypes.c_int32, _I32P, _I32P, _I32P,
        _I64P, _I64P, _I64P,
        _I64P, _I64P, _I64P,
        _I64P, _I64P, _I64P, ctypes.c_int64,
    ]
    lib.hstpu_dfa_scan_one.restype = ctypes.c_int64
    lib.hstpu_dfa_scan_one.argtypes = [
        _I32P, ctypes.c_int32, _I32P, _I32P,
        _U8P, ctypes.c_int64, ctypes.c_int32,
        _I32P, _I32P, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.hstpu_somnfa_scan_batch.restype = ctypes.c_int64
    lib.hstpu_somnfa_scan_batch.argtypes = [
        _U64P, _I32P, _I32P, _I32P,
        _I32P, _I32P, ctypes.c_int32,
        _I32P, _I32P, ctypes.c_int32,
        _I32P, ctypes.c_int32, ctypes.c_int32,
        _U8P, ctypes.c_int64, ctypes.c_int64, _I32P, _I64P,
        _U64P, _I64P, _U8P,
        _I32P, _I32P, _I32P, _I64P, ctypes.c_int64,
    ]
    lib.hstpu_bitnfa_scan_batch.restype = ctypes.c_int64
    lib.hstpu_bitnfa_scan_batch.argtypes = [
        _U64P, _U64P, _I32P, _I32P, _U64P, _U64P, _U64P,
        ctypes.c_int32, ctypes.c_int32,
        _U8P, ctypes.c_int64, ctypes.c_int64, _I32P,
        _U64P, _U8P, _I32P, _I32P, _I64P, ctypes.c_int64,
    ]
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if os.environ.get("HSTPU_NO_NATIVE"):
        return None
    with _lock:
        if not _tried:
            _tried = True
            _lib = _build()
    return _lib


def available() -> bool:
    return get_lib() is not None


# --- typed wrappers (numpy in, numpy out) -----------------------------------


def _engine_c_arrays(engine):
    """Cache C-contiguous int32 views of an engine's tables."""
    if not hasattr(engine, "_c_arrays"):
        engine._c_arrays = (
            np.ascontiguousarray(engine.trans, dtype=np.int32),
            np.ascontiguousarray(
                engine.byte_to_class.astype(np.int32)
            ),
            np.ascontiguousarray(engine.accept_id, dtype=np.int32),
        )
    return engine._c_arrays


def dfa_scan_batch_native(engine, data, lengths, init_states, flat=False):
    """Returns (hits per row [(pos, aid)...], final_states) or None; with
    `flat`, the hits as (row, pos, aid) arrays ordered by row."""
    lib = get_lib()
    if lib is None:
        return None
    trans, b2c, accept_id = _engine_c_arrays(engine)
    B, L = data.shape
    data = np.ascontiguousarray(data, dtype=np.uint8)
    lengths = np.ascontiguousarray(lengths, dtype=np.int32)
    states = np.ascontiguousarray(init_states, dtype=np.int32).copy()
    cap = 4096
    while True:
        out_row = np.empty(cap, np.int32)
        out_pos = np.empty(cap, np.int32)
        out_aid = np.empty(cap, np.int32)
        states_run = states.copy()
        n = lib.hstpu_dfa_scan_batch(
            _ptr(trans), trans.shape[1], _ptr(b2c), _ptr(accept_id),
            _ptr(data), B, L, _ptr(lengths), _ptr(states_run),
            _ptr(out_row), _ptr(out_pos), _ptr(out_aid), cap,
        )
        if n <= cap:
            break
        cap = 1 << int(n - 1).bit_length()
    if flat:
        n = int(n)
        return (out_row[:n].astype(np.int64), out_pos[:n].astype(np.int64),
                out_aid[:n].astype(np.int64)), states_run
    return _split_hits(int(n), out_row, out_pos, out_aid, B), states_run


def _split_hits(n, out_row, out_pos, out_val, B):
    """Group (row, pos, val) hit triples into per-row (pos, val) array
    pairs; rows are emitted nondecreasing by the native loops."""
    pos = out_pos[:n].astype(np.int64)
    val = out_val[:n].astype(np.int64)
    cuts = np.searchsorted(out_row[:n], np.arange(B + 1))
    return [
        (pos[cuts[b]:cuts[b + 1]], val[cuts[b]:cuts[b + 1]])
        for b in range(B)
    ]


def bitnfa_scan_batch_native(engine, data, lengths, init_states):
    """Returns (hits per row [(pos, set_bitmask)...], final ints) or None."""
    lib = get_lib()
    if lib is None:
        return None
    from ..runtime.nfa_host import _int_to_words, _words_to_int, pack_words

    follow_w, reach_w, float_w, anch_w, acc_any, KW = pack_words(engine)
    if KW > 512:  # native scratch word cap (P <= 32768)
        return None
    P = engine.num_positions
    B, L = data.shape
    data = np.ascontiguousarray(data, dtype=np.uint8)
    lengths = np.ascontiguousarray(lengths, dtype=np.int32)
    gid = np.ascontiguousarray(engine.accept_gid, dtype=np.int32)
    b2c = np.ascontiguousarray(engine.byte_to_class, dtype=np.int32)
    start_bit = 1 << P
    states0 = np.zeros((B, KW), np.uint64)
    starts0 = np.zeros(B, np.uint8)
    for b, s in enumerate(init_states):
        s = int(s)
        starts0[b] = 1 if s & start_bit else 0
        states0[b] = _int_to_words(s & (start_bit - 1), KW)
    cap = 4096
    while True:
        out_row = np.empty(cap, np.int32)
        out_pos = np.empty(cap, np.int32)
        out_bits = np.empty(cap, np.int64)
        states = states0.copy()
        starts = starts0.copy()
        n = lib.hstpu_bitnfa_scan_batch(
            _ptr(follow_w), _ptr(reach_w), _ptr(b2c), _ptr(gid),
            _ptr(acc_any), _ptr(float_w), _ptr(anch_w),
            P, KW, _ptr(data), B, L, _ptr(lengths), _ptr(states),
            _ptr(starts),
            _ptr(out_row), _ptr(out_pos), _ptr(out_bits), cap,
        )
        if n <= cap:
            break
        cap = 1 << int(n - 1).bit_length()
    finals = [
        _words_to_int(states[b]) | (start_bit if starts[b] else 0)
        for b in range(B)
    ]
    return _split_hits(int(n), out_row, out_pos, out_bits, B), finals


def _som_c_arrays(engine):
    if not hasattr(engine, "_som_c"):
        P = engine.num_positions
        F = engine.follow
        succ_off = [0]
        succ_idx = []
        for u in range(P):
            vs = np.flatnonzero(F[u])
            succ_idx.extend(int(v) for v in vs)
            succ_off.append(len(succ_idx))
        hop = engine.hop_mask.astype(np.int32)
        ent = np.flatnonzero(engine.float_mask).astype(np.int32)
        anc = np.flatnonzero(engine.anch_mask).astype(np.int32)
        engine._som_c = (
            np.ascontiguousarray(succ_off, dtype=np.int32),
            np.ascontiguousarray(succ_idx, dtype=np.int32),
            np.ascontiguousarray(ent),
            np.ascontiguousarray(hop[ent]),
            np.ascontiguousarray(anc),
            np.ascontiguousarray(hop[anc]),
        )
    return engine._som_c


def somnfa_scan_batch_native(engine, data, lengths, init_states,
                             base_offsets):
    """SOM-register NFA scan. Returns (hits per row
    [(pos, set_id, frm)...], final (mask, soms) states) or None."""
    lib = get_lib()
    if lib is None or engine.num_sets > 16:
        return None
    from ..runtime.nfa_host import _int_to_words, _words_to_int, pack_words

    _fw, reach_w, _flw, _aw, _acc, KW = pack_words(engine)
    if KW > 512:  # native scratch word cap (P <= 32768)
        return None
    P = engine.num_positions
    B, L = data.shape
    succ_off, succ_idx, ent, ent_hop, anc, anc_hop = _som_c_arrays(engine)
    gid = np.ascontiguousarray(engine.accept_gid, dtype=np.int32)
    b2c = np.ascontiguousarray(engine.byte_to_class, dtype=np.int32)
    data = np.ascontiguousarray(data, dtype=np.uint8)
    lengths = np.ascontiguousarray(lengths, dtype=np.int32)
    base = np.ascontiguousarray(base_offsets, dtype=np.int64)
    INF = np.int64((1 << 63) - 1)
    start_bit = 1 << P
    states0 = np.zeros((B, KW), np.uint64)
    soms0 = np.full((B, P), INF, np.int64)
    starts0 = np.zeros(B, np.uint8)
    for b, (s, sv) in enumerate(init_states):
        s = int(s)
        starts0[b] = 1 if s & start_bit else 0
        m = s & (start_bit - 1)
        states0[b] = _int_to_words(m, KW)
        si = 0
        while m:
            low = m & (-m)
            soms0[b, low.bit_length() - 1] = sv[si]
            si += 1
            m ^= low
    cap = 4096
    while True:
        out_row = np.empty(cap, np.int32)
        out_pos = np.empty(cap, np.int32)
        out_gid = np.empty(cap, np.int32)
        out_frm = np.empty(cap, np.int64)
        states = states0.copy()
        soms = soms0.copy()
        starts = starts0.copy()
        n = lib.hstpu_somnfa_scan_batch(
            _ptr(reach_w), _ptr(b2c), _ptr(succ_off), _ptr(succ_idx),
            _ptr(ent), _ptr(ent_hop), len(ent), _ptr(anc), _ptr(anc_hop),
            len(anc),
            _ptr(gid), P, KW, _ptr(data), B, L, _ptr(lengths), _ptr(base),
            _ptr(states), _ptr(soms), _ptr(starts),
            _ptr(out_row), _ptr(out_pos), _ptr(out_gid), _ptr(out_frm),
            cap,
        )
        if n <= cap:
            break
        cap = 1 << int(n - 1).bit_length()
    hits = [[] for _ in range(B)]
    for j in range(int(n)):
        hits[int(out_row[j])].append(
            (int(out_pos[j]), int(out_gid[j]), int(out_frm[j]))
        )
    finals = []
    for b in range(B):
        m = _words_to_int(states[b])
        sv = tuple(
            int(soms[b, p]) for p in range(P) if (m >> p) & 1
        )
        if starts[b]:
            m |= start_bit
        finals.append((m, sv))
    return hits, finals


def _confirm_c_tables(lit):
    """Pack the confirm index (lit_runtime._confirm_index) plus the
    factor atom tables (lit_runtime._atom_tables) into flat C arrays,
    cached on the lit object."""
    if hasattr(lit, "_confirm_c"):
        return lit._confirm_c
    from ..runtime.lit_runtime import _atom_tables, _confirm_index

    packed, flen_arr = _confirm_index(lit)
    G = len(packed)
    grp_cl = np.asarray([cl for (cl, *_r) in packed], np.int32)
    grp_mask = np.asarray([m for (_c, m, *_r) in packed], np.uint64)
    grp_off = np.zeros(G + 1, np.int64)
    vals_l, fids_l = [], []
    for i, (_cl, _m, vals, fids, _lt) in enumerate(packed):
        vals_l.append(vals)
        fids_l.append(fids)
        grp_off[i + 1] = grp_off[i] + len(vals)
    grp_vals = (np.concatenate(vals_l) if vals_l
                else np.zeros(0, np.uint64)).astype(np.uint64)
    grp_fids = (np.concatenate(fids_l) if fids_l
                else np.zeros(0, np.int64)).astype(np.int64)
    atom_vals, atom_masks, off, _flen, _width = _atom_tables(lit)
    atom_off = np.append(off, atom_vals.size)
    lit._confirm_c = (
        G,
        np.ascontiguousarray(grp_cl),
        np.ascontiguousarray(grp_mask),
        np.ascontiguousarray(grp_off),
        np.ascontiguousarray(grp_vals),
        np.ascontiguousarray(grp_fids),
        np.ascontiguousarray(flen_arr, dtype=np.int64),
        np.ascontiguousarray(atom_off),
        np.ascontiguousarray(atom_vals),
        np.ascontiguousarray(atom_masks),
    )
    return lit._confirm_c


def _validate_c_tables(lit):
    """Pack the global validator tables (lit_runtime._packed_validators)
    plus per-validator accept-set expansion arrays into C form."""
    if hasattr(lit, "_vc_tables"):
        return lit._vc_tables
    from ..runtime.lit_runtime import _packed_validators

    pack = _packed_validators(lit)
    if pack is None:
        lit._vc_tables = None
        return None
    (vid_arr, _trans_all, _acc_all, acce_all, b2c_all, start_g, float_g,
     shim) = pack
    eids = sorted(e for e in lit.validators if e not in lit.rev_validators)
    V = len(eids)
    vset_base = np.zeros(V, np.int64)
    exp_off = [0]
    exp_e: list = []
    exp_a: list = []
    base_sets = 0
    for i, e in enumerate(eids):
        v = lit.validators[e]
        vset_base[i] = base_sets
        ns = len(v.set_offsets) - 1
        for k in range(ns):
            lo, hi = int(v.set_offsets[k]), int(v.set_offsets[k + 1])
            exp_e.extend(int(x) for x in v.set_exprs[lo:hi])
            exp_a.extend(int(x) for x in v.set_adjusts[lo:hi])
            exp_off.append(len(exp_e))
        base_sets += ns
    lit._vc_tables = (
        np.ascontiguousarray(vid_arr, dtype=np.int64),
        np.ascontiguousarray(shim.trans),
        np.int32(shim.trans.shape[1]),
        np.ascontiguousarray(shim.accept_id),
        np.ascontiguousarray(acce_all, dtype=np.int32),
        np.ascontiguousarray(b2c_all, dtype=np.int32),
        np.ascontiguousarray(start_g, dtype=np.int64),
        np.ascontiguousarray(float_g, dtype=np.int64),
        np.ascontiguousarray(vset_base),
        np.ascontiguousarray(exp_off, dtype=np.int64),
        np.ascontiguousarray(exp_e, dtype=np.int64),
        np.ascontiguousarray(exp_a, dtype=np.int64),
    )
    return lit._vc_tables


def validate_windows_native(
    lit, corpus, eidx_w, ws, we, b_w,
    block_starts, block_ends, block_anchored, block_final,
):
    """Native batched window validation. Returns a set of
    (block, expr, to_local, 0) records, or None when unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    tabs = _validate_c_tables(lit)
    if tabs is None:
        return None
    (vid_arr, trans, cmax, acc, acce, b2c, start_g, float_g, vset_base,
     exp_off, exp_e, exp_a) = tabs
    corpus = np.ascontiguousarray(corpus, dtype=np.uint8)
    eidx_w = np.ascontiguousarray(eidx_w, dtype=np.int64)
    ws = np.ascontiguousarray(ws, dtype=np.int64)
    we = np.ascontiguousarray(we, dtype=np.int64)
    b_w = np.ascontiguousarray(b_w, dtype=np.int64)
    bs = np.ascontiguousarray(block_starts, dtype=np.int64)
    be = np.ascontiguousarray(block_ends, dtype=np.int64)
    anch = np.ascontiguousarray(block_anchored, dtype=np.uint8)
    final = np.ascontiguousarray(block_final, dtype=np.uint8)
    cap = max(256, 4 * eidx_w.shape[0])
    while True:
        out_b = np.empty(cap, np.int64)
        out_e = np.empty(cap, np.int64)
        out_to = np.empty(cap, np.int64)
        cnt = lib.hstpu_validate_windows(
            _ptr(corpus), corpus.shape[0],
            _ptr(eidx_w), _ptr(ws), _ptr(we), _ptr(b_w), eidx_w.shape[0],
            _ptr(bs), _ptr(be), _ptr(anch), _ptr(final),
            _ptr(vid_arr), vid_arr.shape[0],
            _ptr(trans), cmax, _ptr(acc), _ptr(acce), _ptr(b2c),
            _ptr(start_g), _ptr(float_g), _ptr(vset_base),
            _ptr(exp_off), _ptr(exp_e), _ptr(exp_a),
            _ptr(out_b), _ptr(out_e), _ptr(out_to), cap,
        )
        if cnt <= cap:
            break
        cap = 1 << int(cnt - 1).bit_length()
    k = int(cnt)
    return set(zip(out_b[:k].tolist(), out_e[:k].tolist(),
                   out_to[:k].tolist(), (0,) * k))


def confirm_native(lit, corpus, block_starts, pos):
    """Exact confirm of ascending candidate positions. Returns
    (fid_array, pos_array) or None when the native library is absent."""
    lib = get_lib()
    if lib is None:
        return None
    (G, grp_cl, grp_mask, grp_off, grp_vals, grp_fids, flen,
     atom_off, atom_vals, atom_masks) = _confirm_c_tables(lit)
    corpus = np.ascontiguousarray(corpus, dtype=np.uint8)
    block_starts = np.ascontiguousarray(block_starts, dtype=np.int64)
    pos = np.ascontiguousarray(pos, dtype=np.int64)
    n = corpus.shape[0]
    cap = max(256, 2 * pos.shape[0])
    while True:
        out_fid = np.empty(cap, np.int64)
        out_pos = np.empty(cap, np.int64)
        cnt = lib.hstpu_confirm(
            _ptr(corpus), n, _ptr(block_starts), block_starts.shape[0],
            _ptr(pos), pos.shape[0], G,
            _ptr(grp_cl), _ptr(grp_mask), _ptr(grp_off), _ptr(grp_vals),
            _ptr(grp_fids),
            _ptr(flen), _ptr(atom_off), _ptr(atom_vals), _ptr(atom_masks),
            _ptr(out_fid), _ptr(out_pos), cap,
        )
        if cnt <= cap:
            break
        cap = 1 << int(cnt - 1).bit_length()
    k = int(cnt)
    return out_fid[:k], out_pos[:k]


# pair tables keyed by the masks array's identity; the entry holds a
# strong reference to the masks so the id stays valid for the cache's life
_pair_tabs: dict = {}


def _pair_table(masks: np.ndarray) -> np.ndarray:
    """8 KB bit table of exact mask-row-0,1 joint survival, indexed by
    (c[i] | c[i-1] << 8). Built once per database's teddy tables."""
    ent = _pair_tabs.get(id(masks))
    if ent is not None and ent[0] is masks:
        return ent[1]
    W = masks.shape[1]
    alive = np.zeros((256, 256), dtype=bool)  # [x0 (byte at i), x1 (i-1)]
    for w in range(W):
        r0 = masks[0, w].astype(np.int64)  # byte at i
        r1 = masks[1, w].astype(np.int64)  # byte at i-1
        alive |= (r0[:, None] & r1[None, :]) != 0
    # bit index = c[i-1] | c[i] << 8 (one little-endian u16 load in C);
    # padded 4 bytes so the SIMD gate's u32 gathers at byte key>>3 stay
    # in bounds
    tab = np.concatenate([
        np.packbits(alive.reshape(-1), bitorder="little"),
        np.zeros(4, np.uint8),
    ])
    if len(_pair_tabs) > 16:
        _pair_tabs.clear()
    _pair_tabs[id(masks)] = (masks, tab)
    return tab


_pair8_tabs: dict = {}


def _pair_table8(masks: np.ndarray) -> np.ndarray:
    """64 KB byte table of exact mask-row-0,1 joint survival, indexed by
    the same (c[i] << 8 | c[i-1]) key as _pair_table. One byte load per
    position beats the bit table's load+shift+mask extraction; the table
    stays L2-resident per database."""
    ent = _pair8_tabs.get(id(masks))
    if ent is not None and ent[0] is masks:
        return ent[1]
    W = masks.shape[1]
    alive = np.zeros((256, 256), dtype=bool)  # [x0 (byte at i), x1 (i-1)]
    for w in range(W):
        r0 = masks[0, w].astype(np.int64)
        r1 = masks[1, w].astype(np.int64)
        alive |= (r0[:, None] & r1[None, :]) != 0
    tab = np.ascontiguousarray(alive.reshape(-1).astype(np.uint8))
    if len(_pair8_tabs) > 16:
        _pair8_tabs.clear()
    _pair8_tabs[id(masks)] = (masks, tab)
    return tab


_nib_tabs: dict = {}


def _nib_tables(masks: np.ndarray) -> np.ndarray:
    """[M, 64] uint8 PSHUFB tables for the SIMD super-bucket gate: per
    mask row, a 16-entry lo-nibble table (duplicated across both AVX2
    lanes) then a 16-entry hi-nibble table. Byte value c's super-bucket
    candidacy byte is lo[c & 15] & hi[c >> 4] — a superset of the exact
    masks projected onto bucket-index mod 8 (bucket w*32+b -> b % 8).
    Returns (tables, estimated gate survival rate)."""
    ent = _nib_tabs.get(id(masks))
    if ent is not None and ent[0] is masks:
        return ent[1], ent[2]
    M, W, _ = masks.shape
    u = masks.view(np.uint32) if masks.dtype == np.int32 else \
        masks.astype(np.int64).astype(np.uint32)
    nib = np.zeros((M, 64), np.uint8)
    c = np.arange(256)
    for m in range(M):
        sb = np.zeros(256, np.uint8)  # per byte value: super-bucket byte
        for s in range(8):
            grp = np.uint32(0x01010101) << np.uint32(s)
            hit = ((u[m] & grp) != 0).any(axis=0)  # any W word, bits = s mod 8
            sb |= (hit.astype(np.uint8) << s)
        lo = np.zeros(16, np.uint8)
        hi = np.zeros(16, np.uint8)
        np.bitwise_or.at(lo, c & 15, sb)
        np.bitwise_or.at(hi, c >> 4, sb)
        nib[m, 0:16] = lo
        nib[m, 16:32] = lo
        nib[m, 32:48] = hi
        nib[m, 48:64] = hi
    # estimated per-position gate survival under uniform printable bytes
    # (independence across rows, per super-bucket): decides nib vs pair
    pr = np.arange(32, 127)
    q = np.ones(8)
    for m in range(M):
        cand = nib[m, pr & 15] & nib[m, 32 + (pr >> 4)]
        for s in range(8):
            q[s] *= ((cand >> s) & 1).mean()
    survival = 1.0 - np.prod(1.0 - q)
    nib = np.ascontiguousarray(nib.reshape(-1))
    if len(_nib_tabs) > 16:
        _nib_tabs.clear()
    _nib_tabs[id(masks)] = (masks, nib, float(survival))
    return nib, float(survival)


def teddy_filter_native(corpus, masks):
    """Returns (pos, words) or None."""
    lib = get_lib()
    if lib is None:
        return None
    M, W, _ = masks.shape
    pair_tab = _pair_table(masks) if M >= 2 else None  # key on caller's array
    pair8_tab = _pair_table8(masks) if M >= 2 else None
    nib, nib_survival = _nib_tables(masks)
    # dense mask sets saturate the 8-super-bucket gate; the scalar pair
    # loop (one L1/L2 byte load per position) wins once most blocks
    # survive
    use_nib = nib_survival < 0.04 or pair_tab is None
    masks = np.ascontiguousarray(masks, dtype=np.int32)
    corpus = np.ascontiguousarray(corpus, dtype=np.uint8)
    n = corpus.shape[0]
    cap = max(1024, n // 64)
    zero_pair = np.zeros(0, np.uint8)
    while True:
        out_pos = np.empty(cap, np.int64)
        out_words = np.empty((W, cap), np.int32)
        if use_nib:
            cnt = lib.hstpu_teddy_filter_nib(
                _ptr(masks), M, W,
                _ptr(pair_tab if pair_tab is not None else zero_pair),
                _ptr(nib), _ptr(corpus), n, _ptr(out_pos),
                _ptr(out_words), cap,
            )
        else:
            cnt = lib.hstpu_teddy_filter_pair8(
                _ptr(masks), M, W, _ptr(pair8_tab), _ptr(corpus), n,
                _ptr(out_pos), _ptr(out_words), cap,
            )
        if cnt <= cap:
            break
        cap = 1 << int(cnt - 1).bit_length()
    k = int(cnt)
    return out_pos[:k], out_words[:, :k]
