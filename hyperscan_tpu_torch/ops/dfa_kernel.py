"""Chunk-parallel DFA scan on a torch device.

Reference analogues: the McClellan/Sheng byte engines (src/nfa/mcclellan.c,
sheng_impl.h) and FDR's zone machinery (src/fdr/fdr.c:45-133), which
splits a buffer into boundary-safe regions. This is the port of the JAX
package's `hyperscan_tpu/ops/dfa_kernel.py`:

- A *scanning* DFA (float restart folded into every state) whose patterns
  have a maximum match width D has bounded memory: the state at position
  p is the state reached by scanning the last H >= D-1 bytes from the
  float state. So the corpus splits into CS-byte chunks, each scanned on
  its own from an H-byte halo, and all chunks advance in parallel
  (`dfa_scan_corpus_device`).
- Unbounded engines cannot use halos. They scan every chunk from a
  speculated entry and a host pass chains the exit states, rescanning the
  chunks whose speculation missed (`dfa_scan_corpus_device_speculative`);
  cyclic bit-NFAs do the same on their lazy-DFA core
  (`nfa_scan_corpus_device_speculative`).

One kernel carries all three: `dfa_scan` (csrc/dfa_scan.cu, kernel C),
one thread per chunk of H + CS = 512 bytes, reading the flat corpus with a
per-chunk (start, vfrom, vto, entry state) row. Positions t of a chunk
are live for vfrom <= t < vto; the state steps on live positions,
`s = trans[s, b2c[byte]]`, and a live position t >= H with a nonzero
`accept_id` of the state after the step is a record (chunk, t, accept
id). The chunk's final state is the state after its last live position
(its entry when none is live). The wrapper `dfa_scan_chunks` launches the
kernel for a CUDA tensor and counts the launch in `LAUNCHES`; for a CPU
tensor it runs the plain PyTorch version `dfa_scan_chunks_plain`, which
is also what the kernel is held against on the card. (The same source's
row mode is the lockstep batch scan of `ops/dfa.py`.)

None of the TPU's layout is carried over (the transposed [H+CS, rows,
128] copy of the corpus with materialised halos, group padding, the
select-tree table lookup, the dense accept plane and its sparse
extraction): records leave the kernel through one atomic counter.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..trace import count
from ._build import LAUNCHES
from .teddy import (_check_corpus, _p2, get_capacity_hint,
                    set_capacity_hint, upload_blocks)

CHUNK = 512       # H + CS: the positions a chunk's thread steps through
H_ALIGN = 4       # halos round up to this (the reference's T_BLOCK)
MAX_HALO = 256    # engines deeper than this take the speculative scan
SPEC_CS = 512     # speculative chunk body size (no halo)
# Step tables: one entry a (state, class), 4 bytes in the chunk scan (4 x
# next state x C and the next state's accept id, 16 bits each) and 8 in
# the row mode (next state x C, accept id). Each mode builds its table in
# shared memory a block when it fits that mode's limit here (and, for the
# chunk scan, the 16-bit packing); larger DFAs are read as trans and accept
# from global memory (L2-resident). On the H100 (PERF.md, from
# tools_torch_kernel_ab.py) shared tables were faster up to S x C = 12,288
# in the chunk scan, so its limit is the packing's own; in the row mode up
# to 6,144 (48 KiB), and slower at 12,288 (96 KiB), where a one-warp block
# a table leaves two warps an SM.
TABLE_LIMITS = {"chunks": 64 * 1024, "rows": 48 * 1024}
ENTRY_BYTES = {"chunks": 4, "rows": 8}
# chunks per step of the plain version: bounds its memory
_PLAIN_CHUNKS = 1 << 14


def chunk_shape(engine) -> Tuple[int, int]:
    """(halo H, chunk body size CS) for a bounded engine; H + CS = 512."""
    d = engine.max_depth
    if d is None:
        raise ValueError("an unbounded engine has no chunk halo")
    h = min(max(d - 1, 0), MAX_HALO)
    h = -(-h // H_ALIGN) * H_ALIGN
    return h, CHUNK - h


@dataclasses.dataclass
class DfaTables:
    """One DFA's tables on one device."""

    trans: torch.Tensor  # [S * C] int32, row-major
    b2c: torch.Tensor  # [256] int32
    accept: torch.Tensor  # [S] int32
    S: int
    C: int

    @property
    def nbytes(self) -> int:
        return 4 * (self.S * self.C + self.S)

    def step_bytes(self, mode: str) -> int:
        """Bytes of `mode`'s shared step table ("chunks" or "rows")."""
        return ENTRY_BYTES[mode] * self.S * self.C

    @functools.cached_property
    def max_accept(self) -> int:
        """The largest accept id (read from the device once)."""
        return int(self.accept.max()) if self.accept.numel() else 0


def device_tables(engine, device) -> DfaTables:
    """Upload-once tables, cached on the engine per device (under this
    package's own attribute name)."""
    device = torch.device(device)
    cache = engine.__dict__.setdefault("_torch_dfa_tables", {})
    key = str(device)
    if key not in cache:
        trans = np.asarray(engine.trans, dtype=np.int32)
        S, C = trans.shape
        cache[key] = DfaTables(
            torch.tensor(trans.reshape(-1), device=device),
            torch.tensor(np.asarray(engine.byte_to_class, np.int32),
                         device=device),
            torch.tensor(np.asarray(engine.accept_id, np.int32),
                         device=device),
            int(S), int(C))
    return cache[key]


@dataclasses.dataclass
class ChunkPlan:
    """Per-chunk rows of a chunked scan over a flat corpus."""

    meta: np.ndarray  # [nch, 4] int32: (start, vfrom, vto, entry state)
    block: np.ndarray  # [nch] int64: block of each chunk
    body_start: np.ndarray  # [nch] int64: body offset within its block
    last: np.ndarray  # [B] int64: each block's last chunk


def plan_chunks(starts: np.ndarray, lens: np.ndarray, H: int, CS: int,
                entry: np.ndarray, float_state: int) -> ChunkPlan:
    """Chunk rows for blocks at flat `starts` of `lens` bytes: every block
    gets max(1, ceil(len / CS)) chunks; `start` is the flat offset of
    position t = 0 (the body start minus H), a block's first chunk has a
    dead halo (vfrom = H) and enters in `entry[block]`, the others enter
    in the float state and re-derive it over their halo."""
    starts = np.asarray(starts, dtype=np.int64)
    lens = np.asarray(lens, dtype=np.int64)
    nch_b = np.maximum(1, -(-lens // CS))
    first_idx = np.cumsum(nch_b) - nch_b
    block = np.repeat(np.arange(len(lens), dtype=np.int64), nch_b)
    k = np.arange(int(nch_b.sum()), dtype=np.int64) - first_idx[block]
    body_start = k * CS
    first = k == 0
    meta = np.empty((len(block), 4), dtype=np.int32)
    meta[:, 0] = starts[block] + body_start - H
    meta[:, 1] = np.where(first, H, 0)
    meta[:, 2] = H + np.minimum(CS, lens[block] - body_start)
    meta[:, 3] = np.where(first, np.asarray(entry, np.int64)[block],
                          float_state)
    return ChunkPlan(meta, block, body_start, first_idx + nch_b - 1)


# --------------------------------------------------------------------------
# kernel C: the chunk scan
# --------------------------------------------------------------------------


def _check_meta(meta: torch.Tensor, H: int, capacity: int) -> None:
    if meta.dtype != torch.int32 or meta.dim() != 2 or meta.shape[1] != 4:
        raise ValueError("chunk rows must be an int32 [nch, 4] tensor")
    if not meta.is_contiguous():
        raise ValueError("chunk rows must be contiguous")
    if not 0 <= H < CHUNK:
        raise ValueError(f"halo H={H} outside 0..{CHUNK - 1}")
    if capacity < 1:
        raise ValueError("capacity must be positive")


def dfa_scan_chunks_plain(corpus_u8: torch.Tensor, tables: DfaTables,
                          meta: torch.Tensor, H: int, capacity: int):
    """Plain PyTorch version of kernel C (same contract as
    `dfa_scan_chunks`): a lockstep loop over the 512 steps with gathers
    over all chunks, a group of chunks at a time so that its memory stays
    bounded. Records come ordered by (chunk, t); rows past the total
    hold 0."""
    dev = corpus_u8.device
    n = corpus_u8.numel()
    nch = meta.shape[0]
    src = corpus_u8 if n else corpus_u8.new_zeros(1)
    trans, b2c, acc = tables.trans.long(), tables.b2c.long(), \
        tables.accept.long()
    finals = torch.empty(nch, dtype=torch.int32, device=dev)
    parts: List[torch.Tensor] = []
    for c0 in range(0, nch, _PLAIN_CHUNKS):
        m = meta[c0:c0 + _PLAIN_CHUNKS].long()
        start, vfrom, vto, s = m.unbind(1)
        aids = torch.zeros((m.shape[0], CHUNK), dtype=torch.int64,
                           device=dev)
        for t in range(CHUNK):
            live = (vfrom <= t) & (t < vto)
            b = src[(start + t).clamp(0, src.numel() - 1)].long()
            s = torch.where(live, trans[s * tables.C + b2c[b]], s)
            if t >= H:
                aids[:, t] = torch.where(live, acc[s], 0)
        finals[c0:c0 + m.shape[0]] = s.int()
        c, t = torch.nonzero(aids, as_tuple=True)
        parts.append(torch.stack([c + c0, t, aids[c, t]], 1))
    recs_all = (torch.cat(parts) if parts
                else torch.zeros((0, 3), dtype=torch.int64, device=dev))
    total = recs_all.shape[0]
    k = min(total, capacity)
    recs = torch.zeros((capacity, 3), dtype=torch.int32, device=dev)
    recs[:k] = recs_all[:k].int()
    return recs, torch.tensor([total], dtype=torch.int32, device=dev), \
        finals


def _lib():
    from ._build import library

    lib = library("dfa_scan")
    if not getattr(lib, "_typed", False):
        vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.hs_dfa_scan.restype = ci
        lib.hs_dfa_scan.argtypes = [
            vp, cll, vp, ci, vp, vp, vp, ci, ci, ci, ci, vp, ci, vp, vp, vp]
        lib.hs_dfa_scan_rows.restype = ci
        lib.hs_dfa_scan_rows.argtypes = [
            vp, ci, ci, vp, vp, vp, vp, vp, ci, ci, ci, vp, vp, vp]
        lib.hs_dfa_scan_error.restype = ctypes.c_char_p
        lib.hs_dfa_scan_error.argtypes = [ci]
        lib._typed = True
    return lib


def dfa_scan_chunks(corpus_u8: torch.Tensor, tables: DfaTables,
                    meta: torch.Tensor, H: int, capacity: int, *,
                    placement: Optional[str] = None):
    """Kernel C: scan every chunk of a flat corpus.

    corpus_u8 : flat uint8 tensor of n bytes (n < 2^31)
    tables    : DfaTables on the corpus's device
    meta      : int32 [nch, 4] chunk rows (start, vfrom, vto, entry);
                positions start + t for live t lie inside the corpus
    H         : the halo: records only for t >= H
    capacity  : record slots
    placement : "shared" or "global" table placement (CUDA only); by
                default `placement_of(tables, None, "chunks")`
    Returns (recs int32 [capacity, 3] = (chunk, t, accept id) for the
    first min(total, capacity) records, total int32 [1] = the exact
    record count, finals int32 [nch]). The kernel's record order is
    arbitrary (one atomic counter); callers sort."""
    _check_corpus(corpus_u8)
    _check_meta(meta, H, capacity)
    if corpus_u8.device.type == "cpu":
        return dfa_scan_chunks_plain(corpus_u8, tables, meta, H, capacity)
    if corpus_u8.device.type != "cuda":
        raise ValueError(f"unsupported device {corpus_u8.device}")
    if corpus_u8.data_ptr() % 16 or meta.data_ptr() % 16:
        raise ValueError("corpus and chunk rows must be 16-byte aligned")
    if meta.device != corpus_u8.device or \
            tables.trans.device != corpus_u8.device:
        raise ValueError("corpus, chunk rows and tables lie on different "
                         "devices")
    if not 1 <= tables.C <= 256:
        raise ValueError(f"{tables.C} byte classes outside 1..256")
    shared = placement_of(tables, placement, "chunks") == "shared"
    lib = _lib()
    dev = corpus_u8.device
    nch = meta.shape[0]
    recs = torch.empty((capacity, 3), dtype=torch.int32, device=dev)
    total = torch.zeros(1, dtype=torch.int32, device=dev)
    finals = torch.empty(nch, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.hs_dfa_scan(
        corpus_u8.data_ptr(), corpus_u8.numel(), meta.data_ptr(), nch,
        tables.trans.data_ptr(), tables.b2c.data_ptr(),
        tables.accept.data_ptr(), tables.S, tables.C, H, int(shared),
        recs.data_ptr(), capacity, total.data_ptr(), finals.data_ptr(),
        stream)
    if rc:
        raise RuntimeError("dfa_scan launch failed: "
                           + lib.hs_dfa_scan_error(rc).decode())
    if nch:
        LAUNCHES["dfa_scan"] += 1
    return recs, total, finals


def placement_of(tables: DfaTables, placement: Optional[str],
                 mode: str) -> str:
    """The table placement of a kernel-C launch in `mode` ("chunks", the
    chunk scan, or "rows", the row mode): "shared" or "global" as asked,
    by default shared when the mode's step table fits TABLE_LIMITS[mode].
    The chunk scan's shared entries pack the next state's table offset
    and its accept id in 16 bits each: a DFA past that runs on global
    tables, and asking it for shared ones raises."""
    if placement not in (None, "shared", "global"):
        raise ValueError(f"unknown table placement {placement!r}")
    if placement == "global":
        return placement
    packs = mode == "rows" or (
        4 * tables.S * tables.C <= 1 << 16 and tables.max_accept < 1 << 16)
    if placement == "shared":
        if not packs:
            raise ValueError("a DFA this large (or accept ids past 2^16) "
                             "needs global tables")
        return placement
    return ("shared" if packs
            and tables.step_bytes(mode) <= TABLE_LIMITS[mode] else "global")


def _run_chunks(engine, corpus_t: torch.Tensor, tables: DfaTables,
                plan: ChunkPlan, H: int, capacity: int, hint_key: str):
    """Kernel C over a plan, dispatched again on the device at the next
    power of two while the records overflow (the capacity is learned on
    `engine` under `hint_key`). Returns (chunk, t, accept id) int64
    arrays sorted by (chunk, t) and the per-chunk finals."""
    meta = torch.from_numpy(plan.meta).to(corpus_t.device)
    cap = max(capacity, get_capacity_hint(engine, hint_key))
    while True:
        recs, total, finals = dfa_scan_chunks(corpus_t, tables, meta, H,
                                              cap)
        tot = int(total)
        if tot <= cap:
            break
        count("redispatches")
        cap = _p2(tot)
    set_capacity_hint(engine, hint_key, cap)
    r = recs[:tot].long()
    r = r[torch.argsort(r[:, 0] * CHUNK + r[:, 1])].cpu().numpy()
    return r[:, 0], r[:, 1], r[:, 2], finals.cpu().numpy()


def _entries(engine, block_anchored, init_states, n_blocks) -> np.ndarray:
    """First-chunk entry states: the carried state, else the anchored
    start or the float state."""
    if init_states is not None:
        return np.asarray(init_states, dtype=np.int64)
    return np.where(np.asarray(block_anchored, bool)[:n_blocks],
                    engine.start_state, engine.float_state)


def dfa_scan_corpus(engine, corpus_t: torch.Tensor, starts, lens,
                    block_anchored, capacity: int = 1 << 14,
                    init_states: Optional[np.ndarray] = None):
    """`dfa_scan_corpus_device` over blocks of an uploaded flat corpus
    (blocks at `starts` of `lens` bytes)."""
    H, CS = chunk_shape(engine)
    plan = plan_chunks(starts, lens, H, CS,
                       _entries(engine, block_anchored, init_states,
                                len(lens)),
                       engine.float_state)
    c, t, aids, fin = _run_chunks(
        engine, corpus_t, device_tables(engine, corpus_t.device), plan, H,
        capacity, "dfa")
    recs = (plan.block[c], plan.body_start[c] + t - H, aids)
    return recs, fin[plan.last].astype(np.int32)


def dfa_scan_corpus_device(
    engine, blocks: List[bytes], block_anchored: np.ndarray,
    capacity: int = 1 << 14, init_states: Optional[np.ndarray] = None, *,
    device="cuda",
):
    """Scan concatenated blocks with a bounded-depth engine.

    With ``init_states`` (int32 [n_blocks]), each block's first chunk
    enters in that carried state (streaming: per-stream end-of-write
    states; the halo is skipped for first chunks, so the carried state
    fully determines continuation — reference analogue: stream state
    resumption, src/rose/stream.c:545). Otherwise first chunks enter
    anchored-start or float per ``block_anchored``.

    Returns (records as parallel arrays (block_idx, pos_local,
    accept_set_id), finals [n_blocks] end-of-block states).
    """
    _corpus, corpus_t, starts, lens = upload_blocks(blocks, device)
    return dfa_scan_corpus(engine, corpus_t, starts, lens, block_anchored,
                           capacity, init_states)


def dfa_spec_chain(engine, corpus: np.ndarray, starts, lens,
                   plan: ChunkPlan, fin: np.ndarray):
    """Host pass of the speculative DFA scan (reference:
    hyperscan_tpu/ops/dfa_kernel.py:390-448): chain the true entry
    states left to right; a chunk whose true entry equals its speculated
    entry is exact, any other is rescanned on the host from the true
    entry. Returns (rescanned chunk ids, extra (block, pos, set id)
    records, finals [n_blocks])."""
    from ..runtime.smallwrite import dfa_scan_host

    CS = SPEC_CS
    n_blocks = len(lens)
    finals = np.zeros(n_blocks, np.int32)
    entry0 = plan.meta[:, 3].tolist()
    body_len = plan.meta[:, 2].tolist()  # H = 0
    fin_l = fin.tolist()
    rescanned: List[int] = []
    extra: List[Tuple[int, np.ndarray, np.ndarray]] = []
    ci = 0
    for bi in range(n_blocks):
        n = int(lens[bi])
        base = int(starts[bi])
        nch = max(1, -(-n // CS))
        actual = entry0[ci]  # first chunk's entry is exact
        for k in range(nch):
            cc = ci + k
            if actual == entry0[cc]:
                actual = fin_l[cc]
                continue
            # speculation missed: exact host rescan from the true entry
            rescanned.append(cc)
            bl = body_len[cc]
            row = np.zeros((1, CS), np.uint8)
            row[0, :bl] = corpus[base + k * CS:base + k * CS + bl]
            hits, fin_h = dfa_scan_host(
                engine, row, np.asarray([bl], np.int64),
                np.asarray([actual], np.int32))
            ph, sh = hits[0]
            if ph.size:
                extra.append((bi, k * CS + ph.astype(np.int64),
                              sh.astype(np.int64)))
            actual = int(fin_h[0])
        finals[bi] = actual
        ci += nch
    return rescanned, extra, finals


def _drop_rescanned(c, t, aids, rescanned):
    if rescanned:
        keep = ~np.isin(c, np.asarray(rescanned, dtype=c.dtype))
        c, t, aids = c[keep], t[keep], aids[keep]
    return c, t, aids


def dfa_scan_corpus_speculative(engine, corpus: np.ndarray,
                                corpus_t: torch.Tensor, starts, lens,
                                block_anchored, capacity: int = 1 << 14,
                                init_states: Optional[np.ndarray] = None):
    """`dfa_scan_corpus_device_speculative` over blocks of an uploaded
    flat corpus (`corpus` is its host copy, for the rescans)."""
    plan = plan_chunks(starts, lens, 0, SPEC_CS,
                       _entries(engine, block_anchored, init_states,
                                len(lens)),
                       engine.float_state)
    c, t, aids, fin = _run_chunks(
        engine, corpus_t, device_tables(engine, corpus_t.device), plan, 0,
        capacity, "dfa-spec")
    rescanned, extra, finals = dfa_spec_chain(engine, corpus, starts, lens,
                                              plan, fin)
    c, t, aids = _drop_rescanned(c, t, aids, rescanned)
    bi_a = plan.block[c]
    pos_a = plan.body_start[c] + t
    if extra:
        bi_a = np.concatenate(
            [bi_a] + [np.full(p.size, b, np.int64) for (b, p, _s) in extra])
        pos_a = np.concatenate([pos_a] + [p for (_b, p, _s) in extra])
        aids = np.concatenate([aids] + [s for (_b, _p, s) in extra])
    return (bi_a, pos_a, aids), finals


def dfa_scan_corpus_device_speculative(
    engine, blocks: List[bytes], block_anchored: np.ndarray,
    capacity: int = 1 << 14, init_states: Optional[np.ndarray] = None, *,
    device="cuda",
):
    """Scan an *unbounded-depth* engine on device by chunk speculation.

    Unbounded engines cannot halo-parallelize (the state at a chunk
    boundary may depend on the whole prefix). Instead every chunk scans
    in parallel from the float-rest state (block-first chunks from the
    carried/anchored entry), and a host pass chains the per-chunk exit
    states left to right: a chunk whose true entry equals its speculated
    entry is already exact; a mismatched chunk is rescanned host-native
    from the true entry, cascading until the chain re-synchronizes with
    the float state. Scanning DFAs re-anchor at the float closure, so on
    typical data nearly all chunks validate and throughput is the device
    kernel's; the worst case degrades to the host scan it replaces.

    Returns ((block_idx, pos_local, accept_set_id), finals [n_blocks]).
    """
    corpus, corpus_t, starts, lens = upload_blocks(blocks, device)
    return dfa_scan_corpus_speculative(engine, corpus, corpus_t, starts,
                                       lens, block_anchored, capacity,
                                       init_states)


def _mask_ints(d) -> List[int]:
    """DFA state id -> NFA subset mask as Python ints, cached on the
    DFA under this package's own attribute name."""
    if "_torch_mask_ints" not in d.__dict__:
        sm = d.state_masks
        ints = []
        for sid in range(sm.shape[0]):
            v = 0
            for w in range(sm.shape[1] - 1, -1, -1):
                v = (v << 64) | int(sm[sid, w])
            ints.append(v)
        d._torch_mask_ints = ints
    return d._torch_mask_ints


def nfa_spec_chain(engine, corpus: np.ndarray, starts, lens,
                   block_anchored, plan: ChunkPlan, fin: np.ndarray):
    """Host pass of the speculative NFA scan (reference:
    hyperscan_tpu/ops/dfa_kernel.py:492-560): chain exact NFA activation
    masks through the per-chunk DFA exits; a chunk is valid iff its true
    entry mask equals the speculated one and its exit stayed inside the
    explored core, any other is rescanned with the host NFA loop.
    Returns (rescanned chunk ids, host (block, pos, accept bits)
    records, finals [n_blocks] NFA states)."""
    from ..runtime.scan import engine_scan_host

    d = engine.spec_dfa
    CS = SPEC_CS
    mask_ints = _mask_ints(d)
    sink = -1 if d.sink_state is None else int(d.sink_state)
    start_bit = 1 << engine.num_positions
    n_blocks = len(lens)
    finals: List[int] = [0] * n_blocks
    entry0 = plan.meta[:, 3].tolist()
    body_len = plan.meta[:, 2].tolist()  # H = 0
    fin_l = fin.tolist()
    rescanned: List[int] = []
    host_records: List[Tuple[int, np.ndarray, np.ndarray]] = []
    ci = 0
    for bi in range(n_blocks):
        n = int(lens[bi])
        base = int(starts[bi])
        nch = max(1, -(-n // CS))
        actual = (engine.start_state if block_anchored[bi]
                  else engine.float_state)
        for k in range(nch):
            cc = ci + k
            bl = body_len[cc]
            if bl == 0:
                continue
            spec = entry0[cc]
            exit_s = fin_l[cc]
            amask = int(actual) & (start_bit - 1)
            a_is_start = bool(int(actual) & start_bit)
            if (amask == mask_ints[spec]
                    and a_is_start == (spec == d.start_state)
                    and exit_s != sink):
                actual = mask_ints[exit_s]
                continue
            # speculation missed or the core was left: exact host rescan
            rescanned.append(cc)
            row = np.zeros((1, CS), np.uint8)
            row[0, :bl] = corpus[base + k * CS:base + k * CS + bl]
            hits, fin_h = engine_scan_host(
                engine, row, np.asarray([bl], np.int64), [actual])
            ph, hv = hits[0]
            if len(ph):
                host_records.append((bi, k * CS + np.asarray(ph, np.int64),
                                     np.asarray(hv, np.int64)))
            actual = int(fin_h[0])
        finals[bi] = int(actual)
        ci += nch
    return rescanned, host_records, finals


def nfa_scan_corpus_speculative(engine, corpus: np.ndarray,
                                corpus_t: torch.Tensor, starts, lens,
                                block_anchored, capacity: int = 1 << 14):
    """`nfa_scan_corpus_device_speculative` over blocks of an uploaded
    flat corpus (`corpus` is its host copy, for the rescans)."""
    d = engine.spec_dfa
    anch = np.asarray(block_anchored, bool)[:len(lens)]
    plan = plan_chunks(starts, lens, 0, SPEC_CS,
                       np.where(anch, d.start_state, d.float_state),
                       d.float_state)
    c, t, aids, fin = _run_chunks(
        engine, corpus_t, device_tables(d, corpus_t.device), plan, 0,
        capacity, "nfa-spec")
    rescanned, host_records, finals = nfa_spec_chain(
        engine, corpus, starts, lens, anch, plan, fin)
    c, t, aids = _drop_rescanned(c, t, aids, rescanned)
    return (plan.block[c], plan.body_start[c] + t, aids), host_records, \
        finals


def nfa_scan_corpus_device_speculative(
    engine, blocks: List[bytes], block_anchored: np.ndarray,
    capacity: int = 1 << 14, *, device="cuda",
):
    """Device scan for *cyclic* bit-NFA engines via their lazy-DFA core.

    The engine's ``spec_dfa`` (partial determinization of the reachable
    subset space, with an absorbing unknown-subset sink) scans every
    chunk speculatively from the float state; the host chains exact NFA
    activation masks through the per-chunk DFA exits (state_masks maps
    DFA ids back to subsets). A chunk is valid iff its true entry mask
    equals the speculated one AND the device exit stayed inside the
    explored core; everything else rescans exactly with the host
    word-packed NFA loop (reference analogue: SIMD LimEx execution,
    src/nfa/limex_runtime_impl.h:29-33).

    Returns ((block_idx, pos_local, dfa_accept_set_id) device records to
    expand with ``engine.spec_dfa``, a list of (block_idx, pos_array,
    nfa_accept_bits) host-rescan records to expand with ``engine``, and
    per-block final NFA states).
    """
    corpus, corpus_t, starts, lens = upload_blocks(blocks, device)
    return nfa_scan_corpus_speculative(engine, corpus, corpus_t, starts,
                                       lens, block_anchored, capacity)
