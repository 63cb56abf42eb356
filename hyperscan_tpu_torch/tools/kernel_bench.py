"""Per-kernel benches of the port: every hand-written kernel of the kernel
table (PERF.md, Findings) timed alone on the card, beside its bound and
its plain PyTorch version.

The benches (`--bench`), each over one input of each of its sizes (`--mb`;
by default each bench's own, the shapes the kernel table states):

- the engine kernels, on the JAX package's per-kernel bench sets and Grey
  settings (tools_bench_kernels.py:19-22, :88-91, :152-155, :214), over
  one block of 32 and 64 MiB (the reference's sizes) and of 256 MiB (the
  engine path's corpus): "bounded_dfa", kernel C (`csrc/dfa_scan.cu`) on
  a bounded DFA, chunks with a halo (`ops.dfa_kernel.chunk_shape`);
  "unbounded_dfa", kernel C speculative (H = 0, SPEC_CS chunks), the
  device pass of `dfa_scan_corpus_device_speculative`; "cyclic_nfa",
  kernel C speculative on a cyclic bit-NFA's lazy-DFA core; "acyclic_nfa",
  kernel D (`csrc/nfa_layered.cu`), the layered bit-NFA (rows 9 and 10);
- "dfa_rows": kernel C's row mode (`ops.dfa.dfa_scan_batch`, row 9's
  batch scan) with the bounded DFA over 16,384 rows of 16 KiB, and over
  one shard's 4,096 of them;
- the literal kernels, with the 10k bench ruleset over the main path's
  512 MiB corpora, structured and iid, at the capacities that a scan of
  each corpus with the compact and with the gated family learns:
  "compact", kernel A on the class and on the byte tables (rows 1 and 2);
  "confirm", kernel B as the path calls it, its launch entry alone and
  both at the launch floor (a list of -1s); "plane", kernel A's plane
  mode and the extraction (row 3; the extraction also over a plane 5%
  dense); "kconfirm" (row 4); "gate" (row 5); "rescan", the survivor
  rescan with the gate's row counts and without (row 6); "words", kernel
  7's list mode (row 7) and count mode (row 8), count mode also over four
  shard segments.

Kernel 4's stage modes (row 11) are the stage probe's (tools/kconf_probe.py).

The corpora are made on the host and uploaded outside the timed region:
the engine benches' from the reference's formula (printable bytes from a
multiplicative hash of the position and a salt; the bit-NFA's from a
17-letter alphabet that makes accepts), the literal benches' from the
bench formula (benchdata.gen_corpus). Before it is timed, each kernel is
held against its plain version on the very input it times; a difference
raises, so the tool exits non-zero. The kernel is then timed alone with
CUDA events, its calls queued behind a spin of the card (`cuda_ms`), and
printed beside its plain version's time and its bound: the largest of
the bytes it moves at the card's memory rate, its table lookups at the
shared-memory rate and its integer operations at the integer rate
(`dfa_bound`, `nfa_bound`, `lit_bound`).

Usage, on a machine with a CUDA card:

    python3 tools_torch_bench_kernels.py [--mb N ...] [--reps 10]
        [--bench bounded_dfa ...] [--device cuda]

`--device cpu` runs the same through the plain versions (wall-clock
times; the bounds are an H100's at its 1,980 MHz).
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time

import numpy as np

from .benchdata import gen_corpus, patterns

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
SMEM_LOOKUPS_PER_CLK = 132 * 32  # SMs x shared-memory words per clock
# 32-bit integer add, shift and bitwise AND/OR/XOR: 64 results a clock an
# SM on compute capability 9.0 (the CUDA C++ Programming Guide's
# arithmetic-instruction throughput table), times the SMs; times the SM
# clock gives the card's integer rate
INT_OPS_PER_CLK = 132 * 64
H100_SM_CLOCK_HZ = 1.98e9  # the H100 SXM's largest SM clock
# a spin of the card (~10 ms at 1,980 MHz) that timed calls queue behind
QUEUE_CYCLES = 20_000_000

# the card checks' widths, shared by chip_smoke.py, tools_torch_multicard.py
# and these benches' default sizes
MAIN_BYTES = 512 << 20  # the main path's corpora (the 10k ruleset's)
SHARD_BLOCK = 512 << 10  # the sharded scan_batch: MAIN_BYTES as 1,024 blocks
ENGINE_BYTES = 256 << 20  # the engine path's corpus
ENGINE_BLOCK = 16 * 1024  # the engine path's batch: blocks of 16 KiB
# one database per device route, the JAX package's per-kernel bench sets:
# (patterns, flags, Grey tunables, the route's kernel)
ENGINE_SETS = {
    "bounded_dfa": ([r"ab[cd]{2,6}ef", r"[0-9]{3}-[0-9]{4}",
                     r"GET /[a-z]{1,12} "], [0, 0, 0],
                    {"allow_teddy": False}, "dfa_scan"),
    "unbounded_dfa": ([r"\d+[a-z]{3,}\d+"], [2],  # DOTALL
                      {"allow_teddy": False}, "dfa_scan"),
    "cyclic_nfa": ([r"(ax|by|cz|dw)+[!]"], [0],
                   {"max_dfa_states": 8, "allow_teddy": False}, "dfa_scan"),
    "acyclic_nfa": ([r".*a.{18}b"], [0], {}, "nfa_layered"),
}
# one plant of each route's patterns, laid every PLANT_EVERY bytes (a
# prime stride, so plants fall across every chunk alignment)
ENGINE_PLANTS = [b"abcdef", b"abddddef", b"555-1212", b"GET /index ",
                 b"12abc34", b"9zzzzzzzz8", b"axbycz!", b"dwdw!",
                 b"a" + b"q" * 18 + b"b", b"x12345678y"]
PLANT_EVERY = 4099
BENCH_MB = (32, 64, ENGINE_BYTES >> 20)  # the reference's, the path's
NFA_ALPHABET = np.frombuffer(b"aabxyzjkqrstuvwce", np.uint8)
RECORD_CAP = 1 << 22  # record slots of a check

# the literal benches' inputs
LIT_PATTERNS = 10_000  # the 10k bench ruleset
LIT_MB = (MAIN_BYTES >> 20,)
LIT_KINDS = ("structured", "iid")
DENSE_PLANE = 0.05  # nonzero share of the extraction's dense plane
SHARDS = 4  # kernel 7's shard segments, and the batch scan's shard of four
ROWS_MB = (ENGINE_BYTES >> 20,)  # the batch scan: 16,384 rows of 16 KiB


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError("check failed: " + msg)


def nvidia_smi(query: str) -> str:
    r = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0].strip()


def _sync(torch, device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean milliseconds per call on the card (CUDA events, after one
    warm-up call). The calls are queued behind a spin of the card, so a
    kernel shorter than its host-side launch is timed on the card, not at
    the host's pace."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(QUEUE_CYCLES)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def time_ms(torch, fn, reps: int, device) -> float:
    """`cuda_ms` on a card; elsewhere the wall clock's mean ms a call
    after one warm-up call."""
    if torch.device(device).type == "cuda":
        return cuda_ms(torch, fn, reps)
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3


class Timer:
    """`time_ms` for one bench, adding up the kernel launches of the calls
    it times (the checks' launches are not counted)."""

    def __init__(self, torch, reps: int, device, kernels):
        self.torch, self.reps, self.device = torch, reps, device
        self.launches = dict.fromkeys(kernels, 0)

    def __call__(self, fn, reps=None) -> float:
        from ..ops._build import LAUNCHES

        before = dict(LAUNCHES)
        ms = time_ms(self.torch, fn, reps or self.reps, self.device)
        for k, v in LAUNCHES.items():
            if v > before[k]:
                self.launches[k] = self.launches.get(k, 0) + v - before[k]
        return ms

    def plain(self, fn, reps: int = 1) -> float:
        return time_ms(self.torch, fn, reps, self.device)


# --- bounds ------------------------------------------------------------------


def dfa_bound(meta: np.ndarray, n: int, records: int, table_bytes: int,
              clock_hz) -> dict:
    """Kernel C's bound over the chunk rows `meta` of an n-byte corpus:
    the larger of two times. Lookups: a class map and a transition for
    every live step, at the shared-memory rate. Bytes: the corpus, the
    chunk rows (16 B) and finals (4 B), the records (12 B each), the
    tables and the counters, each moved once, at the memory rate."""
    m = meta.astype(np.int64)
    lookups = 2 * int((m[:, 2] - m[:, 1]).sum())
    t_ops = lookups / (SMEM_LOOKUPS_PER_CLK * clock_hz) * 1e3
    t_bytes = (n + len(m) * 20 + records * 12 + table_bytes + 1024) \
        / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes), "lookups": lookups,
            "t_ops": t_ops, "t_bytes": t_bytes,
            "bound_by": "operations" if t_ops > t_bytes else "bytes"}


def nfa_bound(plan, n: int, n_blocks: int, records: int, clock_hz) -> dict:
    """Kernel D's bound over n bytes: the largest of three times, as the
    three go through different pipes. Integer operations, per 32-byte word
    of the n bytes: a position with k predecessors ORs their words (k - 1)
    and takes the OR a byte on with its carry (one funnel shift), E in
    all, then masks it with its class word and the bytes that continue a
    block (one three-input LOP3), P in all; at 132 x 64 results a clock.
    Lookups: one membership word a byte for each 32 classes, at the
    shared-memory rate. Bytes: the corpus read once and the records and
    block bounds written and read once, at the memory rate."""
    words = -(-n // 32)
    int_ops = words * (plan.E + plan.P)
    lookups = n * -(-plan.K // 32)
    t_int = int_ops / (INT_OPS_PER_CLK * clock_hz) * 1e3
    t_lookups = lookups / (SMEM_LOOKUPS_PER_CLK * clock_hz) * 1e3
    t_ops = max(t_int, t_lookups)
    t_bytes = (n + records * 8 + n_blocks * 21) / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes), "word_ops": int_ops,
            "lookups": lookups, "t_int": t_int, "t_lookups": t_lookups,
            "t_ops": t_ops, "t_bytes": t_bytes,
            "bound_by": "operations" if t_ops > t_bytes else "bytes"}


def lit_bound(clock_hz):
    """The bound of a literal-path kernel (and of the batch scan): the
    larger of its bytes at HBM_BYTES_PER_S and of its shared-memory
    lookups and integer operations, the two pipes side by side."""
    def bound(n_bytes, lookups, int_ops=0):
        t_b = n_bytes / HBM_BYTES_PER_S * 1e3
        t_o = max(lookups / (SMEM_LOOKUPS_PER_CLK * clock_hz),
                  int_ops / (INT_OPS_PER_CLK * clock_hz)) * 1e3
        return {"bound_ms": max(t_b, t_o),
                "bound_by": "operations" if t_o > t_b else "bytes"}
    return bound


# --- databases, inputs and the kernel checks ---------------------------------


def engine_db(route: str, **grey_extra):
    """The route's database (ENGINE_SETS), its Grey tunables plus
    `grey_extra`."""
    from ..database import compile_patterns
    from ..grey import Grey

    pats, flags, grey, _k = ENGINE_SETS[route]
    return compile_patterns(pats, flags, grey=Grey(**grey, **grey_extra))


def nfa_engine(name: str):
    """One of kernel D's wide engines (benchdata.NFA_ENGINES)."""
    from ..database import compile_patterns
    from ..grey import Grey
    from .benchdata import NFA_ENGINES

    pat, grey = NFA_ENGINES[name]
    return compile_patterns([pat], grey=Grey(**grey)).engines[0]


def engine_blocks(corpus: np.ndarray, shape: str, block: int = ENGINE_BLOCK):
    """The engine path's two shapes over one corpus: one block, or blocks
    of `block` bytes."""
    if shape == "one_block":
        return [corpus]
    return [corpus[i:i + block] for i in range(0, len(corpus), block)]


def chunk_inputs(torch, eng, corpus, blocks_lens, H, CS, entry,
                 device="cuda"):
    """Kernel C's inputs for blocks of `blocks_lens` bytes laid head to
    head over `corpus`, on `device`: (corpus tensor, tables, chunk rows,
    the plan, block starts, block lengths)."""
    from ..ops import dfa_kernel as DK

    lens = np.asarray(blocks_lens, np.int64)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    plan = DK.plan_chunks(starts, lens, H, CS, entry, eng.float_state)
    corpus_t = torch.from_numpy(corpus[:int(lens.sum())]).to(device)
    return (corpus_t, DK.device_tables(eng, device),
            torch.from_numpy(plan.meta).to(device), plan, starts, lens)


def compare_dfa(torch, DK, corpus_t, tabs, meta, H,
                placements=("shared", "global")):
    """Kernel C with its tables in each placement vs its plain version on
    the same inputs: the same total (also at a cap below it, where it
    must stay exact), record set and finals. Returns (the first
    placement's kernel outputs, max abs error)."""
    cap = RECORD_CAP
    rp, tp, fp = DK.dfa_scan_chunks_plain(corpus_t, tabs, meta, H, cap)
    k = int(tp)
    check(k <= cap, "kernel C check: records past 2^22")

    def rows(r):
        r = r[:k].long()
        return r[torch.argsort(r[:, 0] * 512 + r[:, 1])]

    want = rows(rp) if k else None
    first, err = None, 0
    for placement in placements:
        rk, tk, fk = DK.dfa_scan_chunks(corpus_t, tabs, meta, H, cap,
                                        placement=placement)
        _r, t_small, _f = DK.dfa_scan_chunks(corpus_t, tabs, meta, H,
                                             max(1, k // 3),
                                             placement=placement)
        _sync(torch, corpus_t.device)
        check(int(tk) == k == int(t_small),
              f"kernel C ({placement}) total {int(tk)} (at a cap below "
              f"it {int(t_small)}) != plain version's {k}")
        e = max(int((fk - fp).abs().max()) if fk.numel() else 0,
                int((rows(rk) - want).abs().max()) if k else 0)
        check(e == 0, f"kernel C ({placement}) != plain version")
        err = max(err, e)
        first = first or (rk, tk, fk)
    return first, err


def compare_nfa(torch, NK, corpus_t, plan, bs, be, ba):
    """Kernel D vs its plain version, also at a cap below the record
    total (which must stay exact). Returns (kernel outputs, err)."""
    cap = RECORD_CAP
    rk, tk, ek = NK.nfa_layered(corpus_t, plan, bs, be, ba, cap)
    rp, tp, ep = NK.nfa_layered_plain(corpus_t, plan, bs, be, ba, cap)
    k = int(tp)
    _r, t_small, _e = NK.nfa_layered(corpus_t, plan, bs, be, ba,
                                     max(1, k // 3))
    _sync(torch, corpus_t.device)
    check(int(tk) == k == int(t_small) and k <= cap,
          f"kernel D total {int(tk)} (at a cap below it {int(t_small)}) != "
          f"plain version's {k}")

    def rows(r):
        r = r[:k].long()
        return r[torch.argsort(r[:, 0])]

    err = max(int((ek - ep).abs().max()) if ek.numel() else 0,
              int((rows(rk) - rows(rp)).abs().max()) if k else 0)
    check(err == 0, "kernel D != plain version")
    return (rk, tk, ek), err


def compare_filter(torch, T, corpus_t, ft, capc, use_classes):
    """Kernel A vs its plain version on the same inputs. Returns (kernel
    outputs, max abs error over counts and valid positions)."""
    pos_k, cnt_k = T.filter_compact(corpus_t, ft, capc,
                                    use_classes=use_classes)
    pos_p, cnt_p = T.filter_compact_plain(corpus_t, ft, capc,
                                          use_classes=use_classes)
    _sync(torch, corpus_t.device)
    valid = (torch.arange(capc, device=corpus_t.device)[None, :]
             < cnt_p.clamp(max=capc)[:, None])
    err = max(int((cnt_k - cnt_p).abs().max()),
              int((pos_k[valid] - pos_p[valid]).abs().max())
              if bool(valid.any()) else 0)
    check(err == 0, f"kernel A (classes={use_classes}) != plain version")
    return (pos_k, cnt_k), err


def compare_confirm(torch, T, corpus_t, pos, ct, cap2):
    """Kernel B vs its plain version: the same exact total and the same
    pair set. Returns (kernel outputs, max abs error)."""
    pairs_k, tot_k = T.hash_confirm(corpus_t, pos, ct, cap2)
    pairs_p, tot_p = T.hash_confirm_plain(corpus_t, pos, ct, cap2)
    _sync(torch, corpus_t.device)
    check(int(tot_k) == int(tot_p), "kernel B total != plain version")
    check(int(tot_p) <= cap2, "cap2 below the hash-matched total")
    k = min(int(tot_p), cap2)
    a = torch.sort((pairs_k[:k, 1].long() << 20) | pairs_k[:k, 0]).values
    b = torch.sort((pairs_p[:k, 1].long() << 20) | pairs_p[:k, 0]).values
    err = int((a - b).abs().max()) if k else 0
    check(err == 0, "kernel B pairs != plain version")
    return (pairs_k, tot_k), err


def cell_err(torch, pos_k, cnt_k, pos_p, cnt_p, cap) -> int:
    """Max abs difference of per-cell counts and of the valid slots."""
    valid = (torch.arange(cap, device=cnt_p.device)[None, :]
             < cnt_p.clamp(max=cap)[:, None])
    err = int((cnt_k - cnt_p).abs().max())
    if bool(valid.any()):
        err = max(err, int((pos_k[valid] - pos_p[valid]).abs().max()))
    return err


def rescan_err(torch, T, G, corpus_t, ft, flags, kc, capc):
    """Kernel 6 at one corpus's gate flags and row counts `kc` against
    its plain version, without the row counts and with them (as the gated
    family calls it). Returns (the kernel's outputs with the counts, the
    plain counts, max abs error)."""
    pp, cp = T.filter_compact_plain(corpus_t, ft, capc, use_classes=True,
                                    row_flags=flags)
    err = 0
    for counts in (None, kc):
        pk, ck = G.rescan_rows(corpus_t, ft, flags, capc, row_counts=counts)
        err = max(err, cell_err(torch, pk, ck, pp, cp, capc))
    return (pk, ck), cp, err


def words_err(cnt_k, pos_k, words_k, cnt_p, pos_p, words_p) -> int:
    """Max abs difference of kernel 7's per-cell counts, positions and
    words from its plain version's (the int32 words compared as values:
    zero exactly when they are bitwise equal)."""
    total = pos_p.numel()
    err = int((cnt_k.long() - cnt_p.long()).abs().max()) if \
        cnt_p.numel() else 0
    err = max(err, abs(int(cnt_k.long().sum()) - total))
    if total:
        err = max(err, int((pos_k[:total] - pos_p).abs().max()),
                  int((words_k[:, :total].long() - words_p.long())
                      .abs().max()))
    return err


def seg_err(TW, seg_k, pos_p, n: int, start: int) -> int:
    """Max abs difference of kernel 7's segment counts from the plain
    version's (its positions binned by segment)."""
    seg_p = TW.segment_counts(pos_p, n, start)
    if seg_k.shape != seg_p.shape:
        return 1 << 30
    return int((seg_k.long() - seg_p.long()).abs().max()) if \
        seg_p.numel() else 0


def words_route_err(torch, TW, corpus_t, masks, start, plain, classes):
    """Kernel 7 on one table route (count mode with and without segment
    counts, list mode from the segment counts) against its plain version
    `plain` = (counts, positions, words): the max abs error."""
    cnt_p, pos_p, words_p = plain
    n = corpus_t.numel()
    cnt_k, seg_k = TW.filter_words_count(corpus_t, masks, start,
                                         segments=True, use_classes=classes)
    cnt_only = TW.filter_words_count(corpus_t, masks, start,
                                     use_classes=classes)
    pos_k, words_k = TW.filter_words_list(corpus_t, masks, seg_k,
                                          max(1, pos_p.numel()), start,
                                          use_classes=classes)
    _sync(torch, corpus_t.device)
    return max(words_err(cnt_k, pos_k, words_k, cnt_p, pos_p, words_p),
               words_err(cnt_only, pos_k, words_k, cnt_p, pos_p, words_p),
               seg_err(TW, seg_k, pos_p, n, start))


# --- the engine benches (tools_bench_kernels.py) -----------------------------


def plant_engines(corpus: np.ndarray) -> np.ndarray:
    """`corpus` with one of ENGINE_PLANTS every PLANT_EVERY bytes from
    offset 64, in place."""
    n = len(corpus)
    for k, off in enumerate(range(64, n - 32, PLANT_EVERY)):
        p = ENGINE_PLANTS[k % len(ENGINE_PLANTS)]
        corpus[off:off + len(p)] = np.frombuffer(p, np.uint8)
    return corpus


def bench_corpus(route: str, n: int, salt: int) -> np.ndarray:
    """The reference bench's corpus of n bytes for `route`, made on the
    host: v = (i + 7919 salt) * 2654435761 (mod 2^32) at position i;
    byte 32 + (v >> 16) % 95, or for the bit-NFA the letter
    (v >> 16) % 17 of NFA_ALPHABET. The formula's bytes hold no match of
    any route (the hash steps by a constant, so a byte fixes the bytes
    after it), so ENGINE_PLANTS are laid over them: the records path
    runs, and the checks compare records."""
    i = np.arange(n, dtype=np.uint32)
    v = (i + np.uint32(salt * 7919)) * np.uint32(2654435761)
    v >>= np.uint32(16)
    if route == "acyclic_nfa":
        return plant_engines(NFA_ALPHABET[v % np.uint32(len(NFA_ALPHABET))])
    return plant_engines((32 + v % np.uint32(95)).astype(np.uint8))


def _dfa_of(route: str, db):
    """(the DFA kernel C runs, H, CS) of a DFA route's database."""
    from ..ops import dfa_kernel as DK

    eng = db.engines[0]
    if route == "cyclic_nfa":
        check(not eng.acyclic and eng.spec_dfa is not None,
              "cyclic NFA without a lazy-DFA core")
        return eng.spec_dfa, 0, DK.SPEC_CS
    if route == "unbounded_dfa":
        check(eng.max_depth is None, "unbounded DFA has a depth")
        return eng, 0, DK.SPEC_CS
    check(eng.max_depth is not None, "bounded DFA has no depth")
    return eng, *DK.chunk_shape(eng)


def bench_inputs(torch, route: str, db, corpus: np.ndarray, device):
    """One block over `corpus` for the route's kernel on `device`: the
    kernel's name, its plan (and tables), `run(cap)` (one launch),
    `plain(cap)` (the plain version), `compare()` (against the plain
    version) and a text of its shape."""
    n = len(corpus)
    if route == "acyclic_nfa":
        from ..ops import nfa_kernel as NK

        plan = NK.device_plan(db.engines[0], device)
        corpus_t = torch.from_numpy(corpus).to(device)
        bs, be, ba, _ne = NK.block_bounds([0], [n], np.ones(1, bool),
                                          device)
        return {"kernel": "nfa_layered", "plan": plan,
                "run": lambda cap: NK.nfa_layered(corpus_t, plan, bs, be,
                                                  ba, cap),
                "plain": lambda cap: NK.nfa_layered_plain(
                    corpus_t, plan, bs, be, ba, cap),
                "compare": lambda: compare_nfa(torch, NK, corpus_t, plan,
                                               bs, be, ba),
                "shape": f"P={plan.P} K={plan.K} E={plan.E}"}
    from ..ops import dfa_kernel as DK

    d, H, CS = _dfa_of(route, db)
    corpus_t, tabs, meta, plan, _s, _l = chunk_inputs(
        torch, d, corpus, [n], H, CS, np.full(1, d.start_state), device)
    return {"kernel": "dfa_scan", "plan": plan, "tables": tabs,
            "run": lambda cap: DK.dfa_scan_chunks(corpus_t, tabs, meta, H,
                                                  cap),
            "plain": lambda cap: DK.dfa_scan_chunks_plain(
                corpus_t, tabs, meta, H, cap),
            "compare": lambda: compare_dfa(torch, DK, corpus_t, tabs, meta,
                                           H),
            "shape": (f"S={d.trans.shape[0]} C={d.trans.shape[1]} H={H} "
                      f"CS={CS}, {meta.shape[0]} chunks, tables "
                      f"{DK.placement_of(tabs, None, 'chunks')}")}


def _result(kernels, tm: Timer) -> dict:
    """An empty bench result: the max abs error of each kernel, the
    timer's launch counts (filled as it times) and the report's rows."""
    return {"err": dict.fromkeys(kernels, 0), "launches": tm.launches,
            "rows": []}


def bench_route(route: str, sizes_mb=BENCH_MB, reps: int = 10,
                device="cuda", clock_hz=None) -> dict:
    """One engine bench over one block of each of `sizes_mb` MiB (salt 1,
    uploaded before the timing): the kernel first held against its plain
    version on that block (a difference raises), then timed alone at the
    record count the check found, and its plain version once. Returns
    {"err": {kernel: max abs error}, "launches": {kernel: launches of the
    timed calls and their warm-up; the checks' are not counted}, "rows":
    [one dict a size: mb, ms, plain_ms, gb_s, records, bound, ...]}."""
    import torch

    from ..runtime.scan import resolve_device

    device = resolve_device(device)
    clock_hz = clock_hz or H100_SM_CLOCK_HZ
    db = engine_db(route)
    kernel = ENGINE_SETS[route][3]
    tm = Timer(torch, reps, device, (kernel,))
    out = _result((kernel,), tm)
    for mb in sizes_mb:
        n = mb << 20
        inp = bench_inputs(torch, route, db, bench_corpus(route, n, 1),
                           device)
        (_r, tot, _x), err = inp["compare"]()
        out["err"][kernel] = max(out["err"][kernel], err)
        cap = max(1, int(tot))
        ms = tm(lambda: inp["run"](cap))
        plain_ms = tm.plain(lambda: inp["plain"](cap))
        if kernel == "nfa_layered":
            b = nfa_bound(inp["plan"], n, 1, int(tot), clock_hz)
        else:
            b = dfa_bound(inp["plan"].meta, n, int(tot),
                          inp["tables"].nbytes, clock_hz)
        out["rows"].append({
            "bench": route, "kernel": kernel, "what": inp["shape"],
            "mb": mb, "ms": ms, "plain_ms": plain_ms, "gb_s": n / ms / 1e6,
            "records": int(tot), **b})
        del inp
    return out


def bench_dfa_rows(sizes_mb=ROWS_MB, reps: int = 10, device="cuda",
                   clock_hz=None) -> dict:
    """Kernel C's row mode (`dfa_scan_batch`, one launch a call) with the
    bounded DFA over rows of ENGINE_BLOCK bytes of the bench corpus (256
    MiB: 16,384 rows), and over one shard's rows of SHARDS: first its
    accept plane and finals held against the lockstep plain version, and
    one launch a call counted; then both timed. The bound: the bytes read
    and the int32 accept plane written, three lookups a byte (b2c,
    trans, accept)."""
    import torch

    from ..ops import dfa as D
    from ..ops import dfa_kernel as DK
    from ..ops._build import LAUNCHES
    from ..runtime.scan import resolve_device

    device = resolve_device(device)
    bound = lit_bound(clock_hz or H100_SM_CLOCK_HZ)
    eng = engine_db("bounded_dfa").engines[0]
    tabs = DK.device_tables(eng, device)
    tm = Timer(torch, reps, device, ("dfa_scan_rows",))
    out = _result(("dfa_scan_rows",), tm)
    for mb in sizes_mb:
        n = mb << 20
        rows = n // ENGINE_BLOCK
        d_t = torch.from_numpy(bench_corpus("bounded_dfa", n, 1).reshape(
            rows, ENGINE_BLOCK)).to(device)
        l_t = torch.full((rows,), ENGINE_BLOCK, dtype=torch.int32,
                         device=device)
        args = (tabs.trans.view(tabs.S, tabs.C), tabs.b2c, tabs.accept,
                int(eng.start_state), d_t, l_t)
        a_k, f_k = D.dfa_scan_batch(*args)
        a_p, f_p = D.dfa_scan_batch_plain(*args)
        err = max(int((a_k - a_p).abs().max()), int((f_k - f_p).abs().max()))
        check(err == 0, f"dfa_scan_batch over {rows} x {ENGINE_BLOCK} rows "
              "!= plain version")
        out["err"]["dfa_scan_rows"] = max(out["err"]["dfa_scan_rows"], err)
        accepts = int((a_p != 0).sum())
        del a_k, f_k, a_p, f_p
        if torch.device(device).type == "cuda":
            before = LAUNCHES["dfa_scan_rows"]
            D.dfa_scan_batch(*args)
            per_call = LAUNCHES["dfa_scan_rows"] - before
            check(per_call == 1, f"dfa_scan_batch made {per_call} row-mode "
                  "launches in one call")
        # one shard of four: where one row's serial chain of dependent
        # lookups, not the bytes, is expected to set the time
        sh = rows // SHARDS
        shard = (*args[:4], d_t[:sh], l_t[:sh])
        n_sh = sh * ENGINE_BLOCK
        shard_b = bound(5 * n_sh + tabs.nbytes + 8 * sh, 3 * n_sh)
        out["rows"].append({
            "bench": "dfa_rows", "kernel": "dfa_scan_rows",
            "what": f"{rows} rows x {ENGINE_BLOCK} B, {accepts} accepts, "
                    f"tables {DK.placement_of(tabs, None, 'rows')}",
            "count": accepts,
            "mb": mb, "ms": tm(lambda: D.dfa_scan_batch(*args)),
            "plain_ms": tm.plain(lambda: D.dfa_scan_batch_plain(*args)),
            **bound(n + 4 * n + tabs.nbytes + 8 * rows, 3 * n),
            "extra": {f"one shard of {SHARDS} ({sh} rows) ms":
                      tm(lambda: D.dfa_scan_batch(*shard)),
                      "its bound ms": shard_b["bound_ms"]}})
        del d_t, l_t, args, shard
    return out


# --- the literal benches -----------------------------------------------------


class LitInput:
    """One literal bench input: the database's tables and a corpus on the
    device, with the capacities that a scan of it learns."""

    def __init__(self, torch, db, mb: int, kind: str, device):
        from ..ops import teddy as T
        from ..ops import teddy_families as F
        from ..ops import teddy_gate as G

        self.lit, self.mb, self.kind = db.lit, mb, kind
        self.corpus_t = T.corpus_tensor(gen_corpus(mb << 20, 1, kind),
                                        device)
        self.n = self.corpus_t.numel()
        self.n_cells = T._n_cells(self.n)
        self.ft, self.ct = T.device_tables(self.lit, device)
        self.uc = self.ft.cmasks is not None
        self.gt = G.device_gate_table(self.lit, device)
        # the capacities the main path learns: a scan with the compact
        # family forced (shared with kconfirm) and one with the gated
        try:
            for fam in ("compact",) + (("gated",) if self.gt is not None
                                       else ()):
                F.force_family(self.lit, fam)
                F.confirm_scan(self.corpus_t, self.lit, self.n)
        finally:
            F.force_family(self.lit, None)
        self.cap1, self.capc, self.cap2 = F._caps_for(self.lit, 1 << 14)
        self.gated_capc = F._caps_for(self.lit, 1 << 14, "gated")[1]


def _row(bench, kernel, what, count, x, ms, plain_ms, b, **more) -> dict:
    """A literal bench's row; `count` is what the kernel counted (its
    candidates, pairs or rows) on the input."""
    return {"bench": bench, "kernel": kernel, "what": what, "count": count,
            "mb": x.mb, "kind": x.kind, "ms": ms, "plain_ms": plain_ms, **b,
            **more}


def bench_compact(torch, x: LitInput, tm: Timer, bound):
    """Kernel A's compact mode at the learned capc, on the class tables
    (row 1) and the byte tables (row 2); torch.nonzero over its candidate
    plane beside it (the compaction alone)."""
    from ..ops import teddy as T

    M, W = x.ft.M, x.ft.W
    errs, rows = {"teddy_filter_compact": 0}, []
    for classes in ([True] if x.uc else []) + [False]:
        (pos_c, cnt), e = compare_filter(torch, T, x.corpus_t, x.ft, x.capc,
                                         classes)
        check(int(cnt.max()) <= x.capc, "learned capc below the hottest "
              "cell")
        errs["teddy_filter_compact"] = max(errs["teddy_filter_compact"], e)
        more = {}
        if classes == x.uc:
            valid = (torch.arange(x.capc, device=cnt.device)[None, :]
                     < cnt[:, None])
            plane = torch.zeros(x.n, dtype=torch.uint8, device=cnt.device)
            plane[pos_c[valid].long()] = 1
            more["library_ms"] = tm.plain(lambda: torch.nonzero(plane), 5)
            del plane
        tab_bytes = M * W * (128 if classes else 256) * 4
        rows.append(_row(
            "compact", "teddy_filter_compact",
            f"{'class' if classes else 'byte'} tables, capc {x.capc}, "
            f"{int(cnt.sum())} candidates", int(cnt.sum()), x,
            tm(lambda: T.filter_compact(x.corpus_t, x.ft, x.capc,
                                        use_classes=classes)),
            tm.plain(lambda: T.filter_compact_plain(
                x.corpus_t, x.ft, x.capc, use_classes=classes), 2),
            bound(x.n + x.n_cells * (x.capc + 1) * 4 + tab_bytes,
                  x.n * M * W), **more))
    return rows, errs


def bench_confirm(torch, x: LitInput, tm: Timer, bound):
    """Kernel B at the main path's inputs (kernel A's list at the learned
    capacities): the wrapper as the path calls it (the counter's memset
    and the kernel), and on a card its launch entry alone (on a counter
    zeroed once, with room for every call's pairs, so each call writes
    all of them) and both over a list of -1s (the launch floor). The
    bound: the larger of the bytes it moves and its integer operations."""
    from ..ops import teddy as T

    pos_c, cnt = T.filter_compact(x.corpus_t, x.ft, x.capc,
                                  use_classes=x.uc)
    total = int(cnt.sum())
    _m, pos = T.compact_combine(pos_c, cnt, x.capc, x.cap1)
    ct, cap2 = x.ct, x.cap2
    (_p, tot), err = compare_confirm(torch, T, x.corpus_t, pos, ct, cap2)
    pairs_n = int(tot)
    k = min(total, x.cap1)
    probes = sum(g[4] for g in ct.groups)
    b_bytes = (x.cap1 * 4 + k * 8 + min(k * probes * 4, ct.slots.numel() * 4)
               + ct.meta.numel() * 4 + pairs_n * 8 + 4)
    # per candidate and group: the masks, two multiplies, the avalanche
    # (two shifts, two xors, a multiply) and, per probe, an add, a mask,
    # a compare (a dozen operations and two a probe)
    b_ops = k * sum(12 + 2 * g[4] for g in ct.groups)
    reps = 50  # ~0.01 ms a call: more calls a timing than the others
    extra = {}
    if x.corpus_t.is_cuda:
        lib = T._confirm_lib()
        stream = torch.cuda.current_stream(x.corpus_t.device).cuda_stream
        cap_t = (reps + 1) * max(pairs_n, 1)  # cuda_ms makes reps + 1 calls
        pairs = torch.empty((cap_t, 2), dtype=torch.int32,
                            device=x.corpus_t.device)
        counter = torch.zeros(1, dtype=torch.int32, device=x.corpus_t.device)
        none = torch.full_like(pos, -1)

        def launch(p):
            args = T.confirm_args(x.corpus_t, p, ct)
            rc = lib.hs_teddy_hash_confirm_launch(
                *args, pairs.data_ptr(), cap_t, counter.data_ptr(), stream)
            check(rc == 0, "teddy_hash_confirm_launch failed")

        extra["kernel alone ms"] = tm(lambda: launch(pos), reps)
        torch.cuda.synchronize()
        check(int(counter) == (reps + 1) * pairs_n,
              "kernel B timing calls lost pairs")
        extra["floor ms"] = tm(lambda: T.hash_confirm(x.corpus_t, none, ct,
                                                      cap2), reps)
        extra["floor, kernel alone ms"] = tm(lambda: launch(none), reps)
    row = _row("confirm", "teddy_hash_confirm",
               f"{k} candidates, {pairs_n} pairs, cap2 {cap2}", pairs_n, x,
               tm(lambda: T.hash_confirm(x.corpus_t, pos, ct, cap2), reps),
               tm.plain(lambda: T.hash_confirm_plain(x.corpus_t, pos, ct,
                                                     cap2), 5),
               bound(b_bytes, 0, b_ops), extra=extra)
    return [row], {"teddy_hash_confirm": err}


def bench_plane(torch, x: LitInput, tm: Timer, bound):
    """Kernel A's plane mode and the extraction of its plane (row 3),
    torch.nonzero beside the extraction; with the iid corpus also the
    extraction of a plane with DENSE_PLANE of its bytes nonzero, made on
    the device from a seed (where the dense family is chosen, candidates
    are dense). The extraction at cap1 the plane's total."""
    from ..ops import extract as X
    from ..ops import teddy as T

    M, W = x.ft.M, x.ft.W
    plane = T.filter_plane(x.corpus_t, x.ft, use_classes=x.uc)
    plane_p = T.filter_plane_plain(x.corpus_t, x.ft, use_classes=x.uc)
    errs = {"teddy_filter_plane": int((plane != plane_p).sum()),
            "plane_extract": 0}
    check(errs["teddy_filter_plane"] == 0,
          "kernel 3 plane mode != plain version")
    del plane_p
    rows = [_row("plane", "teddy_filter_plane",
                 f"{int(plane.sum())} candidates", int(plane.sum()), x,
                 tm(lambda: T.filter_plane(x.corpus_t, x.ft,
                                           use_classes=x.uc)),
                 tm.plain(lambda: T.filter_plane_plain(
                     x.corpus_t, x.ft, use_classes=x.uc)),
                 bound(x.n + plane.numel(), x.n * M * W))]
    planes = [("the filter's plane", plane)]
    if x.kind == "iid":
        g = torch.Generator(device=plane.device).manual_seed(9)
        planes.append((f"a plane {DENSE_PLANE:.0%} dense", (torch.rand(
            plane.numel(), generator=g, device=plane.device)
            < DENSE_PLANE).to(torch.uint8)))
    for what, p in planes:
        total = int(p.sum())
        cap1 = T._p2(max(total, 1))
        mk, qk = X.plane_extract(p, x.n, cap1)
        mp, qp = X.plane_extract_plain(p, x.n, cap1)
        e = max(int((mk - mp).abs().max()), int((qk - qp).abs().max()))
        check(e == 0, f"kernel 3 extraction of {what} != plain version")
        errs["plane_extract"] = max(errs["plane_extract"], e)
        rows.append(_row(
            "plane", "plane_extract", f"{what}, {total} nonzero", total, x,
            tm(lambda: X.plane_extract(p, x.n, cap1)),
            tm.plain(lambda: X.plane_extract_plain(p, x.n, cap1)),
            bound(p.numel() + cap1 * 4 + 16, 0),
            library_ms=tm.plain(lambda: torch.nonzero(p), 5)))
    return rows, errs


def bench_kconfirm(torch, x: LitInput, tm: Timer, bound):
    """Kernel 4 (row 4): its four counters and each cell's matches held
    against the plain version. The bound: per candidate and group one
    256-byte row read, ~20 hash operations and 128 signature compares."""
    from ..ops import teddy_kconfirm as K

    M, W = x.ft.M, x.ft.W
    kt = K.confirm_planes(x.lit, x.corpus_t.device)
    check(kt is not None, "the database has no kconfirm tables")

    def run():
        return K.filter_kconfirm(x.corpus_t, x.ft, kt, use_classes=x.uc)

    ok_ = run()
    op_ = K.filter_kconfirm_plain(x.corpus_t, x.ft, kt, use_classes=x.uc)
    err = max(int((ok_[0] - op_[0]).abs().max()),
              cell_err(torch, ok_[2], ok_[1], op_[2], op_[1], K.CAPC2),
              cell_err(torch, ok_[3], ok_[1], op_[3], op_[1], K.CAPC2))
    check(err == 0, "kernel 4 != plain version")
    n_cand, groups = int(op_[0].sum()), len(kt.groups)
    matches = int(op_[1].sum())
    del ok_, op_
    row = _row("kconfirm", "teddy_kconfirm",
               f"{n_cand} candidates, {matches} matches, {groups} groups",
               n_cand, x,
               tm(run), tm.plain(lambda: K.filter_kconfirm_plain(
                   x.corpus_t, x.ft, kt, use_classes=x.uc)),
               bound(x.n + n_cand * groups * 256
                     + x.n_cells * (2 + 2 * K.CAPC2) * 4,
                     x.n * M * W, n_cand * groups * (20 + 128)))
    return [row], {"teddy_kconfirm": err}


def bench_gate(torch, x: LitInput, tm: Timer, bound):
    """The gate (row 5): its row flags and per-cell row counts held
    against the plain version."""
    from ..ops import teddy as T
    from ..ops import teddy_gate as G

    check(x.gt is not None, "the database has no gate tables")
    fk, kk = G.gate_rows(x.corpus_t, x.gt)
    fp, kp = G.gate_rows_plain(x.corpus_t, x.gt)
    err = max(int((fk.int() - fp.int()).abs().max()),
              int((kk - kp).abs().max()))
    check(err == 0, "kernel 5 != plain version")
    row = _row("gate", "teddy_gate", f"{int(kk.sum())} rows flagged",
               int(kk.sum()), x,
               tm(lambda: G.gate_rows(x.corpus_t, x.gt)),
               tm.plain(lambda: G.gate_rows_plain(x.corpus_t, x.gt)),
               bound(x.n + x.n_cells * (T.CELL // T.ROW + 4), x.n * x.ft.M))
    return [row], {"teddy_gate": err}


def bench_rescan(torch, x: LitInput, tm: Timer, bound):
    """The survivor rescan (row 6) at the gate's flags and row counts and
    the learned gated capc, held against its plain version with the row
    counts and without, timed both ways. The bound's bytes are what the
    call with the counts must move: the counts, the flags of the cells
    with a flagged row, those rows, and each cell's count and positions
    below capc; its operations the M x W table words of each byte of a
    flagged row."""
    from ..ops import teddy as T
    from ..ops import teddy_gate as G

    check(x.gt is not None, "the database has no gate tables")
    ft, capc = x.ft, x.gated_capc
    flags, kc = G.gate_rows(x.corpus_t, x.gt)
    _k, cp, err = rescan_err(torch, T, G, x.corpus_t, ft, flags, kc, capc)
    check(err == 0, "kernel 6 != plain version")
    check(int(cp.max()) <= capc, "learned gated capc below the hottest cell")
    k_rows = int(kc.sum())
    moved = (2 * x.n_cells * 4 + int((kc > 0).sum()) * (T.CELL // T.ROW)
             + k_rows * T.ROW + int(cp.clamp(max=capc).sum()) * 4)
    row = _row("rescan", "teddy_rescan_rows",
               f"{k_rows} rows, {int(cp.sum())} candidates, capc {capc}",
               int(cp.sum()), x,
               tm(lambda: G.rescan_rows(x.corpus_t, ft, flags, capc,
                                        row_counts=kc)),
               tm.plain(lambda: T.filter_compact_plain(
                   x.corpus_t, ft, capc, use_classes=True, row_flags=flags)),
               bound(moved, k_rows * T.ROW * ft.M * ft.W),
               extra={"without the row counts ms": tm(lambda: G.rescan_rows(
                   x.corpus_t, ft, flags, capc))})
    return [row], {"teddy_rescan_rows": err}


def bench_words(torch, x: LitInput, tm: Timer, bound):
    """Kernel 7 (teddy_scan's filter): count mode (row 8, once a shard) and
    list mode (row 7), held against the plain version on both table
    routes (per-cell and per-segment counts, positions, words), and count
    mode over each of SHARDS segments with its look-back bytes against
    the plain version over the same segment and the whole corpus's plain
    positions inside it. The bounds count the M x W table words a
    position needs (the byte tables give the same words; the class
    route's remap is in "lookups read"); list mode's own work is the
    segment counts read, the visited segments' ranks, bytes and words and
    its outputs."""
    from ..ops import teddy as T
    from ..ops import teddy_words as TW
    from ..parallel.sharded import LOOKBACK, segments

    masks = T.mask_tables(x.lit.masks, x.corpus_t.device)
    M, W, n, corpus_t = masks.M, masks.W, x.n, x.corpus_t
    tab_bytes = M * W * 128 * 4 + 256
    plain = TW.filter_words_plain(corpus_t, masks)
    pos_p = plain[1]
    total = pos_p.numel()
    routes = (True, False) if masks.cmasks is not None else (False,)
    err = max(words_route_err(torch, TW, corpus_t, masks, 0, plain, classes)
              for classes in routes)
    parts = []
    for lo, hi in segments(n, SHARDS):
        back = min(lo, LOOKBACK)
        part = corpus_t[lo - back:hi].clone()
        parts.append((part, back))
        seg_p = TW.filter_words_plain(part, masks, back)[0]
        inside = int(((pos_p >= lo) & (pos_p < hi)).sum())
        for classes in routes:
            seg_k = TW.filter_words_count(part, masks, back,
                                          use_classes=classes)
            err = max(err, int((seg_k.long() - seg_p.long()).abs().max()),
                      abs(int(seg_k.long().sum()) - inside))
    check(err == 0, f"kernel 7 at {n} bytes (count, segment counts, list, "
          f"class and byte tables, {SHARDS} shard segments) != plain version")
    del plain, pos_p
    plain_ms = tm.plain(lambda: TW.filter_words_plain(corpus_t, masks))
    _c, segs = TW.filter_words_count(corpus_t, masks, segments=True)
    visited = int((segs != 0).sum())

    def count_list():
        _c, sg = TW.filter_words_count(corpus_t, masks, segments=True)
        return TW.filter_words_list(corpus_t, masks, sg, max(1, total))

    lib = {}
    if total:  # the compaction's yardstick: torch.nonzero over the plane
        pos_k = TW.filter_words_list(corpus_t, masks, segs, total)[0]
        cand = torch.zeros(n, dtype=torch.uint8, device=corpus_t.device)
        cand[pos_k.long()] = 1
        lib["library_ms"] = tm.plain(lambda: torch.nonzero(cand), 5)
        del cand, pos_k
    rows = [
        _row("words", "teddy_words_count",
             f"count mode, {total} candidates", total, x,
             tm(lambda: TW.filter_words_count(corpus_t, masks)), plain_ms,
             bound(n + x.n_cells * 4 + tab_bytes, n * M * W), extra={
                 "with segment counts ms": tm(lambda: TW.filter_words_count(
                     corpus_t, masks, segments=True)),
                 "byte tables ms": tm(lambda: TW.filter_words_count(
                     corpus_t, masks, use_classes=False)),
                 f"{SHARDS} shard segments ms": tm(lambda: [
                     TW.filter_words_count(p, masks, s) for p, s in parts]),
                 "lookups read": n * (M * W + 1)}),
        _row("words", "teddy_words_list",
             f"list mode, {visited} of {TW.n_segments(n)} segments "
             "visited", total, x,
             tm(lambda: TW.filter_words_list(corpus_t, masks, segs,
                                             max(1, total))), plain_ms,
             bound(TW.n_segments(n) * 4 + visited * (8 + TW.SEG) + tab_bytes
                   + total * (1 + W) * 4, visited * TW.SEG * M * W),
             extra={"count + list ms": tm(count_list),
                    "its bound ms": bound(n + tab_bytes + total * (1 + W) * 4,
                                          n * M * W)["bound_ms"],
                    "lookups read": visited * TW.SEG * (M * W + 1)}, **lib)]
    return rows, {"teddy_words_count": err, "teddy_words_list": err}


# the literal benches: name -> (the bench, its kernels)
LIT_BENCHES = {
    "compact": (bench_compact, ("teddy_filter_compact",)),
    "confirm": (bench_confirm, ("teddy_hash_confirm",)),
    "plane": (bench_plane, ("teddy_filter_plane", "plane_extract")),
    "kconfirm": (bench_kconfirm, ("teddy_kconfirm",)),
    "gate": (bench_gate, ("teddy_gate",)),
    "rescan": (bench_rescan, ("teddy_rescan_rows",)),
    "words": (bench_words, ("teddy_words_count", "teddy_words_list")),
}
BENCHES = (*ENGINE_SETS, "dfa_rows", *LIT_BENCHES)


def run_benches(benches=BENCHES, sizes_mb=None, reps: int = 10,
                device="cuda", clock_hz=None, db=None) -> dict:
    """Each of `benches` over its sizes (`sizes_mb`, or the bench's own:
    BENCH_MB, ROWS_MB, LIT_MB), the literal ones with the literal
    database `db` (by default the 10k bench ruleset, compiled here, which
    must compress to class tables: the main path's route) over both
    corpus kinds: bench -> its result, as bench_route's (a literal
    bench's rows and errors over all its inputs)."""
    import torch

    from ..runtime.scan import resolve_device

    device = resolve_device(device)
    out = {}
    for b in benches:
        if b in ENGINE_SETS:
            out[b] = bench_route(b, sizes_mb or BENCH_MB, reps, device,
                                 clock_hz)
        elif b == "dfa_rows":
            out[b] = bench_dfa_rows(sizes_mb or ROWS_MB, reps, device,
                                    clock_hz)
    lit = [b for b in benches if b in LIT_BENCHES]
    if lit:
        if db is None:
            import hyperscan_tpu_torch as ht

            from ..ops.teddy import mask_tables

            pats, ids = patterns(LIT_PATTERNS)
            db = ht.compile_multi(pats, ids=ids)
            # rows 1 and 8 are the main path's class-table route
            check(mask_tables(db.lit.masks, device).cmasks is not None,
                  "the 10k ruleset's masks do not compress to class tables")
        bound = lit_bound(clock_hz or H100_SM_CLOCK_HZ)
        timers = {b: Timer(torch, reps, device, LIT_BENCHES[b][1])
                  for b in lit}
        out.update({b: _result(LIT_BENCHES[b][1], timers[b]) for b in lit})
        for mb in sizes_mb or LIT_MB:
            for kind in LIT_KINDS:
                x = LitInput(torch, db, mb, kind, device)
                for b in lit:
                    rows, errs = LIT_BENCHES[b][0](torch, x, timers[b],
                                                   bound)
                    out[b]["rows"] += rows
                    for k, e in errs.items():
                        out[b]["err"][k] = max(out[b]["err"][k], e)
                del x
    return {b: out[b] for b in benches}


def report(results: dict, card: str) -> list:
    """One line per row of each bench: ms, bound, plain version's ms, and
    what else the row measured."""
    lines = []
    for r in results.values():
        for s in r["rows"]:
            kind = f" {s['kind']}" if "kind" in s else ""
            rate = f" = {s['gb_s']:.2f} GB/s" if "gb_s" in s else ""
            recs = f" ({s['records']} records)" if "records" in s else ""
            more = "".join(f"; {k} {v:.4f}" if isinstance(v, float)
                           else f"; {k} {v}"
                           for k, v in s.get("extra", {}).items())
            if "library_ms" in s:
                more += f"; torch.nonzero {s['library_ms']:.4f} ms"
            lines.append(
                f"{s['bench']} ({s['kernel']}, {s['what']}): {s['mb']} MiB"
                f"{kind} in {s['ms']:.4f} ms{rate}{recs}; bound "
                f"{s['bound_ms']:.4f} ms ({s['bound_by']}), "
                f"x{s['ms'] / s['bound_ms']:.2f}; plain version "
                f"{s['plain_ms']:.3f} ms{more}; equal to the plain version "
                f"on the same input [{card}]")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Per-kernel benches of the port's kernels.")
    ap.add_argument("--mb", type=int, nargs="+", default=None)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--bench", nargs="+", choices=list(BENCHES),
                    default=list(BENCHES))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch

    on_card = torch.device(args.device).type == "cuda"
    if on_card and not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False; pass "
                           "--device cpu for the plain versions")
    card = nvidia_smi("name,power.limit") if on_card else "cpu"
    clock_hz = (float(nvidia_smi("clocks.max.sm").split()[0]) * 1e6
                if on_card else H100_SM_CLOCK_HZ)
    if on_card:
        from ..ops import _build

        _build.build()
    res = run_benches(args.bench, args.mb, args.reps, args.device,
                      clock_hz)
    for line in report(res, card):
        print(line, flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
