"""Per-kernel benches of the port's general-engine kernels: the
counterpart of the JAX package's `tools_bench_kernels.py`, on the
reference's databases and Grey settings (tools_bench_kernels.py:19-22,
:88-91, :152-155, :214):

- "bounded_dfa": kernel C (`csrc/dfa_scan.cu`) on a bounded DFA, chunks
  with a halo (`ops.dfa_kernel.chunk_shape`);
- "unbounded_dfa": kernel C speculative (H = 0, SPEC_CS chunks), the
  device pass of `dfa_scan_corpus_device_speculative`;
- "cyclic_nfa": kernel C speculative on a cyclic bit-NFA's lazy-DFA
  core, the device pass of `nfa_scan_corpus_device_speculative`;
- "acyclic_nfa": kernel D (`csrc/nfa_layered.cu`), the layered bit-NFA.

Each bench scans one block of 32 and of 64 MiB. The corpora are the
reference's formula (printable bytes from a multiplicative hash of the
position and a salt; the bit-NFA's from a 17-letter alphabet that makes
accepts), made on the host and uploaded outside the timed region. Before
it is timed, each bench holds its kernel's outputs on that very block
against the plain PyTorch version (about 0.2 s for 16 MiB on an H100); a
difference raises, so the tool exits non-zero. The kernel is then timed
alone with CUDA events, its calls queued behind a spin of the card
(`cuda_ms`), and printed beside its bound: the largest of the bytes it
moves at the card's memory rate, its table lookups at the shared-memory
rate and its integer operations at the integer rate (`dfa_bound`,
`nfa_bound`).

`engine_kernel_times` is phase 4b of `chip_smoke.py`: kernels C and D at
the engine path's shapes, beside their bounds and plain versions.

Usage, on a machine with a CUDA card:

    python3 tools_torch_bench_kernels.py [--mb 32 64] [--reps 10]
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

from .benchdata import NFA_ENGINES, plant_many_class

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
BENCH_MB = (32, 64)  # the reference's sizes
NFA_ALPHABET = np.frombuffer(b"aabxyzjkqrstuvwce", np.uint8)
RECORD_CAP = 1 << 22  # record slots of a check


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


def engine_kernel_times(torch, edbs, corpus, clock_hz) -> dict:
    """Phase 4b of chip_smoke.py: kernels C and D at the engine path's
    shapes (`corpus` as one block and as blocks of ENGINE_BLOCK bytes;
    CUDA events), each against its plain version there first, beside
    their bounds and their plain versions' times, and the seconds of the
    speculative host chains. `edbs` maps each route of ENGINE_SETS to
    (its database, any)."""
    from ..ops import dfa_kernel as DK
    from ..ops import nfa_kernel as NK

    out = {}
    for route, (db, _host) in edbs.items():
        eng = db.engines[0]
        for shape in ("one_block", "blocks_16k"):
            lens = [len(b) for b in engine_blocks(corpus, shape)]
            r = {}
            if route == "acyclic_nfa":
                corpus_t = torch.from_numpy(corpus).to("cuda")
                plan = NK.device_plan(eng, "cuda")
                starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
                bs, be, ba, _ne = NK.block_bounds(
                    starts, lens, np.ones(len(lens), bool), "cuda")
                (_rk, tot, _e), err = compare_nfa(torch, NK, corpus_t, plan,
                                                  bs, be, ba)
                cap = max(1, int(tot))
                r["ms"] = cuda_ms(torch, lambda: NK.nfa_layered(
                    corpus_t, plan, bs, be, ba, cap), 10)
                r["plain_ms"] = cuda_ms(torch, lambda: NK.nfa_layered_plain(
                    corpus_t, plan, bs, be, ba, cap), 1)
                b = nfa_bound(plan, corpus_t.numel(), len(lens), int(tot),
                              clock_hz)
                r.update(records=int(tot), err=err, word_ops=b["word_ops"],
                         kernel="nfa_layered")
                # the other engines at the same shape, each exact first
                pc = plant_many_class(corpus, 1000, 65_537)
                pc_t = torch.from_numpy(pc).to("cuda")
                r["engines"] = {}
                for name in NFA_ENGINES:
                    ep = NK.device_plan(nfa_engine(name), "cuda")
                    (_rk, t2, _e), e2 = compare_nfa(torch, NK, pc_t, ep, bs,
                                                    be, ba)
                    r["err"] = max(r["err"], e2)
                    c2 = max(1, int(t2))
                    r["engines"][name] = dict(
                        P=ep.P, K=ep.K, E=ep.E, records=int(t2),
                        ms=cuda_ms(torch, lambda: NK.nfa_layered(
                            pc_t, ep, bs, be, ba, c2), 10),
                        plain_ms=cuda_ms(torch, lambda: NK.nfa_layered_plain(
                            pc_t, ep, bs, be, ba, c2), 1),
                        **nfa_bound(ep, pc_t.numel(), len(lens), int(t2),
                                    clock_hz))
                del pc, pc_t
            else:
                spec = route != "bounded_dfa"
                d = eng.spec_dfa if route == "cyclic_nfa" else eng
                H, CS = (0, DK.SPEC_CS) if spec else DK.chunk_shape(d)
                corpus_t, tabs, meta, plan, starts, lens_a = chunk_inputs(
                    torch, d, corpus, lens, H, CS,
                    np.full(len(lens), d.start_state))
                (_rk, tot, fin), err = compare_dfa(torch, DK, corpus_t, tabs,
                                                   meta, H)
                cap = max(1, int(tot))
                r["ms"] = cuda_ms(torch, lambda: DK.dfa_scan_chunks(
                    corpus_t, tabs, meta, H, cap), 10)
                # the other placement, forced: the tables read from
                # global memory through the read-only path
                r["ms_global_tables"] = cuda_ms(
                    torch, lambda: DK.dfa_scan_chunks(
                        corpus_t, tabs, meta, H, cap, placement="global"),
                    10)
                r["plain_ms"] = cuda_ms(
                    torch, lambda: DK.dfa_scan_chunks_plain(
                        corpus_t, tabs, meta, H, cap), 1)
                b = dfa_bound(plan.meta, corpus_t.numel(), int(tot),
                              tabs.nbytes, clock_hz)
                r.update(records=int(tot), err=err, chunks=meta.shape[0],
                         lookups=b["lookups"], kernel="dfa_scan",
                         placement=DK.placement_of(tabs, None, "chunks"))
                if spec:
                    fin_np = fin.cpu().numpy()
                    t0 = time.perf_counter()
                    if route == "cyclic_nfa":
                        resc, _h, _f = DK.nfa_spec_chain(
                            eng, corpus, starts, lens_a,
                            np.ones(len(lens), bool), plan, fin_np)
                    else:
                        resc, _x, _f = DK.dfa_spec_chain(
                            eng, corpus, starts, lens_a, plan, fin_np)
                    r["host_chain_s"] = time.perf_counter() - t0
                    r["rescanned_chunks"] = len(resc)
            r["bound_ms"], r["bound_by"] = b["bound_ms"], b["bound_by"]
            out[(route, shape)] = r
    return out


# --- the four benches (tools_bench_kernels.py) -------------------------------


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
    `compare()` (against the plain version) and a text of its shape."""
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
            "compare": lambda: compare_dfa(torch, DK, corpus_t, tabs, meta,
                                           H),
            "shape": (f"S={d.trans.shape[0]} C={d.trans.shape[1]} H={H} "
                      f"CS={CS}, {meta.shape[0]} chunks, tables "
                      f"{DK.placement_of(tabs, None, 'chunks')}")}


def bench_route(route: str, sizes_mb=BENCH_MB, reps: int = 10,
                device="cuda", clock_hz=None) -> dict:
    """One bench over one block of each of `sizes_mb` MiB (salt 1,
    uploaded before the timing): the kernel first held against its plain
    version on that block (a difference raises), then timed alone at the
    record count the check found. Returns {"kernel", "err", "launches"
    (of the timed calls and their warm-up; the checks' are not counted),
    "sizes": {mb: {ms, gb_s, records, bound_ms, bound_by, ...}}}."""
    import torch

    from ..ops._build import LAUNCHES
    from ..runtime.scan import resolve_device

    device = resolve_device(device)
    clock_hz = clock_hz or H100_SM_CLOCK_HZ
    db = engine_db(route)
    out = {"kernel": ENGINE_SETS[route][3], "err": 0, "sizes": {},
           "launches": 0}
    for mb in sizes_mb:
        n = mb << 20
        inp = bench_inputs(torch, route, db, bench_corpus(route, n, 1),
                           device)
        (_r, tot, _x), err = inp["compare"]()
        out["err"] = max(out["err"], err)
        cap = max(1, int(tot))
        before = LAUNCHES[inp["kernel"]]
        ms = time_ms(torch, lambda: inp["run"](cap), reps, device)
        out["launches"] += LAUNCHES[inp["kernel"]] - before
        if inp["kernel"] == "nfa_layered":
            b = nfa_bound(inp["plan"], n, 1, int(tot), clock_hz)
        else:
            b = dfa_bound(inp["plan"].meta, n, int(tot),
                          inp["tables"].nbytes, clock_hz)
        out["sizes"][mb] = {"ms": ms, "gb_s": n / ms / 1e6,
                            "records": int(tot), "shape": inp["shape"],
                            **b}
        del inp
    return out


def run_benches(routes=tuple(ENGINE_SETS), sizes_mb=BENCH_MB,
                reps: int = 10, device="cuda", clock_hz=None) -> dict:
    """bench_route for each route: route -> its result."""
    return {r: bench_route(r, sizes_mb, reps, device, clock_hz)
            for r in routes}


def report(results: dict, card: str) -> list:
    """One line per bench and size: ms, GB/s, records, bound."""
    lines = []
    for route, r in results.items():
        for mb, s in r["sizes"].items():
            lines.append(
                f"{route} ({r['kernel']}, {s['shape']}): {mb} MiB in "
                f"{s['ms']:.4f} ms = {s['gb_s']:.2f} GB/s ({s['records']} "
                f"records); bound {s['bound_ms']:.4f} ms ({s['bound_by']}), "
                f"x{s['ms'] / s['bound_ms']:.2f}; equal to the plain "
                f"version on the same block [{card}]")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Per-kernel benches of the port's engine kernels.")
    ap.add_argument("--mb", type=int, nargs="+", default=list(BENCH_MB))
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--bench", nargs="+", choices=list(ENGINE_SETS),
                    default=list(ENGINE_SETS))
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
