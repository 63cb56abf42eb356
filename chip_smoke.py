"""Chip smoke test of the PyTorch/CUDA port (hyperscan_tpu_torch) on one
NVIDIA card: every path of the port at full width, held to exactness.
It times nothing: the per-kernel times are tools_torch_bench_kernels.py's
and tools_torch_probe_kconfirm.py's, the end-to-end ones benchmark/'s.

Usage, from the root of the repository on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero. Every comparison is exact
(every value is an integer).

1. Build every CUDA kernel of the port from the sources in the checkout
   (one nvcc per source, all started together).
2. Kernel checks at 16 MB, each kernel against its plain PyTorch version
   on the card: kernel A (teddy_filter_compact, class and byte tables)
   and kernel B (teddy_hash_confirm) with the 100- and 10k-pattern bench
   rulesets, structured and iid; kernel B's edge cases (every position
   of a 2^20 + 5 byte corpus as the list, on a tensor ending at n and on
   one starting 3 bytes past an 8-byte boundary; the list behind -1s;
   every candidate hitting; cap2 below the total, which stays exact;
   more groups than the kernel stages in shared memory; the empty list
   and a list of -1s). (2b) One database per general-engine route (the
   JAX package's per-kernel bench sets): kernel C (dfa_scan: a bounded
   DFA from its start state and from carried states, H = 0 with carried
   entry states, the lazy-DFA core of a cyclic NFA, a DFA past the row
   mode's shared-table limit; each with shared and with global tables,
   and at a cap below its total) and kernel D (nfa_layered: EOD accepts,
   P > 48, the bench engine, a 45-class engine and P = 502) over a 16 MB
   batch of blocks. (2c) The literal families' kernels on the 10k
   ruleset, structured and iid, and on a flood database (`aaaa` over a
   run of `a`): the gate, the survivor-row rescan (with the gate's row
   counts and without), kconfirm, the plane mode and its extraction.
   (2d) Kernel 7 (teddy_words, count mode with its cell and segment
   counts, list mode from the segment counts) on both table routes, also
   at an unaligned length with a look-back head, its candidates equal to
   kernel A's; dfa_scan_batch (kernel C's row mode) over 1,024 x 16 KiB
   rows, its tables in shared and in global memory. (2e) Kernel 4's
   stage modes 0-2; stage 3's counts equal stage 0's and stage 2's.
3. The literal path at full size, under the port's default family
   choice: `scan_batch` with the 10k ruleset over a 512 MB corpus,
   structured and iid, each twice (the repeat equals the first), and the
   flood database over 256 KiB. The planted matches are found, the
   verified pairs of the first 64 MB equal the port's host path
   (teddy_filter_host + confirm_candidates), the structured scans run the
   gated family and the iid repeat kconfirm, the flood demotes compact
   -> dense with n - 3 matches, and every literal kernel is launched;
   the 10k ruleset's masks compress to class tables.
   (3c) Each family forced in turn on both 512 MB corpora, each scan
   twice: the 64 MB prefix equals the host path and the match lists of
   all four families are equal; the flood forced compact demotes to
   dense. After each scan of 3 and 3c, the kernels of its family on its
   corpus, dispatched at the learned capacities, each against its plain
   version (kernel A on the class and byte tables, kernel B, the gate,
   the rescan, kconfirm, the plane mode and its extraction), and no cell
   holds more candidates than the learned capc. (3b) The engine path: each route's database through
   `scan_batch` over 256 MiB, as one block and as 16,384 blocks of 16
   KiB, twice; the match lists over a 32 MiB prefix equal the port's
   host path; kernels C and D are launched, and held against their plain
   versions at these shapes (C on each DFA route, D on the bench engine
   and both wide engines). (3d) The multi-device path, on make_mesh()
   (the visible cards) and on a hand-built mesh of four shards on card
   0: teddy_scan over both 512 MB corpora (its total and positions equal
   kernel A's candidates), sharded_teddy_count (equal to it),
   scan_batch(mesh=) over 1,024 blocks of 512 KiB, twice (equal to the
   unsharded scan_batch), sharded_scan_counts and sharded_scan_matches
   with the bounded DFA over 16,384 x 16 KiB (equal to the unsharded
   dfa_scan_batch + extract_matches); kernel 7, kernel C's row mode and
   the filter kernel of each family the shards ran are launched; kernel
   7 over each corpus (both table routes) and dfa_scan_batch over the
   16,384 rows (one launch a call) equal their plain versions. (3f)
   The multi-process mesh, run between 3d and 3e: this script starts two
   worker processes of itself (`--mesh-worker`), which join one
   `torch.distributed` group through make_multihost_mesh (NCCL, one card
   a process, where two cards are visible; gloo with both on card 0
   where one is) and get the databases serialized and the corpora in
   files; at 3d's width each runs scan_batch(mesh=) (twice) and
   sharded_teddy_count over both corpora, and the sharded DFA scans over
   its own 8,192 of the 16,384 rows. Every process's lists equal 3d's
   single-process scan_batch, its counts the candidate total and the
   one-process DFA count, its gathered DFA buffers a one-process
   sharded_scan_matches on a two-shard mesh, and each launches kernel
   7's count mode, kernel C's row mode and the filter kernel of every
   family it ran. `python3 chip_smoke.py --mesh-only` runs this phase
   alone, with what it compares against made first, and then
   graft_entry.dryrun_multichip over every visible card. (3e) Streaming:
   the 10k ruleset in stream mode through a StreamSet of 16,384 streams x
   8 KiB writes (extents from the JAX package's stream-bench formula,
   rounds pipelined: start all, one confirm_fetch_many, finish in order;
   two passes of 2 + 6 rounds, equal), scan_streams over 1,024 streams x
   8 KiB, the bounded DFA in stream mode over 1,024 streams x 16 KiB x 8
   rounds (kernel C entered in carried states), and scan_streams(mesh=)
   on both meshes. The first 64 streams of each equal the port's host
   path and the block scan of their concatenated writes, the sharded
   writes equal the unsharded, every planted match is found, and the
   filter kernel of each family that ran and dfa_scan are launched; the
   kernels of the family of the last StreamSet round, on that round's
   extent tensor and capacities, equal their plain versions, and kernel C
   on every round of the bounded-DFA streams, entered in the streams'
   carried states (its finals equal the states the streams carried
   out). (3g) SOM: the first 100 bench patterns without shape 5 (84),
   SOM_LEFTMOST, through scan_batch over both 512 MB corpora, twice, and
   the first 96 without shape 5 (80) in stream mode through a StreamSet
   of 4,096 streams x 8 KiB writes (two passes of 6 pipelined rounds,
   equal). The planted region's matches are exactly each plant's own
   SOM matches at its known start, the matches of the first 64 MB equal
   the port's host route on the CPU, the first 64 streams of each round
   equal scan_streams of their writes on the CPU host route, every
   predicted stream plant is found with its start, and the filter kernel
   of every family that ran is launched; the kernels of the family of
   the last SOM block scan and of the last SOM round equal their plain
   versions there. Then the port's bench (tools/bench.py) at reduced
   depth: run_config with the 100-pattern database over 64 MiB x 2 scans
   and run_streamset with the 10k stream database at 1,024 streams x 6
   rounds, each asserting its plants.
5. The differential tools on the card: the port's hscollider over a
   seeded subset of 48 expressions of conformance/signatures.txt (the
   whole battery takes tens of minutes) and three fuzz rounds, each scan
   on the device branch (the tools compile with
   Grey(host_scan_limit=0)): no diffs, and the literal kernels launched.
6. Chimera on the card: ch_scan over a 2 MiB buffer with plants, its
   prefilter literal-routed, equals ch_scan on the CPU, and a filter
   kernel launched.
7. The feature surface at full width (tools/features.py): one small
   database per feature class of the reference's tests (logical
   combinations with QUIET sub-expressions, min_offset / max_offset /
   min_length, SINGLEMATCH, the anchored families, edit and Hamming
   distance, UTF-8, UTF-8|UCP, bit-NFA blow-ups, ALLOWEMPTY through
   scan_block_ranges), each over a 256 MiB corpus made on the host from
   a seed with its plant every ~64 KiB: scan_batch over 16 blocks of 16
   MiB (the ranges database: scan_block_ranges and scan_count over the
   whole corpus) gives in every block exactly the matches its plants
   give under the feature's rules, the first 16 MiB equal the port's
   host route, each kernel the database ran equals its plain version at
   the path's input (the literal family's over the scanned corpus,
   kernels C and D over the last block; these launches not counted),
   the database serialized and loaded back scans the same; the
   combination, anchored and UTF-8 databases also in stream mode through
   a StreamSet of 4,096 streams x 8 KiB x 6 rounds, whose first 64
   streams equal scan_streams on the host route and whose every stream
   reports the purely negative combination at close. Dropping each
   database gives back the card's memory (torch.cuda.memory_allocated
   within 512 bytes of where it stood before it was built); kernels A, B,
   C and D are launched in the phase.
8. The graft entry points and the per-kernel benches
   (hyperscan_tpu_torch/graft_entry.py, tools/kernel_bench.py,
   tools/kconf_bench.py): graft_entry.entry()'s block-scan step on the
   card, its five outputs equal to entry(device="cpu")'s and its
   row-mode scan equal to dfa_scan_batch_plain; dryrun_multichip(4) on
   four shards of card 0 (the sharded DFA count equal to its gathered
   matches, kernel 7's sharded count, scan_batch(mesh=) equal to the
   unsharded scan); the kconfirm bench at 64 MiB iid with the 10k
   ruleset (the kconfirm and compact families forced, their verified
   pairs equal scan by scan); the kernel bench at reduced depth (every
   bench over 16 MiB, each kernel first equal to its plain version on
   its input; its report lines are printed). Kernels C's row mode, 7's
   count mode, kconfirm, A and B are launched in the phase. Then each
   kernel at the inputs the phase gave it, against its plain version
   (these launches not counted): kernel C's row mode on each shard's
   rows of the dry run's DFA step, kernel 7 on each shard's segment of
   its filter count, the literal family's kernels on its product corpus
   (unsharded and each shard's blocks, at their capacities), and kernel
   4, or kernels A and B, on the kconfirm bench's last scan of each
   family.
9. One JSON line listing every kernel with its max abs error over every
   check of the run and its launches in each counted phase (the main
   path, the engine and sharded paths, 3g's SOM path and bench run,
   phase 7 and phase 8), the card's name and power limit as nvidia-smi
   reports them, and the final status line.

Each log line carries the seconds since the start, and each long phase
its wall seconds. Imports nothing of JAX nor of the JAX package.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

MB = 1 << 20
CHECK_BYTES = 16 * MB
CHECK_CAPC = 128  # capc of the 16 MB kernel checks (the learned floor)
PREFIX_BYTES = 64 * MB
DEVICE = "cuda"

_T0 = time.perf_counter()


def log(msg: str) -> None:
    print(f"[chip_smoke +{time.perf_counter() - _T0:7.1f}s] {msg}",
          flush=True)


# --- the bench rulesets and corpora (the generator of bench.py, copied) -----

from hyperscan_tpu_torch.tools.benchdata import (  # noqa: E402
    NFA_ENGINES, PLANT_AT, PLANTS, gen_corpus, patterns, plant_many_class)
from hyperscan_tpu_torch.tools.features import host_limit  # noqa: E402
# the widths and kernel checks shared with the port's per-kernel benches
# (tools_torch_bench_kernels.py)
from hyperscan_tpu_torch.tools.kernel_bench import (  # noqa: E402
    ENGINE_BLOCK, ENGINE_BYTES, ENGINE_SETS, MAIN_BYTES, SHARD_BLOCK,
    cell_err, check, chunk_inputs, compare_confirm, compare_dfa,
    compare_filter, compare_nfa, engine_blocks, engine_db, nfa_engine,
    nvidia_smi, plant_engines, rescan_err, words_route_err)


# --- kernel vs plain comparisons ---------------------------------------------


# kernel B's edge cases: literals whose tails end inside the first 8 bytes
# (zeros before offset 0, tail lengths below 8), a caseless tail mask, and
# a full 8-byte tail
CONFIRM_EDGE_PATS = [r"abc", r"wxyz1", r"0123456789", r"HeLLo", r"\x00\x00q9"]
# the edge corpus: these tokens in a seeded order, a match every few bytes
CONFIRM_EDGE_TOKENS = [b"abc", b"hElLo", b"wxyz1", b"0123456789",
                       b"\x00\x00q9", b"z", b"1", b"a"]
CONFIRM_EDGE_N = (1 << 20) + 5  # not a multiple of 8


def confirm_rows_within(torch, pairs_k, pairs_p, k: int) -> bool:
    """The kernel's first k rows are a sub-multiset of the plain pairs
    (which of the hash matches a full cap2 keeps is arbitrary)."""
    a = ((pairs_k[:k, 1].long() << 20) | pairs_k[:k, 0]).cpu().numpy()
    b = ((pairs_p[:, 1].long() << 20) | pairs_p[:, 0]).cpu().numpy()
    ka, ca = np.unique(a, return_counts=True)
    kb, cb = np.unique(b, return_counts=True)
    at = np.searchsorted(kb, ka).clip(0, max(len(kb) - 1, 0))
    return bool(len(kb) and (kb[at] == ka).all() and (ca <= cb[at]).all()) \
        or k == 0


def confirm_edge_cases(torch, T, ht) -> int:
    """Kernel B against its plain version on its edge cases, exact: every
    position of a corpus of n = 2^20 + 5 bytes as the list (positions 0-7
    and n - 1, with matches planted there), on a tensor that ends at n and
    on a view whose start is 3 bytes past an 8-byte boundary; the same
    list behind -1s (skipped); a list in which every candidate hits
    (every lane of a warp appends); cap2 below the total (the total stays
    exact, the rows a sub-multiset); more groups than the kernel stages in
    shared memory (its records read from global memory); an empty list
    and a list of -1s. Returns the max abs error."""
    from hyperscan_tpu_torch.flags import HS_FLAG_CASELESS

    db = ht.compile_multi(CONFIRM_EDGE_PATS,
                          flags=[0, 0, 0, HS_FLAG_CASELESS, 0],
                          ids=list(range(len(CONFIRM_EDGE_PATS))))
    check(db.lit is not None and not db.engines,
          "kernel B edge database must be literal-routed")
    _ft, ct = T.device_tables(db.lit, DEVICE)
    n = CONFIRM_EDGE_N
    rng = np.random.default_rng(21)
    pick = rng.integers(0, len(CONFIRM_EDGE_TOKENS), n // 2)
    host = np.frombuffer(b"".join(CONFIRM_EDGE_TOKENS[i] for i in pick)[:n],
                         np.uint8).copy()
    for off, lit in ((0, b"abc"), (3, b"HELLO"), (n - 5, b"wxyz1"),
                     (n - 15, b"0123456789")):
        host[off:off + len(lit)] = np.frombuffer(lit, np.uint8)
    padded = torch.from_numpy(np.concatenate(
        [np.zeros(3, np.uint8), host])).to(DEVICE)
    err = 0
    for where, corpus in (("ends at n", torch.from_numpy(host).to(DEVICE)),
                          ("start 3 past 8", padded[3:])):
        every = torch.arange(n, dtype=torch.int32, device=DEVICE)
        pairs_p, tot_p = T.hash_confirm_plain(corpus, every, ct, 1 << 22)
        total = int(tot_p)
        check(total > n // 16, "kernel B edge corpus has too few matches")
        hit_pos = pairs_p[:total, 1]
        check({0 + 2, 3 + 4, n - 1} <= set(hit_pos.tolist()),
              "kernel B edge plants at 2, 7 and n - 1 not matched")
        cap = T._p2(total + 1)
        (_p, tot), e = compare_confirm(torch, T, corpus, every, ct, cap)
        err = max(err, e)
        # the same list behind -1s
        padded_pos = torch.cat([every, torch.full(
            (n // 3,), -1, dtype=torch.int32, device=DEVICE)])
        (_p, t_pad), e = compare_confirm(torch, T, corpus, padded_pos, ct,
                                         cap)
        err = max(err, e)
        check(int(t_pad) == total, "kernel B lost pairs behind -1s")
        # every candidate hits
        hits = torch.unique(hit_pos).int()
        (_p, t_hits), e = compare_confirm(torch, T, corpus, hits, ct, cap)
        err = max(err, e)
        check(int(t_hits) >= hits.numel(), "a hitting candidate lost a pair")
        # cap2 below the total: the total exact, the rows plain pairs
        small = total // 3
        pairs_k, tot_k = T.hash_confirm(corpus, every, ct, small)
        torch.cuda.synchronize()
        check(int(tot_k) == total, "kernel B total past cap2 != plain")
        check(confirm_rows_within(torch, pairs_k, pairs_p[:total], small),
              "kernel B rows past cap2 are not plain pairs")
        # more groups than the kernel stages (1,536): each group R times
        R = 1536 // len(ct.groups) + 1
        many = T.ConfirmTables(groups=ct.groups * R,
                               meta=ct.meta.repeat(R, 1), slots=ct.slots)
        (_p, t_many), e = compare_confirm(torch, T, corpus, every[:4096],
                                          many, 1 << 22)
        err = max(err, e)
        check(int(t_many) > 0, "kernel B many-group case has no match")
        # an empty list, a list of -1s
        before = T.LAUNCHES["teddy_hash_confirm"]
        _pk, t0 = T.hash_confirm(corpus, every[:0], ct, 8)
        check(T.LAUNCHES["teddy_hash_confirm"] == before,
              "kernel B launched on an empty list")
        _pk, t1 = T.hash_confirm(corpus, torch.full_like(every, -1), ct, 8)
        check(int(t0) == int(t1) == 0,
              "kernel B matched on an empty list or on -1s")
        log(f"kernel B edge cases ({where}, n = {n}): {total} matches of "
            f"{n} positions, {hits.numel()} all-hit candidates "
            f"({int(t_hits)} pairs), cap2 {small} < total, "
            f"G = {len(many.groups)} ({int(t_many)} pairs): exact")
    return err


def kernel_checks(torch, T, dbs):
    """Phase 2: both kernels against their plain versions at 16 MB.
    Returns the max abs errors of kernel A and kernel B."""
    err_a = err_b = 0
    for name, db in dbs.items():
        ft, ct = T.device_tables(db.lit, DEVICE)
        for kind in ("structured", "iid"):
            corpus_t = torch.from_numpy(
                gen_corpus(CHECK_BYTES, 2, kind)).to(DEVICE)
            variants = ([True] if ft.cmasks is not None else []) + [False]
            for use_classes in variants:
                (pos_c, cnt), e = compare_filter(
                    torch, T, corpus_t, ft, CHECK_CAPC, use_classes)
                err_a = max(err_a, e)
            total = int(cnt.sum())
            cap1 = T._p2(max(total, 1))
            _meta, pos = T.compact_combine(pos_c, cnt, CHECK_CAPC, cap1)
            # every probe emits at most one pair per candidate
            probes = sum(g[4] for g in ct.groups)
            (_p, tot), e = compare_confirm(torch, T, corpus_t, pos, ct,
                                           T._p2(probes * total + 1))
            err_b = max(err_b, e)
            log(f"kernel check {name} {kind}: filter variants "
                f"{['classes' if v else 'bytes' for v in variants]} "
                f"candidates {total}, max cell {int(cnt.max())}, "
                f"hash-matched pairs {int(tot)}: exact")
    return err_a, err_b


# --- the engine path: the general engines (DFA and bit-NFA) ------------------

ENGINE_HOST_BYTES = 32 * MB
# a larger bounded DFA (S = 3,072, C = 4: S x C = 12,288), past the row
# mode's shared-table limit and inside the chunk scan's, so kernel C's
# default placements differ between its modes
LARGE_DFA = r"a[^\n]{10}b"


def gen_engine_corpus(n: int, salt: int) -> np.ndarray:
    """The iid printable corpus with one engine plant every 4099 bytes
    (a prime stride, so plants fall across every chunk alignment)."""
    return plant_engines(gen_corpus(n, salt, "iid"))


def engine_dbs(ht):
    """route -> (device database, host database): the same patterns,
    the host one with host_scan_limit above ENGINE_HOST_BYTES."""
    from hyperscan_tpu_torch.database import DfaEngine, NfaEngine
    from hyperscan_tpu_torch.ops.nfa_kernel import nfa_device_eligible

    out = {}
    for route in ENGINE_SETS:
        dev = engine_db(route)
        host = engine_db(route, host_scan_limit=2 * ENGINE_HOST_BYTES)
        (eng,) = dev.engines
        want = {"bounded_dfa": DfaEngine, "unbounded_dfa": DfaEngine,
                "cyclic_nfa": NfaEngine, "acyclic_nfa": NfaEngine}[route]
        check(dev.lit is None and isinstance(eng, want),
              f"{route}: unexpected engines {dev.engines}")
        if route == "bounded_dfa":
            check(eng.max_depth is not None, "bounded DFA has no depth")
        if route == "unbounded_dfa":
            check(eng.max_depth is None, "unbounded DFA has a depth")
        if route == "cyclic_nfa":
            check(not eng.acyclic and eng.spec_dfa is not None,
                  "cyclic NFA without a lazy-DFA core")
        if route == "acyclic_nfa":
            check(nfa_device_eligible(eng), "acyclic NFA not eligible")
        shape = (f"S={eng.trans.shape[0]} C={eng.trans.shape[1]} depth "
                 f"{eng.max_depth}" if isinstance(eng, DfaEngine) else
                 f"P={eng.num_positions} depth {eng.max_depth}"
                 + (f", spec_dfa S={eng.spec_dfa.trans.shape[0]}"
                    if eng.spec_dfa is not None else ""))
        log(f"engine route {route}: {shape}")
        out[route] = (dev, host)
    return out


def engine_kernel_checks(torch, edbs):
    """Phase 2b: kernels C and D against their plain versions at 16 MB,
    exact. Kernel C, each case with its tables in shared and in global
    memory and at a cap below its total: a bounded DFA from its start
    state and from carried states, H = 0 with carried entry states, and
    the spec_dfa of a cyclic NFA, and LARGE_DFA; kernel D: EOD accepts,
    P > 48, the bench engine and NFA_ENGINES (45 classes, P = 502), each
    at a cap below its total too."""
    from hyperscan_tpu_torch.database import compile_patterns
    from hyperscan_tpu_torch.grey import Grey
    from hyperscan_tpu_torch.ops import dfa_kernel as DK
    from hyperscan_tpu_torch.ops import nfa_kernel as NK

    corpus = gen_engine_corpus(CHECK_BYTES, 3)
    # several blocks: an empty one, unaligned tails, one of one byte
    lens = [CHECK_BYTES - 200_003, 0, 100_000, 1, 99_999, 3]
    rng = np.random.default_rng(4)
    err_c = err_d = 0
    bdb = edbs["bounded_dfa"][0].engines[0]
    udb = edbs["unbounded_dfa"][0].engines[0]
    spec = edbs["cyclic_nfa"][0].engines[0].spec_dfa
    cases = [
        ("bounded DFA", bdb, *DK.chunk_shape(bdb),
         np.full(len(lens), bdb.start_state)),
        ("bounded DFA, carried states", bdb, *DK.chunk_shape(bdb),
         rng.integers(0, bdb.num_states, size=len(lens))),
        ("unbounded DFA, H=0, carried states", udb, 0, DK.SPEC_CS,
         rng.integers(0, udb.num_states, size=len(lens))),
        ("spec_dfa of the cyclic NFA", spec, 0, DK.SPEC_CS,
         np.full(len(lens), spec.start_state)),
    ]
    big = compile_patterns([LARGE_DFA], grey=Grey(
        allow_teddy=False)).engines[0]
    cases.append((f"{LARGE_DFA} (S x C = {big.trans.size})", big,
                  *DK.chunk_shape(big), np.full(len(lens), big.start_state)))
    for (name, eng, H, CS, entry) in cases:
        corpus_t, tabs, meta, _plan, _s, _l = chunk_inputs(
            torch, eng, corpus, lens, H, CS, entry)
        (_r, tot, _f), e = compare_dfa(torch, DK, corpus_t, tabs, meta, H)
        err_c = max(err_c, e)
        log(f"kernel check C, {name}: H={H}, {meta.shape[0]} chunks, "
            f"step table {tabs.step_bytes('chunks')} B (default "
            f"{DK.placement_of(tabs, None, 'chunks')}), {int(tot)} records, "
            "shared and global tables, also past a cap: exact")
    nfa_cases = [(name, compile_patterns([pat], grey=Grey(
        max_dfa_states=8, allow_teddy=False)).engines[0])
        for name, pat in (("EOD accepts", r".*x.{8}(y|z)$"),
                          ("P > 48", r".*a.{60}b"))]
    nfa_cases += [("the bench engine", edbs["acyclic_nfa"][0].engines[0])]
    nfa_cases += [(f"{name} engine", nfa_engine(name))
                  for name in NFA_ENGINES]
    for name, eng in nfa_cases:
        check(NK.nfa_device_eligible(eng), f"{name} not device eligible")
        c2 = plant_many_class(corpus, 1000, 65_537)
        ends = np.cumsum(lens)
        for e in ends[[0, 2, 4]]:  # EOD accepts at three block ends
            c2[e - 10:e] = np.frombuffer(b"x\xff2345678z", np.uint8)
        corpus_t = torch.from_numpy(c2).to(DEVICE)
        plan = NK.device_plan(eng, DEVICE)
        starts = np.concatenate([[0], ends[:-1]])
        bs, be, ba, _ne = NK.block_bounds(starts, lens,
                                          np.ones(len(lens), bool), DEVICE)
        (_r, tot, eod), e = compare_nfa(torch, NK, corpus_t, plan, bs, be,
                                        ba)
        err_d = max(err_d, e)
        check(name != "EOD accepts" or int((eod != 0).sum()) == 3,
              "EOD bits missing")
        check(name == "EOD accepts" or int(tot) > 10,
              f"kernel D check {name}: too few records")
        log(f"kernel check D, {name}: P={plan.P}, edges {plan.E}, classes "
            f"{plan.K}, {int(tot)} records, {int((eod != 0).sum())} EOD "
            f"blocks: exact")
    return err_c, err_d


def engine_path(ht, edbs, corpus) -> dict:
    """Phase 3b: every engine route through scan_batch on the card, over
    256 MiB as one block and as 16,384 blocks, twice: the repeat equals
    the first scan. Returns each (route, shape)'s match count."""
    out = {}
    for route, (db, _host) in edbs.items():
        for shape in ("one_block", "blocks_16k"):
            blocks = engine_blocks(corpus, shape)
            first = ht.scan_batch(db, blocks, device=DEVICE)
            again = ht.scan_batch(db, blocks, device=DEVICE)
            check(again == first, f"{route} {shape}: repeat differs")
            out[(route, shape)] = sum(map(len, first))
    return out


def engine_path_kernel_checks(torch, edbs, corpus) -> tuple:
    """Phase 3b's kernels at the engine path's shapes: kernel C (each DFA
    route, from its start state; the speculative routes with H = 0) and
    kernel D (the bench engine and NFA_ENGINES, over `corpus` with the
    many-class plant) over `corpus` as one block and as blocks of
    ENGINE_BLOCK bytes, each against its plain version there (exact,
    also past a cap below the total; kernel C with its tables in shared
    and in global memory). Returns the max abs errors of C and D."""
    from hyperscan_tpu_torch.ops import dfa_kernel as DK
    from hyperscan_tpu_torch.ops import nfa_kernel as NK

    err_c = err_d = 0
    corpus_t = torch.from_numpy(corpus).to(DEVICE)
    pc_t = torch.from_numpy(plant_many_class(corpus, 1000, 65_537)).to(
        DEVICE)
    for shape in ("one_block", "blocks_16k"):
        lens = [len(b) for b in engine_blocks(corpus, shape)]
        starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
        for route, (db, _host) in edbs.items():
            eng = db.engines[0]
            if route == "acyclic_nfa":
                bs, be, ba, _ne = NK.block_bounds(
                    starts, lens, np.ones(len(lens), bool), DEVICE)
                cases = [("the bench engine", corpus_t, eng)]
                cases += [(name, pc_t, nfa_engine(name))
                          for name in NFA_ENGINES]
                for name, c_t, e in cases:
                    (_r, tot, _e), err = compare_nfa(
                        torch, NK, c_t, NK.device_plan(e, DEVICE), bs, be,
                        ba)
                    err_d = max(err_d, err)
                    log(f"engine path kernel D, {name}, {shape}: "
                        f"{int(tot)} records: exact")
                continue
            d = eng.spec_dfa if route == "cyclic_nfa" else eng
            H, CS = ((0, DK.SPEC_CS) if route != "bounded_dfa"
                     else DK.chunk_shape(d))
            c_t, tabs, meta, _p, _s, _l = chunk_inputs(
                torch, d, corpus, lens, H, CS,
                np.full(len(lens), d.start_state))
            (_r, tot, _f), err = compare_dfa(torch, DK, c_t, tabs, meta, H)
            err_c = max(err_c, err)
            log(f"engine path kernel C, {route}, {shape}: {meta.shape[0]} "
                f"chunks, {int(tot)} records, shared and global tables: "
                "exact")
            del c_t
    return err_c, err_d


def engine_host_differential(ht, edbs, corpus) -> dict:
    """The device path equals the port's host path on a 32 MiB prefix,
    as one block and as 16 KiB blocks."""
    pre = np.ascontiguousarray(corpus[:ENGINE_HOST_BYTES])
    out = {}
    for route, (db, host) in edbs.items():
        for shape in ("one_block", "blocks_16k"):
            blocks = engine_blocks(pre, shape)
            dev = ht.scan_batch(db, blocks, device=DEVICE)
            ref = ht.scan_batch(host, blocks, device="cpu")
            n = sum(map(len, ref))
            check(dev == ref, f"{route} {shape}: 32 MiB device != host "
                  f"({sum(map(len, dev))} vs {n} matches)")
            check(n > 0, f"{route} {shape}: no matches on 32 MiB")
            out[(route, shape)] = n
    return out


# --- the literal families: kernels 5, 6, 4 and 3 ---------------------------

FLOOD_BYTES = 4 * MB  # the flood database's corpus (every byte a candidate)
FLOOD_MAIN_BYTES = MB // 4  # its scan on the main path (a match a byte)


def flood_db(ht):
    db = ht.compile_multi(["aaaa"], ids=[3])
    check(db.lit is not None and not db.engines, "flood db not literal")
    return db


def family_kernel_checks(torch, T, db, fdb) -> dict:
    """Phase 2c: kernels 5 (gate), 6 (survivor rescan), 4 (kconfirm) and
    3 (plane mode + extraction) against their plain versions, exact: the
    10k ruleset at 16 MB, structured and iid, and the flood database."""
    from hyperscan_tpu_torch.ops import extract as X
    from hyperscan_tpu_torch.ops import teddy_gate as G
    from hyperscan_tpu_torch.ops import teddy_kconfirm as K

    errs = dict.fromkeys(("gate", "rescan", "kconfirm", "plane",
                          "extract"), 0)
    cases = [("10k " + kind, db, gen_corpus(CHECK_BYTES, 2, kind))
             for kind in ("structured", "iid")]
    cases.append(("flood", fdb, np.full(FLOOD_BYTES, ord("a"), np.uint8)))
    for name, d, corpus in cases:
        lit = d.lit
        ft, _ct = T.device_tables(lit, DEVICE)
        classes = ft.cmasks is not None
        corpus_t = torch.from_numpy(corpus).to(DEVICE)
        msg = []
        gt = G.device_gate_table(lit, DEVICE)
        if gt is not None:
            fk, kk = G.gate_rows(corpus_t, gt)
            fp, kp = G.gate_rows_plain(corpus_t, gt)
            e = max(int((fk.int() - fp.int()).abs().max()),
                    int((kk - kp).abs().max()))
            errs["gate"] = max(errs["gate"], e)
            check(e == 0, f"kernel 5 {name} != plain version")
            pp, cp = T.filter_compact_plain(corpus_t, ft, CHECK_CAPC,
                                            use_classes=True, row_flags=fp)
            for counts in (kk, None):  # as the gated family calls it
                pk, ck = G.rescan_rows(corpus_t, ft, fk, CHECK_CAPC,
                                       row_counts=counts)
                e = cell_err(torch, pk, ck, pp, cp, CHECK_CAPC)
                errs["rescan"] = max(errs["rescan"], e)
            check(e == 0, f"kernel 6 {name} != plain version")
            msg.append(f"gate K {int(kk.sum())} rows, rescan candidates "
                       f"{int(ck.sum())}")
        kt = K.confirm_planes(lit, DEVICE)
        check(kt is not None, f"{name}: no kconfirm tables")
        ok_ = K.filter_kconfirm(corpus_t, ft, kt, use_classes=classes)
        op_ = K.filter_kconfirm_plain(corpus_t, ft, kt, use_classes=classes)
        e = max(int((ok_[0] - op_[0]).abs().max()),
                cell_err(torch, ok_[2], ok_[1], op_[2], op_[1], K.CAPC2),
                cell_err(torch, ok_[3], ok_[1], op_[3], op_[1], K.CAPC2))
        counters = [int(op_[0].sum()), int(op_[0].max()), int(op_[1].sum()),
                    int(op_[1].max())]
        errs["kconfirm"] = max(errs["kconfirm"], e)
        check(e == 0, f"kernel 4 {name} != plain version")
        msg.append(f"kconfirm (candidates, max cell, matches, max cell "
                   f"matches) {counters}")
        plane_k = T.filter_plane(corpus_t, ft, use_classes=classes)
        plane_p = T.filter_plane_plain(corpus_t, ft, use_classes=classes)
        e = int((plane_k != plane_p).sum())
        errs["plane"] = max(errs["plane"], e)
        check(e == 0, f"kernel 3 plane mode {name} != plain version")
        total = int(plane_p.sum())
        for cap1 in (T._p2(max(total, 1)), 1000):
            mk, qk = X.plane_extract(plane_k, len(corpus), cap1)
            mp, qp = X.plane_extract_plain(plane_k, len(corpus), cap1)
            e = max(int((mk - mp).abs().max()), int((qk - qp).abs().max()))
            errs["extract"] = max(errs["extract"], e)
            check(e == 0, f"kernel 3 extraction {name} != plain version")
        msg.append(f"plane candidates {total}, hit chunks {int(mk[1])}")
        log(f"kernel check {name}: " + "; ".join(msg) + ": exact")
    return errs


def ran_since(lit, before: dict) -> list:
    """The families a database dispatched since the `before` copy of its
    dispatch counts (`dict(F.family_state(lit).dispatches)`)."""
    from hyperscan_tpu_torch.ops import teddy_families as F

    now = F.family_state(lit).dispatches
    return [f for f in F.FAMILIES if now[f] > before[f]]


def flood_main_path(ht, T, fdb) -> dict:
    """The flood database through scan_batch on the main path: its first
    dispatch is compact, a cell passes CAPC_MAX, and the scan finishes on
    the dense family with every match (n - 3)."""
    from hyperscan_tpu_torch.ops import teddy_families as F

    corpus = np.full(FLOOD_MAIN_BYTES, ord("a"), np.uint8)
    before = dict(F.family_state(fdb.lit).dispatches)
    out = ht.scan_batch(fdb, [corpus], device=DEVICE)[0]
    fams = ran_since(fdb.lit, before)
    check(len(out) == len(corpus) - 3, f"flood: {len(out)} matches")
    check(fams == ["compact", "dense"] and F.family_state(fdb.lit).dense,
          f"flood did not demote compact -> dense ({fams})")
    return {"matches": len(out), "families": fams}


def host_prefix(lit, corpus) -> set:
    """Verified pairs of the port's host filter + confirm over the first
    64 MB."""
    from hyperscan_tpu_torch.runtime.lit_runtime import (
        confirm_candidates, verify_pairs)
    from hyperscan_tpu_torch.runtime.smallwrite import teddy_filter_host

    z = np.zeros(1, np.int64)
    pre = np.ascontiguousarray(corpus[:PREFIX_BYTES])
    pos, words = teddy_filter_host(pre, lit.masks)
    fh, ph = confirm_candidates(lit, pre, z, pos, words)
    fh, ph = verify_pairs(lit, pre, z, fh, ph)
    return set(zip(fh.tolist(), ph.tolist()))


def main_kernel_checks(torch, T, lit, corpus, family: str, what: str):
    """path_kernel_checks on a 512 MiB corpus of the main path, uploaded
    again and dispatched under `family`, the one its last scan ran, at
    the capacities the scans learned (a running max)."""
    from hyperscan_tpu_torch.ops import teddy_families as F

    force = F.family_state(lit).force
    F.force_family(lit, family)
    try:
        h = F.confirm_start(T.corpus_tensor(corpus, DEVICE), lit, MAIN_BYTES)
    finally:
        F.force_family(lit, force)
    check(h.family == family, f"{what}: dispatch family {h.family} != the "
          f"last scan's {family}")
    return path_kernel_checks(torch, T, lit, h, what, learned=True)


def forced_families(torch, ht, T, db, runs, hosts) -> dict:
    """Phase 3c: each family forced in turn on both 512 MiB corpora, each
    scan twice: the repeat equals the first, the 64 MB prefix equals the
    host path, the match lists of the four families are equal, and the
    family's kernels equal their plain versions on the corpus
    (main_kernel_checks); then the flood database, forced compact,
    demotes to dense and finds every match. Returns the kernels' max abs
    errors."""
    from hyperscan_tpu_torch.runtime.lit_runtime import verify_pairs
    from hyperscan_tpu_torch.ops import teddy_families as F

    lit = db.lit
    errs = {}
    for kind, (corpus, ref_out) in runs.items():
        for fam in F.FAMILIES:
            F.force_family(lit, fam)
            before = dict(F.family_state(lit).dispatches)
            first = ht.scan_batch(db, [corpus], device=DEVICE)[0]
            ran = ran_since(lit, before)
            check(ran[-1] == fam, f"{kind}: forced {fam} ran {ran}")
            check(first == ref_out, f"{kind}: forced {fam} match list "
                  f"differs ({len(first)} vs {len(ref_out)})")
            again = ht.scan_batch(db, [corpus], device=DEVICE)[0]
            check(again == first, f"{kind} {fam}: repeat differs")
            dev_n, host_n = prefix_differential(torch, T, db, corpus,
                                                hosts[kind])
            log(f"forced {fam} {kind}: {len(first)} matches == default "
                f"family's; 64 MB prefix device {dev_n} == host {host_n}")
            for k, e in main_kernel_checks(torch, T, lit, corpus, fam,
                                           f"forced {fam} {kind}").items():
                errs[k] = max(errs.get(k, 0), e)
    F.force_family(lit, None)
    flit = ht.compile_multi(["aaaa"], ids=[3]).lit
    F.force_family(flit, "compact")
    corpus = np.full(FLOOD_BYTES, ord("a"), np.uint8)
    f, p = F.confirm_scan(T.corpus_tensor(corpus, DEVICE), flit, len(corpus))
    f, p = verify_pairs(flit, corpus, np.zeros(1, np.int64), f, p)
    fams = ran_since(flit, dict.fromkeys(F.FAMILIES, 0))
    check(len(p) == len(corpus) - 3 and fams == ["compact", "dense"],
          f"forced compact flood: {len(p)} matches, families {fams}")
    log(f"forced compact flood {FLOOD_BYTES} B: demoted to dense, "
        f"{len(p)} = n - 3 verified matches")
    return errs


# --- the multi-device path: kernel 7, the batch DFA scan, the mesh ---------

SHARDS_ONE_CARD = 4  # the hand-built mesh: four shards on card 0
DFA_CHECK_ROWS = 1024  # dfa_scan_batch check: 1,024 rows of 16 KiB


def words_check(torch, T, TW, corpus_t, ft, masks, start=0) -> tuple:
    """Kernel 7, count mode (cell and segment counts) and list mode, on
    the class tables and on the byte tables (each route forced), against
    its plain version on the same inputs (exact), and its candidate
    positions against kernel A's plane mode with byte tables (a
    cross-check of two kernels). Returns (max abs error, candidates)."""
    plain = TW.filter_words_plain(corpus_t, masks, start)
    total = plain[1].numel()
    err = max(words_route_err(torch, TW, corpus_t, masks, start, plain,
                              classes)
              for classes in (True, False))
    check(err == 0, f"kernel 7 (start {start}) != plain version")
    plane = T.filter_plane(corpus_t, ft, use_classes=False)
    cand_a = torch.nonzero(plane[start:corpus_t.numel()]).squeeze(1).int()
    check(torch.equal(cand_a, plain[1]),
          "kernel 7 candidates != kernel A's candidates")
    return err, total


def dfa_batch_inputs(torch, eng, corpus, rows: int, salt: int):
    """A [rows, 16 KiB] batch of `corpus` on the card, with some rows cut
    short, its lengths, and random entry states."""
    data = corpus[:rows * ENGINE_BLOCK].reshape(rows, ENGINE_BLOCK)
    rng = np.random.default_rng(salt)
    lengths = np.full(rows, ENGINE_BLOCK, np.int32)
    short = rng.random(rows) < 0.25
    lengths[short] = rng.integers(0, ENGINE_BLOCK, int(short.sum()))
    init = rng.integers(0, eng.num_states, rows).astype(np.int32)
    return (torch.from_numpy(np.ascontiguousarray(data)).to(DEVICE),
            torch.from_numpy(lengths).to(DEVICE),
            torch.from_numpy(init).to(DEVICE))


def multi_kernel_checks(torch, T, db, edbs) -> dict:
    """Phase 2d: kernel 7 both modes against its plain version and kernel
    A's candidates at 16 MB (10k ruleset byte masks, structured and iid;
    also at an unaligned length with a look-back head), and
    dfa_scan_batch (kernel C's row mode) against its lockstep plain
    version on a bounded-DFA batch of 1,024 x 16 KiB rows (scalar and
    per-row entry states; the row mode with its tables in global memory
    too), and with LARGE_DFA (scalar entry, both placements). Exact."""
    from hyperscan_tpu_torch.database import compile_patterns
    from hyperscan_tpu_torch.grey import Grey
    from hyperscan_tpu_torch.ops import dfa as D
    from hyperscan_tpu_torch.ops import dfa_kernel as DK
    from hyperscan_tpu_torch.ops import teddy_words as TW

    ft, _ct = T.device_tables(db.lit, DEVICE)
    masks = T.mask_tables(db.lit.masks, DEVICE)
    errs = {"words": 0, "dfa_batch": 0}
    for kind in ("structured", "iid"):
        corpus_t = torch.from_numpy(gen_corpus(CHECK_BYTES, 2, kind)).to(
            DEVICE)
        for n, start in ((CHECK_BYTES, 0), (CHECK_BYTES - 3, 5), (100, 0)):
            e, total = words_check(torch, T, TW, corpus_t[:n], ft, masks,
                                   start)
            errs["words"] = max(errs["words"], e)
            log(f"kernel check 7 {kind}: n={n} start={start}: {total} "
                "candidates, count (cells, segments) and list, class and "
                "byte tables == plain == kernel A: exact")
    eng = edbs["bounded_dfa"][0].engines[0]
    big = compile_patterns([LARGE_DFA], grey=Grey(
        allow_teddy=False)).engines[0]
    d_t, l_t, i_t = dfa_batch_inputs(torch, eng, gen_engine_corpus(
        DFA_CHECK_ROWS * ENGINE_BLOCK, 6), DFA_CHECK_ROWS, 7)
    for dfa, init in ((eng, int(eng.start_state)), (eng, i_t),
                      (big, int(big.start_state))):
        tabs = DK.device_tables(dfa, DEVICE)
        args = (tabs.trans.view(tabs.S, tabs.C), tabs.b2c, tabs.accept,
                init, d_t, l_t)
        a_p, f_p = D.dfa_scan_batch_plain(*args)
        for placement in ("shared", "global"):
            a_k, f_k = D.dfa_scan_rows(tabs, init, d_t, l_t,
                                       placement=placement)
            e = max(int((a_k - a_p).abs().max()),
                    int((f_k - f_p).abs().max()))
            errs["dfa_batch"] = max(errs["dfa_batch"], e)
            check(e == 0, f"dfa_scan_batch row mode ({placement} tables) "
                  "!= plain version")
        entry = "scalar" if isinstance(init, int) else "per-row"
        log(f"kernel check dfa_scan_batch (S x C = {tabs.S * tabs.C}, "
            f"default {DK.placement_of(tabs, None, 'rows')}; {entry} entry, "
            f"shared and global tables): {DFA_CHECK_ROWS} x {ENGINE_BLOCK} "
            f"rows, {int((a_p != 0).sum())} accepts: exact")
    return errs


def shard_meshes(torch, P) -> dict:
    """The visible cards (make_mesh()) and four shards on card 0."""
    return {"cards": P.make_mesh(),
            f"{SHARDS_ONE_CARD}_shards_1_card": P.Mesh(
                [torch.device(DEVICE, 0)] * SHARDS_ONE_CARD, ("shards",))}


def sharded_path(torch, ht, T, db, runs, edbs, ecorpus) -> dict:
    """Phase 3d, the slice at full width, every call through its entry
    point: teddy_scan over both 512 MiB corpora; sharded_teddy_count and
    scan_batch(mesh=) over them (1,024 blocks of 512 KiB) on both meshes,
    twice (the repeat equals the first); sharded_scan_counts and
    sharded_scan_matches with the bounded DFA over 16,384 x 16 KiB on
    both meshes. The launch counts are read right after; the checks
    against the unsharded scans and kernel A come after that."""
    from hyperscan_tpu_torch import parallel as P
    from hyperscan_tpu_torch.ops import teddy_families as F
    from hyperscan_tpu_torch.ops import teddy_words as TW

    meshes = shard_meshes(torch, P)
    eng = edbs["bounded_dfa"][0].engines[0]
    eblocks = engine_blocks(ecorpus, "blocks_16k")
    before = dict(F.family_state(db.lit).dispatches)
    T.reset_launches()
    lit_out, dfa_out = {}, {}
    for kind, (corpus, _o) in runs.items():
        total, pos, _words = TW.teddy_scan(corpus, db.lit.masks,
                                           hint_obj=db.lit, device=DEVICE)
        r = {"total": total, "pos": pos, "counts": {}, "lists": {}}
        blocks = [corpus[i:i + SHARD_BLOCK]
                  for i in range(0, len(corpus), SHARD_BLOCK)]
        for name, m in meshes.items():
            r["counts"][name] = P.sharded_teddy_count(corpus, db.lit.masks,
                                                      m)
            first = ht.scan_batch(db, blocks, mesh=m)
            again = ht.scan_batch(db, blocks, mesh=m)
            check(again == first, f"{kind} {name}: repeat differs")
            r["lists"][name] = first
        lit_out[kind] = (r, blocks)
    for name, m in meshes.items():
        data, lengths = P.pad_batch_for_mesh(eblocks, m, ENGINE_BLOCK)
        cnt = P.sharded_scan_counts(eng, data, lengths, m)
        mt = P.sharded_scan_matches(eng, data, lengths, m,
                                    capacity=T._p2(max(cnt, 1)))
        dfa_out[name] = (cnt, [x.cpu() for x in mt])
    launches = dict(T.LAUNCHES)
    return {"lit": lit_out, "dfa": dfa_out, "launches": launches,
            "families": ran_since(db.lit, before), "meshes": meshes,
            "data": (data, lengths)}


def sharded_checks(torch, ht, T, db, edbs, sh) -> dict:
    """Phase 3d's checks: teddy_scan's total equals kernel A's candidate
    count and its positions kernel A's; kernel 7 equals its plain version
    and kernel A over each corpus (words_check); every sharded count
    equals the total; every sharded match list equals the unsharded
    scan_batch; dfa_scan_batch over the padded rows equals its plain
    version, in one row-mode launch; the sharded DFA totals equal the
    count, and the gathered matches equal the unsharded dfa_scan_batch +
    extract_matches. Returns the max abs errors of kernel 7 ("words")
    and of the row mode ("dfa_batch")."""
    from hyperscan_tpu_torch.ops import dfa as D
    from hyperscan_tpu_torch.ops import dfa_kernel as DK
    from hyperscan_tpu_torch.ops import match as MT
    from hyperscan_tpu_torch.ops import teddy_words as TW

    ft, _ct = T.device_tables(db.lit, DEVICE)
    masks = T.mask_tables(db.lit.masks, DEVICE)
    errs = {"words": 0}
    for kind, (r, blocks) in sh["lit"].items():
        corpus_t = T.corpus_tensor(np.concatenate(blocks), DEVICE)
        plane = T.filter_plane(corpus_t, ft, use_classes=True)
        cand = torch.nonzero(plane).squeeze(1).int().cpu().numpy()
        del plane
        errs["words"] = max(errs["words"], words_check(
            torch, T, TW, corpus_t, ft, masks)[0])
        del corpus_t
        check(r["total"] == len(cand) and np.array_equal(r["pos"], cand),
              f"{kind}: teddy_scan total {r['total']} != kernel A's "
              f"{len(cand)} candidates")
        for name, cnt in r["counts"].items():
            check(cnt == r["total"], f"{kind} {name}: sharded_teddy_count "
                  f"{cnt} != teddy_scan {r['total']}")
        single = r["single"] = ht.scan_batch(db, blocks, device=DEVICE)
        for name, lists in r["lists"].items():
            check(lists == single, f"{kind} {name}: sharded scan_batch != "
                  "unsharded")
        again = ht.scan_batch(db, blocks, device=DEVICE)
        check(again == single, f"{kind}: unsharded repeat differs")
        log(f"sharded {kind}: teddy_scan total {r['total']} == kernel A "
            f"candidates == sharded_teddy_count on {list(r['counts'])}; "
            f"scan_batch(mesh=) == unsharded on every mesh "
            f"({sum(map(len, single))} matches over {len(blocks)} blocks)")
    eng = edbs["bounded_dfa"][0].engines[0]
    tabs = DK.device_tables(eng, DEVICE)
    data, lengths = sh["data"]
    d_t = torch.from_numpy(data).to(DEVICE)
    args = (tabs.trans.view(tabs.S, tabs.C), tabs.b2c, tabs.accept,
            int(eng.start_state), d_t, torch.from_numpy(lengths).to(DEVICE))
    before = T.LAUNCHES["dfa_scan_rows"]
    accepts, finals = D.dfa_scan_batch(*args)
    check(T.LAUNCHES["dfa_scan_rows"] - before == 1, "dfa_scan_batch made "
          "more than one row-mode launch in a call")
    a_p, f_p = D.dfa_scan_batch_plain(*args)
    errs["dfa_batch"] = max(int((accepts - a_p).abs().max()),
                            int((finals - f_p).abs().max()))
    check(errs["dfa_batch"] == 0, f"dfa_scan_batch over {data.shape[0]} x "
          f"{data.shape[1]} rows != plain version")
    del a_p, f_p
    want_n = int(MT.count_matches(accepts))
    tot, sid, blk, tos = (x.cpu() for x in MT.extract_matches(
        accepts, T._p2(max(want_n, 1))))
    del accepts
    for name, (cnt, (tot_d, sid_d, blk_d, tos_d, eod_d)) in \
            sh["dfa"].items():
        n_sh = tot_d.shape[0]
        rows = data.shape[0] // n_sh
        check(cnt == want_n == int(tot_d.sum()) == int(tot),
              f"{name}: sharded DFA count {cnt}, totals "
              f"{int(tot_d.sum())}, unsharded {want_n}")
        keep = [slice(0, int(t)) for t in tot_d]
        g_sid = torch.cat([sid_d[d, keep[d]] for d in range(n_sh)])
        g_blk = torch.cat([blk_d[d, keep[d]] + d * rows
                           for d in range(n_sh)])
        g_tos = torch.cat([tos_d[d, keep[d]] for d in range(n_sh)])
        check(torch.equal(g_sid, sid[:want_n])
              and torch.equal(g_blk, blk[:want_n])
              and torch.equal(g_tos, tos[:want_n]),
              f"{name}: sharded DFA matches != unsharded")
        check(torch.equal(eod_d.reshape(-1), torch.from_numpy(
            np.asarray(eng.accept_eod_id))[finals.cpu().long()]),
            f"{name}: EOD sets differ")
        log(f"sharded DFA {name}: {cnt} matches over {data.shape[0]} "
            f"blocks on {n_sh} shards == unsharded dfa_scan_batch + "
            "extract_matches")
    log(f"kernel checks 3d: kernel 7 over both corpora == plain == kernel "
        f"A; dfa_scan_batch over {data.shape[0]} x {data.shape[1]} rows == "
        "plain, one launch: exact")
    return errs


# --- the multi-process mesh (3f): one process per card on torch.distributed --

MESH_PROCESSES = 2
MESH_WAIT_S = 300  # the workers' limit; a worker still running fails 3f
MESH_KINDS = ("structured", "iid")
FAMILY_FILTERS = {"gated": "teddy_rescan_rows",
                  "compact": "teddy_filter_compact",
                  "kconfirm": "teddy_kconfirm", "dense": "teddy_filter_plane"}


def mesh_rows(lists) -> np.ndarray:
    """A batch's match lists as one int64 [n, 4] array of (block, id,
    from, to) rows."""
    rows = [(b, *m) for b, ms in enumerate(lists) for m in ms]
    return np.asarray(rows, dtype=np.int64).reshape(-1, 4)


def mesh_worker(rank: int, port: int, folder: str, cap: int) -> int:
    """One of phase 3f's processes: joins the group
    (make_multihost_mesh, one shard a process), then runs the phase's
    work over the inputs in `folder` as a user would: scan_batch(mesh=)
    over 1,024 x 512 KiB of each 512 MiB corpus (twice: the repeat equals
    the first) and sharded_teddy_count over it, both on the whole corpus;
    sharded_scan_counts and sharded_scan_matches (capacity `cap`) with
    the bounded DFA over this process's half of 16,384 x 16 KiB. Writes
    its lists, the gathered DFA buffers and a JSON of counts, families,
    launch counts, its card and the group's backend into `folder`."""
    import pathlib

    import torch

    import hyperscan_tpu_torch as ht
    from hyperscan_tpu_torch import parallel as P
    from hyperscan_tpu_torch.ops import teddy as T
    from hyperscan_tpu_torch.ops import teddy_families as F

    d = pathlib.Path(folder)
    mesh = P.make_multihost_mesh(coordinator_address=f"127.0.0.1:{port}",
                                 num_processes=MESH_PROCESSES,
                                 process_id=rank)
    db = ht.deserialize_database((d / "lit.db").read_bytes())
    eng = ht.deserialize_database((d / "dfa.db").read_bytes()).engines[0]
    data, lengths = P.pad_batch_for_mesh(
        engine_blocks(np.fromfile(d / "engine.bin", np.uint8), "blocks_16k"),
        mesh, ENGINE_BLOCK)
    half = data.shape[0] // MESH_PROCESSES
    mine = slice(rank * half, (rank + 1) * half)
    out = {"rank": rank, "backend": mesh.backend, "card": str(mesh.first),
           "lit": {}}
    corpora = {k: np.fromfile(d / f"{k}.bin", np.uint8) for k in MESH_KINDS}
    torch.cuda.synchronize()
    before = dict(F.family_state(db.lit).dispatches)
    T.reset_launches()
    for kind, corpus in corpora.items():
        blocks = [corpus[i:i + SHARD_BLOCK]
                  for i in range(0, len(corpus), SHARD_BLOCK)]
        cnt = P.sharded_teddy_count(corpus, db.lit.masks, mesh)
        first = ht.scan_batch(db, blocks, mesh=mesh)
        again = ht.scan_batch(db, blocks, mesh=mesh)
        check(again == first, f"3f process {rank} {kind}: repeat differs")
        np.save(d / f"lists_{kind}_{rank}.npy", mesh_rows(first))
        out["lit"][kind] = {"count": cnt}
    cnt = P.sharded_scan_counts(eng, data[mine], lengths[mine], mesh)
    mt = P.sharded_scan_matches(eng, data[mine], lengths[mine], mesh,
                                capacity=cap)
    out["launches"] = dict(T.LAUNCHES)
    out["families"] = ran_since(db.lit, before)
    np.savez(d / f"dfa_{rank}.npz", *[x.cpu().numpy() for x in mt])
    out["dfa"] = {"count": cnt, "rows": half}
    P.close_multihost_mesh()
    (d / f"worker_{rank}.json").write_text(json.dumps(out))
    return 0


def multiprocess_path(torch, ht, T, db, edb, corpora, ecorpus, singles
                      ) -> dict:
    """Phase 3f: the multi-process mesh at 3d's full width. Hands two
    worker processes of this script (`--mesh-worker`) the databases
    (serialized), the corpora and the DFA capacity through a temporary
    folder, and waits for both. With two or more cards each process
    takes its own card (NCCL); with one, both take card 0 (gloo, the
    collectives staged on the host). Then every process's lists must
    equal this process's single-process scan_batch (`singles[kind]
    ["lists"]`), its sharded_teddy_count the candidate total
    (`singles[kind]["total"]`), and its DFA count and gathered buffers a
    one-process sharded_scan_counts / sharded_scan_matches on a mesh of
    as many shards. A worker that fails or outlasts MESH_WAIT_S fails
    the phase."""
    import pathlib
    import socket
    import tempfile

    from hyperscan_tpu_torch import parallel as P

    eng = edb.engines[0]
    cards = torch.cuda.device_count()
    ref_mesh = P.Mesh([torch.device(DEVICE, r % cards)
                       for r in range(MESH_PROCESSES)], ("shards",))
    data, lengths = P.pad_batch_for_mesh(engine_blocks(ecorpus, "blocks_16k"),
                                         ref_mesh, ENGINE_BLOCK)
    want_n = P.sharded_scan_counts(eng, data, lengths, ref_mesh)
    cap = T._p2(max(want_n, 1))
    want_mt = [x.cpu().numpy() for x in P.sharded_scan_matches(
        eng, data, lengths, ref_mesh, capacity=cap)]
    del data, lengths
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_3f_") as folder:
        d = pathlib.Path(folder)
        (d / "lit.db").write_bytes(ht.serialize_database(db))
        (d / "dfa.db").write_bytes(ht.serialize_database(edb))
        for kind in MESH_KINDS:
            corpora[kind].tofile(d / f"{kind}.bin")
        ecorpus.tofile(d / "engine.bin")
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        procs = [subprocess.Popen([sys.executable, __file__, "--mesh-worker",
                                   str(r), str(port), folder, str(cap)])
                 for r in range(MESH_PROCESSES)]
        try:
            rcs = [p.wait(timeout=MESH_WAIT_S) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        check(rcs == [0] * MESH_PROCESSES, f"3f: worker exit codes {rcs}")
        res = [json.loads((d / f"worker_{r}.json").read_text())
               for r in range(MESH_PROCESSES)]
        for r, w in enumerate(res):
            for kind in MESH_KINDS:
                got = np.load(d / f"lists_{kind}_{r}.npy")
                check(np.array_equal(got, mesh_rows(singles[kind]["lists"])),
                      f"3f process {r} {kind}: lists != single-process "
                      "scan_batch")
                check(w["lit"][kind]["count"] == singles[kind]["total"],
                      f"3f process {r} {kind}: sharded_teddy_count "
                      f"{w['lit'][kind]['count']} != "
                      f"{singles[kind]['total']}")
            check(w["dfa"]["count"] == want_n,
                  f"3f process {r}: DFA count {w['dfa']['count']} != "
                  f"{want_n}")
            with np.load(d / f"dfa_{r}.npz") as z:
                check(all(np.array_equal(z[f"arr_{i}"], want_mt[i])
                          for i in range(5)),
                      f"3f process {r}: gathered DFA buffers != one process")
            for k in ("teddy_words_count", "dfa_scan_rows"):
                check(w["launches"][k] > 0, f"3f process {r}: kernel {k} "
                      "was not launched")
            check(w["families"] and all(w["launches"][FAMILY_FILTERS[f]] > 0
                                        for f in w["families"]),
                  f"3f process {r}: families {w['families']} did not launch "
                  "their filter kernels")
    return {"workers": res, "dfa_n": want_n, "cards": cards}


def log_multiprocess(mp: dict, card: str) -> None:
    """Phase 3f's lines: the group, and each process's families, launch
    counts and counts."""
    w0 = mp["workers"][0]
    log(f"3f multi-process mesh: {MESH_PROCESSES} processes on "
        f"{w0['backend']}, {mp['cards']} visible card(s), process cards "
        f"{[w['card'] for w in mp['workers']]}; lists, counts and DFA "
        f"buffers == single process [{card}]")
    for w in mp["workers"]:
        r = w["rank"]
        log(f"3f process {r}: families {w['families']}; launches "
            f"{ {k: v for k, v in w['launches'].items() if v} }; "
            f"sharded_teddy_count "
            f"{ {kind: t['count'] for kind, t in w['lit'].items()} }; "
            f"DFA over its {w['dfa']['rows']} rows: {w['dfa']['count']} "
            "matches")


def mesh_only() -> int:
    """`--mesh-only`: phase 3f alone, with what it compares against made
    here (build, the 10k ruleset, both 512 MiB corpora and their
    single-process scan_batch, the bounded DFA) — for a machine of
    several cards, where 3f runs on NCCL; then
    graft_entry.dryrun_multichip over every visible card."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    import hyperscan_tpu_torch as ht
    from hyperscan_tpu_torch.ops import _build
    from hyperscan_tpu_torch.ops import teddy as T
    from hyperscan_tpu_torch.ops import teddy_words as TW

    card = nvidia_smi("name,power.limit")
    log(f"card: {card}; {torch.cuda.device_count()} visible; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    _build.build()
    log(f"build: {time.perf_counter() - t0:.1f} s")
    pats, ids = patterns(10_000)
    db = ht.compile_multi(pats, ids=ids)
    edb = engine_dbs(ht)["bounded_dfa"][0]
    corpora, singles = {}, {}
    for kind in MESH_KINDS:
        corpora[kind] = gen_corpus(MAIN_BYTES, 1, kind)
        blocks = [corpora[kind][i:i + SHARD_BLOCK]
                  for i in range(0, MAIN_BYTES, SHARD_BLOCK)]
        total, _pos, _w = TW.teddy_scan(corpora[kind], db.lit.masks,
                                        hint_obj=db.lit, device=DEVICE)
        singles[kind] = {"lists": ht.scan_batch(db, blocks, device=DEVICE),
                         "total": total}
    mp = multiprocess_path(torch, ht, T, db, edb, corpora,
                           gen_engine_corpus(ENGINE_BYTES, 5), singles)
    log_multiprocess(mp, card)
    from hyperscan_tpu_torch import graft_entry as GE

    n = torch.cuda.device_count()
    t0 = time.perf_counter()
    dr = GE.dryrun_multichip(n, DEVICE)
    log(f"dryrun_multichip({n}) on {dr['devices']}: DFA count "
        f"{dr['count']}, teddy candidates {dr['teddy_count']}, product path "
        f"{sum(map(len, dr['single']))} matches sharded == unsharded; "
        f"{time.perf_counter() - t0:.1f} s [{card}]")
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


# --- kernel 4's stage modes (row 11) -----------------------------------------


def stage_kernel_checks(torch, T, db) -> int:
    """Phase 2e: kernel 4's stage modes 0-2 against their plain versions at
    16 MB, structured and iid (candidate counts, checksums, match counts;
    exact); stage 3's candidate counts equal stage 0's and stage 2's, and
    its match counts stage 2's. Returns the max abs error."""
    from hyperscan_tpu_torch.ops import teddy_kconfirm as K

    ft, _ct = T.device_tables(db.lit, DEVICE)
    kt = K.confirm_planes(db.lit, DEVICE)
    uc = ft.cmasks is not None
    err = 0
    for kind in ("structured", "iid"):
        corpus_t = torch.from_numpy(gen_corpus(CHECK_BYTES, 2, kind)).to(
            DEVICE)
        full = K.filter_kconfirm(corpus_t, ft, kt, use_classes=uc)
        got = {}
        for stage in (0, 1, 2):
            k = K.filter_kconfirm(corpus_t, ft, kt, use_classes=uc,
                                  stage=stage)
            p = K.filter_kconfirm_stage_plain(corpus_t, ft, kt,
                                              use_classes=uc, stage=stage)
            e = max(int((a.long() - b.long()).abs().max()) for a, b in
                    zip(k, p))
            err = max(err, e)
            check(e == 0, f"kernel 4 stage {stage} {kind} != plain version")
            got[stage] = k
        check(torch.equal(full[0], got[0][0])
              and torch.equal(full[0], got[2][0])
              and torch.equal(full[1], got[2][2]),
              f"{kind}: stage 3's counts != stage 0's and stage 2's")
        log(f"kernel check 4 stages {kind}: candidates "
            f"{int(got[0][0].long().sum())}, matches "
            f"{int(got[2][2].long().sum())}; stages 0-2 == plain, stage 3's "
            "counts == stage 0's and 2's: exact")
    return err


# --- streaming (runtime/stream.py, runtime/streamset.py) ---------------------

STREAMS = 16_384  # the StreamSet: 16,384 streams x 8 KiB writes a round
STREAM_WRITE = 8192
STREAM_ROUNDS = 6  # pipelined rounds a pass, after two synchronous rounds
SCAN_STREAMS = 1024  # scan_streams: 1,024 streams x 8 KiB
SCAN_ROUNDS = 4  # rounds after the first
ENGINE_STREAMS = 1024  # the bounded DFA: 1,024 streams x 16 KiB x 8 rounds
ENGINE_WRITE = 16 * 1024
ENGINE_ROUNDS = 8
CHECK_STREAMS = 64  # streams held against the host path and block scans


def stream_writes(extents, n_streams, hist, write) -> list:
    """Each stream's write of one round of `extents`."""
    ext_len = hist + write
    return [extents[i * ext_len + hist:(i + 1) * ext_len].tobytes()
            for i in range(n_streams)]


def streamset_pass(torch, F, SS, sdb, ext, hreq):
    """One pass of a StreamSet over the rounds of extents `ext` (round 0
    the writes alone, the others `hreq` bytes of history + the write, of
    STREAM_WRITE bytes a stream): two synchronous rounds, then the others
    pipelined: each round's extents uploaded and its filter started, one
    confirm_fetch_many, the rounds finished in order. Returns the
    per-round match lists, the family each pipelined round started with,
    the StreamSet and the last round's handle (it holds that round's
    extent tensor)."""
    n_streams = ext[0].size // STREAM_WRITE
    ss = SS.open_streamset(sdb, n_streams, device=DEVICE)
    wl = np.full(n_streams, STREAM_WRITE, np.int64)
    out = []
    for r in (0, 1):
        h = SS.streamset_write_start(
            sdb, ss, ext_np=ext[r], ext_t=torch.from_numpy(ext[r]).to(DEVICE),
            hlens=np.full(n_streams, hreq if r else 0, np.int64),
            chunk_lens=wl)
        out.append(SS.streamset_write_finish(sdb, ss, h))
    hl = np.full(n_streams, hreq, np.int64)
    handles = [SS.streamset_write_start(
        sdb, ss, ext_np=ext[r], ext_t=torch.from_numpy(ext[r]).to(DEVICE),
        hlens=hl, chunk_lens=wl) for r in range(2, len(ext))]
    gots = F.confirm_fetch_many([h.dev_handle for h in handles])
    for h, got in zip(handles, gots):
        out.append(SS.streamset_write_finish(sdb, ss, h, got=got))
    return out, [h.dev_handle.family for h in handles], ss, handles[-1]


def streaming_path(torch, ht, T, db, edbs, ecorpus) -> dict:
    """Phase 3e, streaming at full width through the stream entry points,
    with the launch counts read right after: the StreamSet (16,384 x 8 KiB
    rounds, two passes), scan_streams over 1,024 streams x 1 + SCAN_ROUNDS
    rounds, the bounded DFA in stream mode (1,024 x 16 KiB x 8 rounds:
    kernel C entered in carried states), and scan_streams(mesh=) over the
    1,024 streams on both meshes."""
    from hyperscan_tpu_torch import parallel as P
    from hyperscan_tpu_torch.database import compile_patterns
    from hyperscan_tpu_torch.grey import Grey
    from hyperscan_tpu_torch.ops import teddy_families as F
    from hyperscan_tpu_torch.runtime import streamset as SS
    from hyperscan_tpu_torch.runtime.stream import history_required
    from hyperscan_tpu_torch.tools.benchdata import stream_extents

    # the 10k ruleset in stream mode: the compiler's output does not
    # depend on the mode, so the block database's blob is loaded again
    # with its mode set (a second compile would take about a minute)
    sdb = ht.deserialize_database(ht.serialize_database(db))
    sdb.mode = ht.HS_MODE_STREAM
    hreq = history_required(sdb)
    pats, flags, grey, _k = ENGINE_SETS["bounded_dfa"]
    edb = compile_patterns(pats, flags, mode=ht.HS_MODE_STREAM,
                           grey=Grey(**grey))
    ext = [stream_extents(STREAMS, STREAM_WRITE, hreq if r else 0, r)
           for r in range(2 + STREAM_ROUNDS)]
    sc_writes = [stream_writes(stream_extents(SCAN_STREAMS, STREAM_WRITE, 0,
                                              r), SCAN_STREAMS, 0,
                               STREAM_WRITE) for r in range(1 + SCAN_ROUNDS)]
    per = ENGINE_ROUNDS * ENGINE_WRITE
    e_writes = [[ecorpus[i * per + r * ENGINE_WRITE:
                         i * per + (r + 1) * ENGINE_WRITE].tobytes()
                 for i in range(ENGINE_STREAMS)] for r in range(ENGINE_ROUNDS)]
    meshes = shard_meshes(torch, P)
    before = dict(F.family_state(sdb.lit).dispatches)
    T.reset_launches()
    passes = [streamset_pass(torch, F, SS, sdb, ext, hreq) for _ in range(2)]
    streams = [ht.open_stream(sdb, device=DEVICE)
               for _ in range(SCAN_STREAMS)]
    sc_out = [ht.scan_streams(sdb, streams, w) for w in sc_writes]
    sc_out.append([ht.close_stream(st) for st in streams])
    # the bounded DFA in stream mode
    estreams = [ht.open_stream(edb, device=DEVICE)
                for _ in range(ENGINE_STREAMS)]
    e_out, e_states = [], []
    for w in e_writes:
        # the states the streams carry into the round (and, last, out of
        # the last round): kernel C is checked at these entries
        e_states.append(np.asarray(
            [s_.engine_states[0] for s_ in estreams], np.int64))
        e_out.append(ht.scan_streams(edb, estreams, w))
    e_states.append(np.asarray([s_.engine_states[0] for s_ in estreams],
                               np.int64))
    e_out.append([ht.close_stream(st) for st in estreams])
    # scan_streams(mesh=) over the same 1,024 streams' writes
    mesh_out = {}
    for name, m in meshes.items():
        ms_ = [ht.open_stream(sdb, device=DEVICE)
               for _ in range(SCAN_STREAMS)]
        mesh_out[name] = [ht.scan_streams(sdb, ms_, w, mesh=m)
                          for w in sc_writes]
        mesh_out[name].append([ht.close_stream(st) for st in ms_])
    return {"sdb": sdb, "edb": edb, "hreq": hreq, "ext": ext,
            "passes": passes, "sc": (sc_out, sc_writes),
            "engine": (e_out, e_writes), "engine_states": e_states,
            "mesh": mesh_out, "launches": dict(T.LAUNCHES),
            "families": ran_since(sdb.lit, before)}


def _as_set(ms) -> set:
    return {(m[0], m[2]) for m in ms}


def streaming_checks(ht, db, edbs, st) -> dict:
    """Phase 3e's checks, all exact: the second StreamSet pass equals the
    first; the first CHECK_STREAMS streams of the StreamSet, of
    scan_streams and of the bounded-DFA streams equal the port's host
    path (host_scan_limit raised past the write total), round by round
    and at close; each of those streams' writes, concatenated and scanned
    as one block, gives its matches; the sharded scan_streams equal the
    unsharded; every planted match of the StreamSet and scan_streams
    streams is found."""
    from hyperscan_tpu_torch.runtime import streamset as SS
    from hyperscan_tpu_torch.tools.benchdata import stream_plants

    sdb, edb, hreq = st["sdb"], st["edb"], st["hreq"]
    warm = st["passes"][0][0]
    check(st["passes"][1][0] == warm, "the second StreamSet pass differs "
          "from the first")
    ss = st["passes"][-1][2]
    ss_close = [ht.close_stream(SS.streamset_stream(ss, i))
                for i in range(CHECK_STREAMS)]
    writes = [stream_writes(e, CHECK_STREAMS, hreq if r else 0,
                            STREAM_WRITE) for r, e in enumerate(st["ext"])]
    sc_out, sc_writes = st["sc"]
    e_out, e_writes = st["engine"]
    cases = (("StreamSet", sdb, db, warm + [ss_close], writes),
             ("scan_streams", sdb, db, sc_out, sc_writes),
             ("bounded DFA streams", edb, edbs["bounded_dfa"][0], e_out,
              e_writes))
    out = {}
    for name, d, bdb, got, wr in cases:
        with host_limit(d, 1 << 30):
            hs_ = [ht.open_stream(d, device=DEVICE)
                   for _ in range(CHECK_STREAMS)]
            host = [ht.scan_streams(d, hs_, [w[i] for i in
                                             range(CHECK_STREAMS)])
                    for w in wr]
            host.append([ht.close_stream(s_) for s_ in hs_])
        for r, (g, h) in enumerate(zip(got, host)):
            check([sorted(x) for x in g[:CHECK_STREAMS]]
                  == [sorted(x) for x in h],
                  f"{name} round {r}: the first {CHECK_STREAMS} streams != "
                  "the host path")
        n_match = 0
        for i in range(CHECK_STREAMS):
            data = b"".join(w[i] for w in wr)
            blk = ht.scan(bdb, data, device="cpu")
            mine = set().union(*(_as_set(g[i]) for g in got))
            check(mine == _as_set(blk), f"{name} stream {i}: its matches "
                  "!= the block scan of its writes")
            n_match += len(mine)
        out[name] = n_match
    for name, lists in st["mesh"].items():
        check(lists == sc_out, f"scan_streams(mesh={name}) != unsharded")
    plants = stream_plants(STREAMS, (2 + STREAM_ROUNDS) * STREAM_WRITE)
    found = {(i, m[2]) for rnd in warm for i, ms in enumerate(rnd)
             for m in ms if m[0] == 0}
    check(plants <= found and plants, f"StreamSet: {len(plants - found)} "
          f"of {len(plants)} planted matches missing")
    sc_plants = stream_plants(SCAN_STREAMS,
                              len(sc_writes) * STREAM_WRITE)
    sc_found = {(i, m[2]) for rnd in sc_out for i, ms in enumerate(rnd)
                for m in ms if m[0] == 0}
    check(sc_plants <= sc_found and sc_plants,
          "scan_streams: planted matches missing")
    out["plants"] = (len(plants), len(sc_plants))
    return out


def _arr_err(a, b) -> int:
    """Max abs difference of two integer arrays (their size difference,
    at least 1, when the shapes differ)."""
    a, b = np.asarray(a, np.int64), np.asarray(b, np.int64)
    if a.shape != b.shape:
        return max(1, abs(a.size - b.size))
    return int(np.abs(a - b).max()) if a.size else 0


def path_kernel_checks(torch, T, lit, h, what: str,
                       learned: bool = False) -> dict:
    """The kernels of the family of a literal dispatch `h` (a
    teddy_families.ConfirmHandle: in 3 and 3c each 512 MiB corpus under
    its default and each forced family; the last StreamSet round of 3e,
    on its own extent tensor of 16,384 stitched extents; in 3g the last
    SOM block scan and SOM round), on its corpus tensor at its
    capacities, each against its plain version on the same bytes, exact
    (kernel A on the class and on the byte tables); the hash confirm's
    pair total also equals the dispatch's own (the same function of the
    same inputs). With `learned` (a scan of the same bytes learned the
    capacities), no cell holds more candidates than capc. `what` names
    the dispatch in the log and the failures. Returns the max abs error
    of each kernel, keyed as phase 2c's (and "compact", "confirm" for
    kernels A and B)."""
    from hyperscan_tpu_torch.ops import extract as X
    from hyperscan_tpu_torch.ops import teddy_gate as G
    from hyperscan_tpu_torch.ops import teddy_kconfirm as K

    corpus = h.corpus[:h.n_valid]
    n = corpus.numel()
    ft, ct = T.device_tables(lit, DEVICE)
    classes = ft.cmasks is not None
    errs = {}
    if h.family == "kconfirm":
        kt = K.confirm_planes(lit, DEVICE)
        ok_ = K.filter_kconfirm(corpus, ft, kt, use_classes=classes)
        op_ = K.filter_kconfirm_plain(corpus, ft, kt, use_classes=classes)
        errs["kconfirm"] = max(
            int((ok_[0] - op_[0]).abs().max()),
            cell_err(torch, ok_[2], ok_[1], op_[2], op_[1], K.CAPC2),
            cell_err(torch, ok_[3], ok_[1], op_[3], op_[1], K.CAPC2))
        check(errs["kconfirm"] == 0, f"{what}: kernel 4 != plain")
        check(int(h.meta[2]) == int(op_[1].sum()),
              f"{what}: its match total != the plain version's")
        log(f"{what} kernels (kconfirm) on its {n} B: "
            f"{int(op_[1].sum())} hash-matched pairs: exact")
        return errs
    if h.family == "dense":
        plane_k = T.filter_plane(corpus, ft, use_classes=classes)
        plane_p = T.filter_plane_plain(corpus, ft, use_classes=classes)
        errs["plane"] = int((plane_k != plane_p).sum())
        total = int(plane_p.sum())
        mk, pos = X.plane_extract(plane_k, n, h.caps[0])
        mp, qp = X.plane_extract_plain(plane_k, n, h.caps[0])
        errs["extract"] = max(int((mk - mp).abs().max()),
                              int((pos - qp).abs().max()))
    else:
        capc = h.caps[1]
        if h.family == "gated":
            gt = G.device_gate_table(lit, DEVICE)
            fk, kk = G.gate_rows(corpus, gt)
            fp, kp = G.gate_rows_plain(corpus, gt)
            errs["gate"] = max(int((fk.int() - fp.int()).abs().max()),
                               int((kk - kp).abs().max()))
            (pk, ck), cp, errs["rescan"] = rescan_err(
                torch, T, G, corpus, ft, fk, kk, capc)
        else:
            (pk, ck), errs["compact"] = compare_filter(torch, T, corpus, ft,
                                                       capc, classes)
            if classes:  # the byte tables give the same words
                errs["compact"] = max(errs["compact"], compare_filter(
                    torch, T, corpus, ft, capc, False)[1])
            cp = ck
        check(not learned or int(cp.max()) <= capc, f"{what}: learned "
              f"{h.family} capc {capc} below the hottest cell")
        total = int(ck.sum())
        _m, pos = T.compact_combine(pk, ck, capc, h.caps[0])
    for k, e in errs.items():
        check(e == 0, f"{what} ({h.family}): kernel {k} != plain "
              "version")
    probes = sum(g[4] for g in ct.groups)
    (_p, tot), errs["confirm"] = compare_confirm(
        torch, T, corpus, pos, ct, T._p2(probes * pos.numel() + 1))
    check(int(h.meta[2]) == int(tot), f"{what}: its pair total "
          f"{int(h.meta[2])} != the plain version's {int(tot)}")
    log(f"{what} kernels ({h.family}) on its {n} B: "
        f"{total} candidates, {int(tot)} hash-matched pairs: exact")
    return errs


def stream_dfa_checks(torch, st) -> int:
    """Kernel C at the bounded-DFA streams' inputs: every round's 1,024
    writes, entered in the states the streams carried into it, through
    the wrapper the path calls (`dfa_scan_corpus_device`, init_states)
    on the card, and on the same chunk rows with its tables in global
    memory, against the plain version on those rows: records and finals
    exact, and the finals equal the states the path carried out of the
    round. Returns the max abs error."""
    from hyperscan_tpu_torch.ops import dfa_kernel as DK

    (eng,) = st["edb"].engines
    H, CS = DK.chunk_shape(eng)
    _o, e_writes = st["engine"]
    states = st["engine_states"]
    err = n_rec = 0
    for r, w in enumerate(e_writes):
        (b_k, p_k, a_k), fin_k = DK.dfa_scan_corpus_device(
            eng, w, np.zeros(len(w), bool), init_states=states[r],
            device=DEVICE)
        corpus = np.concatenate([np.frombuffer(x, np.uint8) for x in w])
        corpus_t, tabs, meta, plan, _s, _l = chunk_inputs(
            torch, eng, corpus, [len(x) for x in w], H, CS, states[r])
        rp, tp, fp = DK.dfa_scan_chunks_plain(corpus_t, tabs, meta, H,
                                              1 << 22)
        check(int(tp) <= 1 << 22, "stream DFA round: records past 2^22")
        c, t, a = rp[:int(tp)].long().cpu().numpy().T
        fin_p = fp.cpu().numpy()[plan.last]
        # the other placement on the same chunk rows: global tables
        rg, tg, fg = DK.dfa_scan_chunks(corpus_t, tabs, meta, H, 1 << 22,
                                        placement="global")
        g = rg[:int(tg)].long()
        g = g[torch.argsort(g[:, 0] * 512 + g[:, 1])].cpu().numpy()
        e = max(_arr_err(b_k, plan.block[c]),
                _arr_err(p_k, plan.body_start[c] + t - H),
                _arr_err(a_k, a), _arr_err(fin_k, fin_p),
                _arr_err(fin_p, states[r + 1]),
                _arr_err(g, rp[:int(tp)].long().cpu().numpy()),
                _arr_err(fg.cpu().numpy(), fp.cpu().numpy()))
        check(e == 0, f"stream DFA round {r}: kernel C (carried entry "
              "states) != plain version")
        err = max(err, e)
        n_rec += len(b_k)
    log(f"bounded DFA streams, kernel C at the path's inputs: "
        f"{len(e_writes)} rounds x {len(e_writes[0])} writes entered in "
        f"carried states, {n_rec} records (shared and global tables), "
        "finals == the streams' carried states: exact")
    return err


# --- SOM on the card, and the bench at reduced depth (3g) --------------------

SOM_PATTERNS = 100  # SOM block ruleset: the first 100 bench patterns ...
SOM_STREAM_PATTERNS = 96  # ... and the SOM StreamSet's first 96, both
# without shape 5 (bench.py:391-393, :376-383), SOM_LEFTMOST
SOM_STREAMS = 4096  # the SOM StreamSet: 4,096 streams x 8 KiB, 6 rounds
SOM_ROUNDS = 6
BENCH_MB = 64  # the bench at reduced depth: run_config at 64 MiB, 2 scans
BENCH_ITERS = 2
BENCH_STREAMS = 1024  # and run_streamset at 1,024 streams, 6 rounds
BENCH_ROUNDS = 6


def som_path(torch, ht, T, corpora) -> dict:
    """Phase 3g's driving, with the launch counts set to 0 just before it
    and read just after: the SOM block ruleset through scan_batch over
    each 512 MiB corpus of `corpora`, twice (the repeat equals the first),
    then the SOM StreamSet (two passes of SOM_ROUNDS pipelined rounds)."""
    from hyperscan_tpu_torch.ops import teddy_families as F
    from hyperscan_tpu_torch.runtime import streamset as SS
    from hyperscan_tpu_torch.runtime.stream import history_required
    from hyperscan_tpu_torch.tools.bench import HOST_LIMIT, bench_db
    from hyperscan_tpu_torch.tools.benchdata import stream_extents

    som = ht.HS_FLAG_SOM_LEFTMOST
    bdb = bench_db(SOM_PATTERNS, som, (5,))
    check(bdb.lit is not None and not bdb.engines
          and len(bdb.lit.rev_validators) == len(bdb.patterns),
          "the SOM block ruleset must be literal-routed, a reverse "
          "validator a pattern")
    sdb = bench_db(SOM_STREAM_PATTERNS, som, (5,), ht.HS_MODE_STREAM,
                   HOST_LIMIT)
    hreq = history_required(sdb)
    ext = [stream_extents(SOM_STREAMS, STREAM_WRITE, hreq if r else 0, r)
           for r in range(2 + SOM_ROUNDS)]
    T.reset_launches()
    block = {}
    for kind, corpus in corpora.items():
        outs, fams = [], []
        for _ in range(2):
            before = dict(F.family_state(bdb.lit).dispatches)
            outs.append(ht.scan_batch(bdb, [corpus], device=DEVICE)[0])
            fams.append(ran_since(bdb.lit, before))
        check(outs[1] == outs[0], f"SOM block {kind}: a repeated scan "
              "differs")
        block[kind] = (outs[0], fams)
    before = dict(F.family_state(sdb.lit).dispatches)
    passes = [streamset_pass(torch, F, SS, sdb, ext, hreq) for _ in range(2)]
    return {"bdb": bdb, "sdb": sdb, "hreq": hreq, "ext": ext,
            "block": block, "passes": passes,
            "stream_families": ran_since(sdb.lit, before),
            "launches": dict(T.LAUNCHES)}


def som_checks(ht, T, sp, corpora) -> None:
    """Phase 3g's checks, all exact. SOM block, each corpus: the matches
    in the planted region are exactly each plant's own SOM matches (the
    plant scanned alone on the CPU) moved to its known start, and at least
    one plant matches; the matches ending in the first 64 MiB equal the
    port's host route on the CPU (a Grey whose host_scan_limit covers the
    prefix). SOM StreamSet: both passes agree; each round's matches of
    the first CHECK_STREAMS streams equal scan_streams of those streams'
    writes on the CPU host route; every plant benchdata.stream_plants
    predicts is found, its start reported."""
    from hyperscan_tpu_torch.grey import Grey
    from hyperscan_tpu_torch.tools.bench import bench_db
    from hyperscan_tpu_torch.tools.benchdata import (STREAM_PLANT,
                                                     plant_starts,
                                                     stream_plants)

    bdb, sdb, hreq = sp["bdb"], sp["sdb"], sp["hreq"]
    alone = {p: ht.scan(bdb, p, device="cpu") for p in set(PLANTS)}
    want = {(i, at + f, at + t) for at, p in plant_starts()
            for (i, f, t) in alone[p]}
    check(want, "no plant matches the SOM ruleset")
    edge = PLANT_AT + 4096
    hdb = bench_db(SOM_PATTERNS, ht.HS_FLAG_SOM_LEFTMOST, (5,),
                   grey=Grey(host_scan_limit=PREFIX_BYTES))
    for kind, (out, _f) in sp["block"].items():
        got = {m for m in out if m[2] <= edge}
        check(got == want, f"SOM block {kind}: planted-region matches "
              f"{sorted(got)[:4]} != the plants' own at their starts "
              f"{sorted(want)[:4]}")
        host = ht.scan(hdb, corpora[kind][:PREFIX_BYTES].tobytes(),
                       device="cpu")
        dev = [m for m in out if m[2] <= PREFIX_BYTES]
        check(sorted(dev) == sorted(host), f"SOM block {kind}: the 64 MiB "
              f"prefix's {len(dev)} matches != the host route's {len(host)}")
        log(f"SOM block {kind}: {len(out)} matches; {len(want)} planted "
            f"matches at their starts; 64 MiB prefix == host route "
            f"({len(host)} matches)")
    first, again = sp["passes"][0][0], sp["passes"][1][0]
    check(again == first, "SOM StreamSet: the second pass differs from the "
          "first")
    writes = [stream_writes(e, CHECK_STREAMS, hreq if r else 0,
                            STREAM_WRITE) for r, e in enumerate(sp["ext"])]
    streams = [ht.open_stream(sdb, device="cpu")
               for _ in range(CHECK_STREAMS)]
    with host_limit(sdb, 1 << 30):
        host = [ht.scan_streams(sdb, streams, w) for w in writes]
    for r, (g, h) in enumerate(zip(again, host)):
        check([sorted(x) for x in g[:CHECK_STREAMS]]
              == [sorted(x) for x in h], f"SOM StreamSet round {r}: the "
              f"first {CHECK_STREAMS} streams != the host route")
    plants = stream_plants(SOM_STREAMS, len(sp["ext"]) * STREAM_WRITE)
    found = {(i, m[2]) for rnd in again for i, ms in enumerate(rnd)
             for m in ms if m[0] == 0}
    starts_ok = all(m[1] == m[2] - len(STREAM_PLANT) + 1 for rnd in again
                    for ms in rnd for m in ms if m[0] == 0)
    check(plants and plants <= found and starts_ok, f"SOM StreamSet: "
          f"{len(plants - found)} of {len(plants)} planted matches missing "
          f"or their starts wrong")
    log(f"SOM StreamSet: the first {CHECK_STREAMS} streams == host route "
        f"round by round ({sum(len(m) for rnd in host for m in rnd)} "
        f"matches), {len(plants)} planted matches at their starts")


def bench_reduced(T, db100, sdb) -> dict:
    """The port's bench (hyperscan_tpu_torch/tools/bench.py) at reduced
    depth, with its own launch counts: run_config with the 100-pattern
    database at BENCH_MB MiB, BENCH_ITERS scans, and run_streamset with
    the 10k stream database at BENCH_STREAMS streams x BENCH_ROUNDS
    rounds. Both assert their plants (run_streamset every plant
    benchdata.stream_plants predicts); the block scans' matches must
    number at least the plants too."""
    from hyperscan_tpu_torch.tools import bench as B

    T.reset_launches()
    _g, m, _c = B.run_config(100, DEVICE, corpus_mb=BENCH_MB,
                             iters=BENCH_ITERS, db=db100)
    _g, nm = B.run_streamset(sdb, BENCH_STREAMS, BENCH_ROUNDS, DEVICE)
    launches = dict(T.LAUNCHES)
    check(m >= BENCH_ITERS * len(PLANTS),
          f"the bench at reduced depth: {m} block matches")
    check(any(launches[k] > 0 for k in FAMILY_FILTERS.values()),
          "the bench at reduced depth launched no filter kernel")
    return {"block_matches": m, "stream_matches": nm, "launches": launches}


# --- the main path -----------------------------------------------------------


DEFAULT_FAMILY = {"structured": "gated", "iid": "kconfirm"}  # last scans'


def main_path(ht, T, db, kind: str):
    """Phase 3 for one corpus kind: scan_batch over 512 MB twice (the
    first scan learns the capacities and the family; the repeat must
    equal it). Returns the corpus, the matches and the families each scan
    ran (from the dispatch counts)."""
    from hyperscan_tpu_torch.ops import teddy_families as F

    corpus = gen_corpus(MAIN_BYTES, 1, kind)
    st = F.family_state(db.lit)
    outs, fams = [], []
    for _ in range(2):
        before = dict(st.dispatches)
        outs.append(ht.scan_batch(db, [corpus], device=DEVICE)[0])
        fams.append(ran_since(db.lit, before))
    out = outs[0]
    check(outs[1] == out, f"{kind}: repeated scan differs")
    # the planted region: the same matches as the host path over it
    edge = PLANT_AT + 4096
    host = ht.scan(db, corpus[:edge + 64].tobytes(), device="cpu")
    want = {m for m in host if m[2] <= edge}
    got = {m for m in out if m[2] <= edge}
    check(got == want, f"{kind}: planted-region matches differ from host")
    check(len(want) >= len(PLANTS), f"{kind}: planted matches missing")
    return corpus, out, fams


def prefix_differential(torch, T, db, corpus, host: set) -> tuple:
    """Verified pairs ending in the first 64 MB: device path (over the
    whole uploaded corpus, the database's current family) == the port's
    host filter + confirm (`host`, from host_prefix)."""
    from hyperscan_tpu_torch.runtime.lit_runtime import verify_pairs
    from hyperscan_tpu_torch.ops import teddy_families as F

    lit = db.lit
    z = np.zeros(1, np.int64)
    f, p = F.confirm_scan(T.corpus_tensor(corpus, DEVICE), lit, len(corpus))
    f, p = verify_pairs(lit, corpus, z, f, p)
    dev = {(a, b) for a, b in zip(f.tolist(), p.tolist())
           if b < PREFIX_BYTES}
    check(dev == host, f"64 MB prefix: device {len(dev)} pairs, host "
          f"{len(host)}, missing {len(host - dev)}, extra {len(dev - host)}")
    return len(dev), len(host)


# --- phase 5: the differential tools on the card ----------------------------

BATTERY = "conformance/signatures.txt"
BATTERY_SUBSET = 48  # the seeded subset of the battery's expressions
BATTERY_SEED = 0
FUZZ_ROUNDS = 3
FUZZ_SEED = 0
LITERAL_KERNELS = ("teddy_filter_compact", "teddy_hash_confirm", "teddy_gate",
                   "teddy_rescan_rows", "teddy_kconfirm",
                   "teddy_filter_plane", "plane_extract")


def battery_subset(k: int, seed: int) -> list:
    """The lines of a seeded subset of the conformance battery: k of its
    expressions that are not combinations, and every combination whose
    sub-expression ids all lie among them."""
    import re

    from hyperscan_tpu_torch.flags import HS_FLAG_COMBINATION
    from hyperscan_tpu_torch.tools.hscheck import parse_line

    with open(BATTERY, errors="replace") as f:
        lines = [l for l in f.read().splitlines() if parse_line(l)]
    ents = [parse_line(l) for l in lines]
    plain = [i for i, e in enumerate(ents) if not e[2] & HS_FLAG_COMBINATION]
    pick = {plain[j] for j in np.random.default_rng(seed).choice(
        len(plain), min(k, len(plain)), replace=False).tolist()}
    ids = {ents[i][0] for i in pick}
    pick |= {i for i, e in enumerate(ents) if e[2] & HS_FLAG_COMBINATION
             and {int(x) for x in re.findall(r"\d+", e[1])} <= ids}
    return [lines[i] for i in sorted(pick)]


def differential_tools(T) -> dict:
    """Phase 5: the port's hscollider over a seeded subset of the
    conformance battery and fuzz rounds, every scan on the card (both
    tools compile with Grey(host_scan_limit=0), so their small corpora
    take the device branch). No diff, no fuzz failure, and the literal
    kernels launched during each."""
    import os
    import tempfile

    from hyperscan_tpu_torch.tools import fuzz, hscollider

    sub = battery_subset(BATTERY_SUBSET, BATTERY_SEED)
    out = {"battery": len(sub)}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "battery.txt")
        with open(path, "w") as f:
            f.write("\n".join(sub) + "\n")
        T.reset_launches()
        t0 = time.perf_counter()
        rc = hscollider.main([path, "--device", DEVICE, "--seed",
                              str(BATTERY_SEED)])
        out["collider_s"] = time.perf_counter() - t0
    out["collider_launches"] = dict(T.LAUNCHES)
    check(rc == 0, f"hscollider found diffs on the card ({len(sub)} "
          "expressions of the battery)")
    T.reset_launches()
    rng = np.random.default_rng(FUZZ_SEED)
    t0 = time.perf_counter()
    for r in range(FUZZ_ROUNDS):
        fails = fuzz.fuzz_round(rng, device=DEVICE)
        check(not fails, f"fuzz round {r} on the card: {fails[:3]}")
    out["fuzz_s"] = time.perf_counter() - t0
    out["fuzz_launches"] = dict(T.LAUNCHES)
    for tool in ("collider", "fuzz"):
        check(sum(out[f"{tool}_launches"][k] for k in LITERAL_KERNELS) > 0,
              f"the {tool}'s scans launched no literal kernel")
    return out


# --- phase 6: Chimera on the card --------------------------------------------

CHIMERA_PATS = [r"(\w+)@example\.com", r"attack(\d+)", r"GET /(\w+)\.php"]
CHIMERA_BYTES = 2 * MB
CHIMERA_PLANTS = [b" bob@example.com ", b" attack42 ", b" GET /index.php "]


def chimera_path(T) -> dict:
    """Phase 6: `ch_scan` over a buffer above `host_scan_limit` with a
    database whose prefilter is literal-routed: its matches on the card
    equal its matches on the CPU, and the family's filter kernel
    launched."""
    from hyperscan_tpu_torch import chimera as ch

    db = ch.ch_compile_multi(CHIMERA_PATS, ids=[1, 2, 3])
    pf = db.prefilter_db
    check(pf is not None and pf.lit is not None and not pf.engines
          and db.prefilter_ids == [0, 1, 2],
          "the Chimera prefilter must be literal-routed")
    data = bytearray(gen_corpus(CHIMERA_BYTES, 7, "structured").tobytes())
    for k, off in enumerate(range(4096, CHIMERA_BYTES - 64, 65_537)):
        plant = CHIMERA_PLANTS[k % len(CHIMERA_PLANTS)]
        data[off:off + len(plant)] = plant
    data = bytes(data)
    check(len(data) > pf.host_scan_limit, "Chimera buffer below the limit")
    T.reset_launches()
    got = []
    rc = ch.ch_scan(db, data, matches=got, device=DEVICE)
    launches = dict(T.LAUNCHES)
    want = []
    rc_cpu = ch.ch_scan(db, data, matches=want, device="cpu")
    check(rc == rc_cpu == ch.CH_SUCCESS, "ch_scan return codes differ")
    check(got == want, "ch_scan on the card != ch_scan on the CPU")
    n_plants = len(range(4096, CHIMERA_BYTES - 64, 65_537))
    check(len(got) >= n_plants, "Chimera missed planted matches")
    check(any(launches[k] > 0 for k in ("teddy_filter_compact",
                                        "teddy_rescan_rows", "teddy_kconfirm",
                                        "teddy_filter_plane")),
          "Chimera's prefilter launched no filter kernel")
    return {"matches": len(got), "plants": n_plants,
            "launches": launches}


# --- phase 7: the feature surface on the card -------------------------------

FEATURE_BYTES = 256 * MB
FEATURE_BLOCK = 16 * MB  # scan_batch blocks, and the host-route prefix
FEATURE_SPACING = 65_537  # a plant every ~64 KiB: ~4,096 a database
FEATURE_SEED = 13
FEATURE_STREAMS = 4096  # the feature StreamSets: 4,096 x 8 KiB x 6 rounds
FEATURE_ROUNDS = 6
FEATURE_KERNELS = ("teddy_filter_compact", "teddy_hash_confirm", "dfa_scan",
                   "nfa_layered")  # kernels A, B, C and D


def feature_kernel_checks(torch, T, name: str):
    """Phase 7's kernel checks for feature `name`, as run_feature's
    `kernel_checks` hook: after the database's scan, the literal
    family's kernels at the path's input (the scanned corpus dispatched
    again at the learned capacities, as 3g does) through
    path_kernel_checks, and each engine's kernel on the last block of
    `block` bytes against its plain version, as phase 2b does: kernel C
    for a DFA (chunk-halo or speculative shape, as the path picks) and
    for the speculative core of a cyclic NFA, kernel D for a
    device-eligible bit-NFA. The launches of these checks are taken back
    out of the counts. Returns the max abs error of each kernel, keyed
    as path_kernel_checks's, and "dfa_scan" / "nfa_layered"."""
    from hyperscan_tpu_torch.database import (MAX_HALO_DEPTH, DfaEngine,
                                              NfaEngine)
    from hyperscan_tpu_torch.ops import dfa_kernel as DK
    from hyperscan_tpu_torch.ops import nfa_kernel as NK
    from hyperscan_tpu_torch.ops import teddy_families as F

    def held(db, corpus, block) -> dict:
        counts = dict(T.LAUNCHES)
        errs = {}
        if db.lit is not None:
            ran = {k for k, v in F.family_state(db.lit).dispatches.items()
                   if v}
            h = F.confirm_start(T.corpus_tensor(corpus, DEVICE), db.lit,
                                corpus.size)
            check(h.family in ran, f"feature {name}: dispatch family "
                  f"{h.family} is not one the scan ran ({sorted(ran)})")
            errs = path_kernel_checks(torch, T, db.lit, h, f"feature {name}")
            del h
        last = corpus[-block:]
        for eng in db.engines:
            if isinstance(eng, NfaEngine) and NK.nfa_device_eligible(eng):
                bs, be, ba, _ne = NK.block_bounds(
                    np.zeros(1, np.int64), np.array([block]),
                    np.ones(1, bool), DEVICE)
                (_r, tot, _e), e = compare_nfa(
                    torch, NK, torch.from_numpy(last).to(DEVICE),
                    NK.device_plan(eng, DEVICE), bs, be, ba)
                errs["nfa_layered"] = max(errs.get("nfa_layered", 0), e)
                log(f"feature {name} kernel D on its last {block} B: "
                    f"{int(tot)} records: exact")
                continue
            if isinstance(eng, NfaEngine) and eng.spec_dfa is not None:
                d, H, CS = eng.spec_dfa, 0, DK.SPEC_CS
            elif isinstance(eng, DfaEngine):
                d = eng
                bounded = (eng.max_depth is not None
                           and eng.max_depth <= MAX_HALO_DEPTH)
                H, CS = DK.chunk_shape(eng) if bounded else (0, DK.SPEC_CS)
            else:
                continue  # SOM, LBR and the other NFAs scan on the host
            corpus_t, tabs, meta, _p, _s, _l = chunk_inputs(
                torch, d, last, [block], H, CS, np.full(1, d.start_state))
            (_r, tot, _f), e = compare_dfa(torch, DK, corpus_t, tabs, meta,
                                           H)
            errs["dfa_scan"] = max(errs.get("dfa_scan", 0), e)
            log(f"feature {name} kernel C ({type(eng).__name__}, H={H}) on "
                f"its last {block} B: {int(tot)} records, shared and "
                "global tables: exact")
        T.LAUNCHES.update(counts)
        return errs

    return held


def feature_path(torch, T, card: str) -> dict:
    """Phase 7, with the launch counts set to 0 just before it and read
    just after: tools/features.run_feature for every feature database on
    the card, each kernel the database ran held against its plain
    version at its inputs (feature_kernel_checks, not counted), the
    card's memory read before each database is built and after it is
    dropped."""
    import gc

    from hyperscan_tpu_torch.tools import features as FT

    base = FT.base_corpus(FEATURE_BYTES, FEATURE_SEED)
    per = {}
    T.reset_launches()
    for name in FT.FEATURES:
        gc.collect()
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        before = dict(T.LAUNCHES)
        r = FT.run_feature(
            name, base, device=DEVICE, block=FEATURE_BLOCK,
            prefix=FEATURE_BLOCK, spacing=FEATURE_SPACING,
            streams=FEATURE_STREAMS, write=STREAM_WRITE,
            rounds=FEATURE_ROUNDS, check_streams=CHECK_STREAMS,
            sync=torch.cuda.synchronize,
            kernel_checks=feature_kernel_checks(torch, T, name))
        r["launches"] = {k: v - before[k] for k, v in T.LAUNCHES.items()
                         if v > before[k]}
        gc.collect()
        torch.cuda.synchronize()
        r["mem_left"] = torch.cuda.memory_allocated() - mem0
        check(r["mem_left"] <= 512, f"feature {name}: dropping the database "
              f"left {r['mem_left']} B allocated on the card")
        per[name] = r
        line = (f"feature {name}: {r['plants']} plants found, "
                f"{r['matches']} matches")
        if "stream_bytes" in r:
            line += (f"; StreamSet {FEATURE_STREAMS} x {STREAM_WRITE} B x "
                     f"{FEATURE_ROUNDS} rounds, {r['stream_matches']} "
                     "matches")
        log(f"{line}; families {r.get('families', {})}; launches "
            f"{r['launches']}; memory left {r['mem_left']} B [{card}]")
    launches = dict(T.LAUNCHES)
    for k in FEATURE_KERNELS:
        check(launches[k] > 0, f"kernel {k} was not launched in the feature "
              "phase")
    return {"features": per, "launches": launches}


# --- phase 8: the graft entry points and the per-kernel benches ------------

SURFACE_SHARDS = 4  # dryrun_multichip on four shards of card 0
KBENCH_MB = (16,)  # the kernel bench at reduced depth: a 16 MiB block
KBENCH_REPS = 5
KCONF_MB = 64  # the kconfirm bench at 64 MiB, 2 timed scans a family
KCONF_ITERS = 2


def surface_path(torch, T, db, clock_hz) -> dict:
    """Phase 8, every call through its entry point: the block-scan step of
    graft_entry.entry() on the card, dryrun_multichip on four shards of
    card 0 (built as shard_meshes builds them) and the kconfirm bench
    (kconf_bench.run: kconfirm and compact forced over KCONF_MB MiB iid
    with the 10k ruleset `db`), then the launch counts read; then the
    kernel bench at reduced depth (kernel_bench.run_benches over KBENCH_MB
    MiB, the literal benches with `db`: each kernel held against its
    plain version on the input it times, its timed launches added to the
    counts); then surface_kernel_checks on the inputs the phase gave the
    kernels."""
    from hyperscan_tpu_torch import graft_entry as GE
    from hyperscan_tpu_torch.parallel import SHARD_AXIS, Mesh
    from hyperscan_tpu_torch.tools import kconf_bench as KC
    from hyperscan_tpu_torch.tools import kernel_bench as KB

    out = {}
    T.reset_launches()
    fn, args = GE.entry(DEVICE)
    got = fn(*args)
    mesh = Mesh([torch.device(DEVICE, 0)] * SURFACE_SHARDS, (SHARD_AXIS,))
    out["dryrun"] = GE.dryrun_multichip(SURFACE_SHARDS, DEVICE, mesh=mesh)
    out["kconf"] = KC.run(db, KCONF_MB, KCONF_ITERS, "iid", KC.FAMILIES,
                          DEVICE)
    launches = dict(T.LAUNCHES)
    for k in ("dfa_scan_rows", "teddy_words_count", "teddy_kconfirm",
              "teddy_filter_compact", "teddy_hash_confirm"):
        check(launches[k] > 0, f"kernel {k} was not launched in phase 8")
    out["kbench"] = KB.run_benches(sizes_mb=KBENCH_MB, reps=KBENCH_REPS,
                                   device=DEVICE, clock_hz=clock_hz, db=db)
    for r in out["kbench"].values():
        for k, n in r["launches"].items():
            launches[k] += n
    out["launches"] = launches
    out["errs"], out["total"] = surface_kernel_checks(
        torch, T, db, args, got, out["dryrun"], out["kconf"])
    return out


def surface_kernel_checks(torch, T, db, args, got, dr, kconf):
    """Phase 8's kernels at the inputs the phase gave them, each against
    its plain version, exact:
    - entry(): its five outputs equal entry(device="cpu")'s, and kernel
      C's row mode equals dfa_scan_batch_plain on `args`;
    - the dry run (`dr`): kernel C's row mode on each shard's rows of
      the sharded DFA step; kernel 7 (count mode, words_check) on each
      shard's segment of the sharded filter count, with its look-back;
      the literal family's kernels (path_kernel_checks) on the
      unsharded product corpus and on each shard's blocks, dispatched
      again at the learned capacities (the family must be one the
      product path ran);
    - the kconfirm bench (`kconf`): the last timed scan of each family
      through path_kernel_checks (kernel 4; kernels A and B).
    The launches of these checks are not counted. Returns (the max abs
    error of each kernel, keyed as path_kernel_checks's and "words",
    "dfa_batch"; entry()'s match total)."""
    from hyperscan_tpu_torch import graft_entry as GE
    from hyperscan_tpu_torch.ops import dfa_kernel as DK
    from hyperscan_tpu_torch.ops import teddy_families as F
    from hyperscan_tpu_torch.ops import teddy_words as TW
    from hyperscan_tpu_torch.ops.dfa import (dfa_scan_batch,
                                             dfa_scan_batch_plain)
    from hyperscan_tpu_torch.parallel.sharded import (
        LOOKBACK, global_shard_arrays, pad_batch_for_mesh, partition_blocks,
        segments)
    from hyperscan_tpu_torch.runtime.scan import Scratch

    errs = {"dfa_batch": 0, "words": 0}

    def rows(a):
        a_k, f_k = dfa_scan_batch(*a)
        a_p, f_p = dfa_scan_batch_plain(*a)
        e = max(int((a_k - a_p).abs().max()), int((f_k - f_p).abs().max()))
        errs["dfa_batch"] = max(errs["dfa_batch"], e)
        return e

    def literal(lit, h, what):
        for k, v in path_kernel_checks(torch, T, lit, h, what).items():
            errs[k] = max(errs.get(k, 0), v)

    # entry() on the card against the CPU, its row mode against plain
    cfn, cargs = GE.entry("cpu")
    want = cfn(*cargs)
    check(all(torch.equal(g.cpu(), w) for g, w in zip(got, want)),
          "entry() on the card != entry(device='cpu')")
    check(int(want[0]) > 0, "entry() found no match")
    trans, b2c, acc, _eod, s0, data, lengths = args
    check(rows((trans, b2c, acc, s0, data, lengths)) == 0,
          "entry()'s row mode != its plain version")
    # the dry run's sharded DFA step, shard by shard
    mesh, n = dr["mesh"], SURFACE_SHARDS
    e = dr["engine"]
    tabs = DK.device_tables(e, DEVICE)
    data, lengths = pad_batch_for_mesh(GE.dfa_blocks(n), mesh, pad_len=128)
    for d, (d_t, l_t) in enumerate(global_shard_arrays(mesh, data,
                                                       lengths)):
        check(rows((tabs.trans.view(tabs.S, tabs.C), tabs.b2c, tabs.accept,
                    int(e.start_state), d_t, l_t)) == 0,
              f"the dry run's DFA shard {d}: row mode != plain version")
    # its sharded filter count, shard by shard
    lit = dr["literal_db"].lit
    ft, _ct = T.device_tables(lit, DEVICE)
    masks = T.mask_tables(lit.masks, DEVICE)
    corpus = GE.literal_corpus(n)
    cand = 0
    for lo, hi in segments(len(corpus), n):
        if hi <= lo:
            continue
        back = min(lo, LOOKBACK)
        part = torch.from_numpy(corpus[lo - back:hi].copy()).to(DEVICE)
        err, c = words_check(torch, T, TW, part, ft, masks, back)
        errs["words"] = max(errs["words"], err)
        cand += c
    check(cand == dr["teddy_count"], f"the dry run's filter count "
          f"{dr['teddy_count']} != the plain version's {cand}")
    # its product path: unsharded, then each shard's blocks, each at the
    # capacity scan_batch gives it
    pdb, blocks = dr["product_db"], dr["product_blocks"]
    ran = {k for k, v in F.family_state(pdb.lit).dispatches.items() if v}
    flat, starts, lens = T.flatten_blocks(blocks)
    cap = Scratch().capacity
    parts = [("unsharded", 0, len(flat), max(cap, 1 << 14))]
    for d, g in enumerate(partition_blocks(blocks, n)):
        if g:
            parts.append((f"shard {d}", int(starts[g[0]]),
                          int(starts[g[-1]] + lens[g[-1]]), cap))
    for what, lo, hi, c in parts:
        h = F.confirm_start(T.corpus_tensor(flat[lo:hi], DEVICE), pdb.lit,
                            hi - lo, c)
        check(h.family in ran, f"the dry run's product path ({what}): "
              f"dispatch family {h.family} is not one it ran "
              f"({sorted(ran)})")
        literal(pdb.lit, h, f"the dry run's product path, {what}")
    # the kconfirm bench's last timed scan of each family
    for fam, r in kconf.items():
        check(r["handle"].family == fam, f"the kconfirm bench's {fam} "
              f"scan ran {r['handle'].family}")
        literal(db.lit, r["handle"], f"the kconfirm bench, {fam}")
    return errs, int(want[0])


def log_surface(sf: dict, card: str) -> None:
    from hyperscan_tpu_torch.tools import kconf_bench as KC
    from hyperscan_tpu_torch.tools import kernel_bench as KB

    dr = sf["dryrun"]
    log(f"entry() on the card: {sf['total']} matches, its five outputs == "
        f"entry(device='cpu'), row mode == dfa_scan_batch_plain [{card}]")
    log(f"dryrun_multichip({SURFACE_SHARDS}) on {sorted(set(dr['devices']))}"
        f": DFA count {dr['count']} == gathered, teddy candidates "
        f"{dr['teddy_count']}, product path "
        f"{sum(map(len, dr['single']))} matches sharded == unsharded "
        f"[{card}]")
    for line in KB.report(sf["kbench"], card):
        log("kernel bench: " + line)
    log("phase-8 kernel checks on the phase's inputs (entry() row mode; "
        "the dry run's DFA shards, filter segments and product corpus; "
        "the kconfirm bench's last scan of each family): exact")
    pairs = [len(p) for p in sf["kconf"][KC.FAMILIES[0]]["pairs"]]
    log(f"kconfirm bench: verified pairs of {' and '.join(KC.FAMILIES)} "
        f"equal in every scan ({pairs})")


# the kernels line: each kernel, its source, the TPU kernel it replaces and
# its key in the checks' max abs errors
KERNELS = (
    ("teddy_filter_compact", "teddy_filter_compact.cu",
     "hyperscan_tpu/ops/teddy.py:1103", "compact"),
    ("teddy_hash_confirm", "teddy_hash_confirm.cu",
     "hyperscan_tpu/ops/teddy.py:1281", "confirm"),
    ("dfa_scan", "dfa_scan.cu", "hyperscan_tpu/ops/dfa_kernel.py:132",
     "dfa_scan"),
    ("dfa_scan_rows", "dfa_scan.cu", "hyperscan_tpu/ops/dfa.py:27",
     "dfa_batch"),
    ("nfa_layered", "nfa_layered.cu", "hyperscan_tpu/ops/nfa_kernel.py:476",
     "nfa_layered"),
    ("teddy_gate", "teddy_gate.cu", "hyperscan_tpu/ops/teddy.py:1381",
     "gate"),
    ("teddy_rescan_rows", "teddy_rescan_rows.cu",
     "hyperscan_tpu/ops/teddy.py:1424", "rescan"),
    ("teddy_kconfirm", "teddy_kconfirm.cu", "hyperscan_tpu/ops/teddy.py:1081",
     "kconfirm"),
    ("teddy_filter_plane", "teddy_filter_compact.cu",
     "hyperscan_tpu/ops/teddy.py:1116", "plane"),
    ("plane_extract", "plane_extract.cu", "hyperscan_tpu/ops/teddy.py:793",
     "extract"),
    ("teddy_words_count", "teddy_words.cu",
     "hyperscan_tpu/parallel/sharded.py:237", "words"),
    ("teddy_words_list", "teddy_words.cu", "hyperscan_tpu/ops/teddy.py:762",
     "words"),
    ("teddy_kconfirm_stage", "teddy_kconfirm.cu",
     "tools_probe_rank_bisect.py:163, tools_probe_kconf_split.py:128",
     "stage"),
)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    import hyperscan_tpu_torch as ht
    from hyperscan_tpu_torch.ops import _build
    from hyperscan_tpu_torch.ops import teddy as T

    card = nvidia_smi("name,power.limit")
    clock_hz = float(nvidia_smi("clocks.max.sm").split()[0]) * 1e6
    log(f"card: {card}; max SM clock {clock_hz / 1e6:.0f} MHz; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    errs = dict.fromkeys((k[3] for k in KERNELS), 0)

    def merge(more: dict) -> None:
        # a check's max abs errors into the kernels line's
        for k, e in more.items():
            errs[k] = max(errs[k], e)

    # phase 1: build
    t0 = time.perf_counter()
    took = _build.build()
    log(f"build: {time.perf_counter() - t0:.1f} s wall "
        f"({', '.join(f'{k} {v:.1f} s' for k, v in took.items())})")
    for name in _build.sources():
        ptxas = _build.library_path(name).with_suffix(".log")
        text = ptxas.read_text() if ptxas.exists() else ""
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {name}: {line.strip()}")

    # phase 2: kernel checks at 16 MB
    dbs = {}
    for n_pat in (100, 10_000):
        t0 = time.perf_counter()
        pats, ids = patterns(n_pat)
        db = ht.compile_multi(pats, ids=ids)
        check(db.lit is not None and not db.engines,
              "bench ruleset must be literal-routed")
        dbs[n_pat] = db
        log(f"compiled {n_pat} patterns in {time.perf_counter() - t0:.1f} s"
            f" (M={db.lit.masks.shape[0]}, W={db.lit.masks.shape[1]})")
    err_a, err_b = kernel_checks(torch, T, dbs)
    merge({"compact": err_a, "confirm": err_b})
    merge({"confirm": confirm_edge_cases(torch, T, ht)})

    # phase 2b: the engine kernels at 16 MB
    edbs = engine_dbs(ht)
    err_c, err_d = engine_kernel_checks(torch, edbs)
    merge({"dfa_scan": err_c, "nfa_layered": err_d})

    # phase 2c: the literal families' kernels at 16 MB and on a flood
    fdb = flood_db(ht)
    merge(family_kernel_checks(torch, T, dbs[10_000], fdb))

    # phase 2d: kernel 7 and the batch DFA scan at 16 MB
    merge(multi_kernel_checks(torch, T, dbs[10_000], edbs))

    # phase 2e: kernel 4's stage modes at 16 MB
    merge({"stage": stage_kernel_checks(torch, T, dbs[10_000])})

    # phase 3: the main path under the default family choice: 10k
    # ruleset, 512 MB, both corpus kinds; then the flood database
    db = dbs[10_000]
    check(T.device_tables(db.lit, DEVICE)[0].cmasks is not None,
          "the 10k ruleset's masks do not compress to class tables")
    T.reset_launches()
    runs, fams = {}, {}
    for kind in ("structured", "iid"):
        corpus, out, fams[kind] = main_path(ht, T, db, kind)
        runs[kind] = (corpus, out)
    flood = flood_main_path(ht, T, fdb)
    launches = {"main": dict(T.LAUNCHES)}
    log(f"main-path launches: {launches['main']}")
    for kind in runs:
        log(f"families per scan {kind}: {fams[kind]}")
    log(f"flood main path: {flood}")
    for k in ("teddy_filter_compact", "teddy_hash_confirm", "teddy_gate",
              "teddy_rescan_rows", "teddy_kconfirm", "teddy_filter_plane",
              "plane_extract"):
        check(launches["main"][k] > 0, f"kernel {k} was not launched on the "
              "main path")
    check(all(DEFAULT_FAMILY["structured"] in f for f in fams["structured"]),
          "a structured scan did not run the gated family")
    check(all(f == [DEFAULT_FAMILY["iid"]] for f in fams["iid"][1:]),
          "the repeated iid scan did not run the kconfirm family")
    hosts = {kind: host_prefix(db.lit, r[0]) for kind, r in runs.items()}
    for kind, (corpus, out) in runs.items():
        dev_n, host_n = prefix_differential(torch, T, db, corpus,
                                            hosts[kind])
        log(f"main path {kind}: {len(out)} matches, the repeat equal; 64 MB "
            f"prefix verified pairs device {dev_n} == host {host_n}")
        merge(main_kernel_checks(torch, T, db.lit, corpus,
                                 DEFAULT_FAMILY[kind], f"main path {kind}"))

    # phase 3c: each family forced in turn, 512 MB, both corpus kinds
    merge(forced_families(torch, ht, T, db, runs, hosts))

    # phase 3b: the engine path, one database per route, 256 MiB
    ecorpus = gen_engine_corpus(ENGINE_BYTES, 5)
    T.reset_launches()
    eruns = engine_path(ht, edbs, ecorpus)
    launches["engine"] = dict(T.LAUNCHES)
    log(f"engine-path launches: {launches['engine']}")
    for k in ("dfa_scan", "nfa_layered"):
        check(launches["engine"][k] > 0, f"kernel {k} was not launched on "
              "the engine path")
    ediff = engine_host_differential(ht, edbs, ecorpus)
    for (route, shape), n_match in eruns.items():
        log(f"engine path {route} {shape}: {n_match} matches, the repeat "
            f"equal; 32 MiB device == host ({ediff[(route, shape)]} "
            "matches)")
    err_c, err_d = engine_path_kernel_checks(torch, edbs, ecorpus)
    merge({"dfa_scan": err_c, "nfa_layered": err_d})

    # phase 3d: the multi-device path at full width, on the visible
    # cards and on four shards of one card
    sh = sharded_path(torch, ht, T, db, runs, edbs, ecorpus)
    launches["sharded"] = mlaunch = sh["launches"]
    log(f"sharded-path launches: {mlaunch}; literal families: "
        f"{sh['families']}")
    for k in ("teddy_words_count", "teddy_words_list", "dfa_scan_rows"):
        check(mlaunch[k] > 0, f"kernel {k} was not launched on the sharded "
              "path")
    filters = FAMILY_FILTERS
    check(sh["families"] and all(mlaunch[filters[f]] > 0
                                 for f in sh["families"]),
          f"the sharded literal path's families {sh['families']} did not "
          "launch their filter kernels")
    merge(sharded_checks(torch, ht, T, db, edbs, sh))

    # phase 3f: the multi-process mesh at 3d's width, two processes
    t3f = time.perf_counter()
    mp = multiprocess_path(
        torch, ht, T, db, edbs["bounded_dfa"][0],
        {kind: run[0] for kind, run in runs.items()}, ecorpus,
        {kind: {"lists": r["single"], "total": r["total"]}
         for kind, (r, _b) in sh["lit"].items()})
    log_multiprocess(mp, card)
    log(f"phase 3f {time.perf_counter() - t3f:.1f} s")
    del mp

    # phase 3e: streaming at full width
    t3e = time.perf_counter()
    st = streaming_path(torch, ht, T, db, edbs, ecorpus)
    slaunch = st["launches"]
    log(f"streaming-path launches: {slaunch}; literal families: "
        f"{st['families']}")
    check(st["families"] and all(slaunch[filters[f]] > 0
                                 for f in st["families"]),
          f"the streaming path's families {st['families']} did not launch "
          "their filter kernels")
    check(slaunch["dfa_scan"] > 0, "kernel dfa_scan was not launched on the "
          "streaming path")
    sn = streaming_checks(ht, db, edbs, st)
    # the path's kernels at the path's inputs, against their plain versions
    merge(path_kernel_checks(torch, T, st["sdb"].lit,
                             st["passes"][-1][3].dev_handle,
                             "StreamSet round"))
    merge({"dfa_scan": stream_dfa_checks(torch, st)})
    out, fams_, _ss, _h = st["passes"][-1]
    log(f"StreamSet {STREAMS} x {STREAM_WRITE} B, history {st['hreq']} B: "
        f"families per pipelined round {fams_}, "
        f"{sum(len(m) for rnd in out[2:] for m in rnd)} matches [{card}]")
    log(f"streaming checks: the first {CHECK_STREAMS} streams == host path "
        f"== block scans of their writes (matches {sn}), scan_streams(mesh=)"
        f" == unsharded on {list(st['mesh'])}, planted (StreamSet, "
        f"scan_streams) {sn['plants']} found; phase 3e "
        f"{time.perf_counter() - t3e:.1f} s")
    sdb = st["sdb"]
    del st

    # phase 3g: SOM on the card at full width (the SOM block ruleset over
    # both 512 MiB corpora, the SOM StreamSet), then the bench at reduced
    # depth
    t3g = time.perf_counter()
    corpora = {kind: run[0] for kind, run in runs.items()}
    sp = som_path(torch, ht, T, corpora)
    glaunch = sp["launches"]
    bfams = {kind: b[1] for kind, b in sp["block"].items()}
    som_fams = {f for fl in bfams.values() for fs in fl for f in fs}
    som_fams |= set(sp["stream_families"])
    log(f"SOM-path launches: {glaunch}; families per scan {bfams}, "
        f"StreamSet {sp['stream_families']}")
    check(som_fams and all(glaunch[filters[f]] > 0 for f in som_fams),
          f"the SOM path's families {sorted(som_fams)} did not launch their "
          "filter kernels")
    som_checks(ht, T, sp, corpora)
    # the path's kernels at the path's inputs: the last SOM block scan's
    # corpus (uploaded again, its family dispatched at the learned
    # capacities) and the last SOM round's extent tensor
    from hyperscan_tpu_torch.ops import teddy_families as F

    last = list(corpora)[-1]
    h = F.confirm_start(T.corpus_tensor(corpora[last], DEVICE),
                        sp["bdb"].lit, MAIN_BYTES)
    check([h.family] == bfams[last][-1], f"SOM block {last}: dispatch "
          f"family {h.family} != the last scan's {bfams[last][-1]}")
    merge(path_kernel_checks(torch, T, sp["bdb"].lit, h,
                             f"SOM block scan ({last})"))
    del h
    merge(path_kernel_checks(torch, T, sp["sdb"].lit,
                             sp["passes"][-1][3].dev_handle,
                             "SOM StreamSet round"))
    del sp
    br = bench_reduced(T, dbs[100], sdb)
    log(f"bench at reduced depth: run_config(100, {BENCH_MB} MiB x "
        f"{BENCH_ITERS}) {br['block_matches']} matches; "
        f"run_streamset({BENCH_STREAMS} streams x {BENCH_ROUNDS} rounds) "
        f"{br['stream_matches']} matches; launches {br['launches']}")
    del sdb
    log(f"phase 3g {time.perf_counter() - t3g:.1f} s")

    # phase 5: the differential tools on the card
    t5 = time.perf_counter()
    dt = differential_tools(T)
    log(f"hscollider on the card: {dt['battery']} expressions of "
        f"{BATTERY} (seed {BATTERY_SEED}), no diffs, "
        f"{dt['collider_s']:.1f} s; {FUZZ_ROUNDS} fuzz rounds (seed "
        f"{FUZZ_SEED}) consistent, {dt['fuzz_s']:.1f} s; launches "
        f"(collider) {dt['collider_launches']}, (fuzz) "
        f"{dt['fuzz_launches']}; phase 5 {time.perf_counter() - t5:.1f} s")
    # phase 6: Chimera on the card
    t6 = time.perf_counter()
    chm = chimera_path(T)
    log(f"Chimera on the card: {chm['matches']} matches ({chm['plants']} "
        f"planted) over {CHIMERA_BYTES} B equal the CPU's; launches "
        f"{chm['launches']}; phase 6 {time.perf_counter() - t6:.1f} s")
    # phase 7: the feature surface at full width
    t7 = time.perf_counter()
    fp = feature_path(torch, T, card)
    for r in fp["features"].values():
        merge(r["kernel_errs"])
    log(f"feature-phase launches: {fp['launches']}; phase 7 "
        f"{time.perf_counter() - t7:.1f} s")
    # phase 8: the graft entry points and the per-kernel benches
    t8 = time.perf_counter()
    sf = surface_path(torch, T, db, clock_hz)
    log_surface(sf, card)
    merge(sf["errs"])
    key = {k[0]: k[3] for k in KERNELS}
    for r in sf["kbench"].values():
        merge({key[k]: e for k, e in r["err"].items()})
    log(f"phase-8 launches: {sf['launches']}; phase 8 "
        f"{time.perf_counter() - t8:.1f} s")

    # phase 9: every kernel with its max abs error over every check of the
    # run and its launches in each counted phase
    launches.update(som=glaunch, bench=br["launches"],
                    features=fp["launches"], surface=sf["launches"])
    kernels = [{"name": name, "route": "cuda",
                "source": f"hyperscan_tpu_torch/csrc/{source}",
                "replaces": replaces, "max_abs_err": errs[k],
                "launches": {ph: n.get(name, 0)
                             for ph, n in launches.items()}}
               for name, source, replaces, k in KERNELS]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-worker"]:
        sys.exit(mesh_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                             int(sys.argv[5])))
    if sys.argv[1:] == ["--mesh-only"]:
        sys.exit(mesh_only())
    sys.exit(main())
