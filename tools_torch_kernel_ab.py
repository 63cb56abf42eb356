"""Times the port's filter-loop kernels, its DFA scans and kernel D, for two
checkouts of the port compared on one card.

The kernels that share the Teddy filter loop (csrc/teddy_filter.cuh) at
the literal main path's shape (the 10k bench ruleset over 512 MiB iid):
kernel A in compact and plane mode, the gate, the survivor-row rescan
(over iid, over the structured corpus and over one StreamSet round's
16,384 extents, with the gate's row counts where the checkout's
`rescan_rows` takes them), the extraction (`plane_extract`, over kernel
A's iid plane and over a plane with 5% of its bytes nonzero), kernel 4
(kconfirm) at stages 0-3, kernel 7 in count and list mode and
both in turn (over the structured corpus too), and `teddy_scan_tensor`
(count, cumsum, list and the fetch of the candidates); kernel C's
chunk scan (records mode) with the bounded bench DFA over 256 MiB as one
block and as 16,384 x 16 KiB blocks, with its tables in shared and in
global memory, and the two speculative routes (H = 0: the unbounded DFA,
the cyclic NFA's lazy-DFA core) over the 256 MiB block;
`dfa_scan_batch` with the bounded bench DFA over 16,384 x 16 KiB rows
(the sharded DFA path's batch), over 4,096 of them (one shard of four)
and over 32 (a single warp of rows: the serial chain alone); and both
DFA modes (the chunk scan over the 256 MiB block, the row mode over the
16,384 rows) with larger bounded DFAs (S x C from 3,072 to 12,288), their
tables forced into shared and into global memory; kernel B (the hash
confirm) at the main path's inputs over 512 MiB iid and structured and
over one StreamSet round's extents (candidates from kernel A's compact
mode, capc 256; cap2 the next power of two past the pair total): the
wrapper as the literal path calls it, the kernel's entry alone on a
counter zeroed once (with room for every call's pairs), the launch
floor (both over a list of -1s), and
`torch.zeros(1)` alone (the parent's fill of the counter); and
(`--part e2e`, not in `all`) the literal main path and the streaming path
end to end as the checkout's own chip_smoke.py runs them (phases 3 and
3e: GB/s of each timed scan, StreamSet pass and scan_streams round; the
stage seconds of three literal scans a corpus, as chip_smoke.py's
breakdown takes them, and of the StreamSet round). Each time
is the mean of CUDA events over `--reps` calls after a warm-up call, the
calls queued behind a spin of the card so that a kernel shorter than its
host-side launch is timed on the card, not at the host's pace.
Only calls that the port has had since its kernel 7 and batch scan
existed are used (kernel 7's list mode takes the per-segment counts
where the checkout's count mode has them, its per-cell counts before),
so a parent checkout can be timed by the same script.

Usage, on a machine with a CUDA card:

    python3 tools_torch_kernel_ab.py [--root DIR] [--db FILE] [--reps 10]
                                     [--part all|literal|dfa|nfa|engines|
                                             confirm|e2e]

`--root` is the checkout whose `hyperscan_tpu_torch` is timed (this one by
default; its kernels are built there); `--db` caches the serialized 10k
database (made when missing), so runs over two checkouts compile it once;
`--part literal` times only the Teddy kernels, `--part dfa` only the DFA
scans, `--part nfa` only kernel D, `--part confirm` only kernel B (50
calls a time); `--part engines` (not in `all`) times
the engine path end to end instead, as the checkout's chip_smoke.py runs
it. Prints one JSON line: the card's name and power limit, the build
seconds, and each kernel's ms (or each engine route's GB/s).
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys
import time

import numpy as np

LARGE_DFA_K = (8, 9, 10)  # S x C = 3,072, 6,144, 12,288
# a spin of the card (~10 ms) that the timed calls queue behind
QUEUE_CYCLES = 20_000_000
DENSE_PLANE = 0.05  # nonzero share of the extraction's dense plane
# kernel D's engines: name -> (pattern, Grey tunables); kept here, not
# read from chip_smoke.py, which a parent checkout's copy may lack
NFA_ENGINES = {
    "bench": (r".*a.{18}b", {}),
    "p62": (r".*a.{60}b", {"max_dfa_states": 8}),
    "many_class": (r".*[a-c]x[d-f]y[g-i]z[j-l]w[m-o]v[p-r]u[s-t]q0[1-2]1"
                   r"[3-4]2[5-6]3[7-8]4[9A]5[B-C]6[D-E]7[F-G]8[H-I]9[J-K]A"
                   r"[L-M]B[N-O]C[P-Q]D[R-S]E.{3}[T-U]",
                   {"max_dfa_states": 8, "allow_teddy": False}),
    "p502": (r".*a.{500}b", {"max_dfa_states": 8}),
}
# one match of the 45-class engine, planted every 65,537 bytes
MANY_CLASS_PLANT = b"axdygzjwmvpusq01132537495B6D7F8H9JALBNCPDREzzzT"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(
        __file__)))
    ap.add_argument("--db", default=None)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--part", choices=("all", "literal", "dfa", "nfa",
                                       "engines", "confirm", "e2e"),
                    default="all")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import torch

    if not torch.cuda.is_available():
        print("tools_torch_kernel_ab: no CUDA card", file=sys.stderr)
        return 1
    import hyperscan_tpu_torch as ht
    from hyperscan_tpu_torch.ops import _build
    from hyperscan_tpu_torch.ops import dfa as D
    from hyperscan_tpu_torch.ops import dfa_kernel as DK
    from hyperscan_tpu_torch.ops import extract as X
    from hyperscan_tpu_torch.ops import teddy as T
    from hyperscan_tpu_torch.ops import teddy_gate as G
    from hyperscan_tpu_torch.ops import teddy_kconfirm as K
    from hyperscan_tpu_torch.ops import teddy_words as TW
    from hyperscan_tpu_torch.database import compile_patterns
    from hyperscan_tpu_torch.grey import Grey
    from hyperscan_tpu_torch.runtime.stream import history_required
    from hyperscan_tpu_torch.tools.benchdata import (gen_corpus, patterns,
                                                     stream_extents)
    import chip_smoke as CS

    assert os.path.dirname(ht.__file__).startswith(root)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = "cuda"
    t0 = time.perf_counter()
    _build.build()
    build_s = time.perf_counter() - t0

    def ms_n(fn, reps):
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

    def ms(fn):
        return ms_n(fn, args.reps)

    def ms_or_error(fn):
        # a placement a checkout refuses for a DFA this large is reported
        try:
            return ms(fn)
        except (RuntimeError, ValueError) as e:
            return f"error: {e}"

    out = {}

    def bench_db():
        if args.db and os.path.exists(args.db):
            with open(args.db, "rb") as f:
                return ht.deserialize_database(f.read())
        pats, ids = patterns(10_000)
        db = ht.compile_multi(pats, ids=ids)
        if args.db:
            with open(args.db, "wb") as f:
                f.write(ht.serialize_database(db))
        return db

    def literal():
        """The filter-loop kernels and kernel 7 over 512 MiB; returns
        kernel 7's candidate count over the iid corpus."""
        db = bench_db()
        lit = db.lit
        corpus = gen_corpus(512 << 20, 2, "iid")
        ct = T.corpus_tensor(corpus, dev)
        ft, _ct = T.device_tables(lit, dev)
        gt = G.device_gate_table(lit, dev)
        kt = K.confirm_planes(lit, dev)
        # kernel 7's tables, made by this checkout's own function
        make_words = (getattr(T, "mask_tables", None)
                      or getattr(TW, "word_tables", None) or TW.masks_tensor)
        wt = make_words(lit.masks, dev)

        out["compact"] = ms(lambda: T.filter_compact(ct, ft, 256,
                                                     use_classes=True))
        out["plane"] = ms(lambda: T.filter_plane(ct, ft, use_classes=True))
        out["gate"] = ms(lambda: G.gate_rows(ct, gt))
        # the rescan as the checkout's gated family calls it: with the
        # gate's row counts where its rescan_rows takes them
        counted = "row_counts" in inspect.signature(
            G.rescan_rows).parameters

        def rescan(corpus_t, tag):
            flags, k = G.gate_rows(corpus_t, gt)
            kw = {"row_counts": k} if counted else {}
            out[f"rescan{tag}"] = ms(lambda: G.rescan_rows(
                corpus_t, ft, flags, 256, **kw))
            if counted:
                out[f"rescan{tag} without counts"] = ms(
                    lambda: G.rescan_rows(corpus_t, ft, flags, 256))

        rescan(ct, "")
        sct = T.corpus_tensor(gen_corpus(512 << 20, 1, "structured"), dev)
        out["gate structured"] = ms(lambda: G.gate_rows(sct, gt))
        rescan(sct, " structured")
        del sct
        # one StreamSet round's extents (chip_smoke.py phase 3e's shape)
        sdb = ht.deserialize_database(ht.serialize_database(db))
        sdb.mode = ht.HS_MODE_STREAM
        ext = stream_extents(CS.STREAMS, CS.STREAM_WRITE,
                             history_required(sdb), 2)
        rescan(torch.from_numpy(ext).to(dev), " streamset round")
        # the extraction over kernel A's iid plane and a dense plane
        plane = T.filter_plane(ct, ft, use_classes=True)
        n = ct.numel()
        cap1 = T._p2(max(1, int(plane.sum())))
        out["extract"] = ms(lambda: X.plane_extract(plane, n, cap1))
        g = torch.Generator(device=dev).manual_seed(9)
        plane = (torch.rand(plane.numel(), generator=g, device=dev)
                 < DENSE_PLANE).to(torch.uint8)
        cap1 = T._p2(int(plane.sum()))
        out["extract dense"] = ms(lambda: X.plane_extract(plane, n, cap1))
        del plane
        for s in (0, 1, 2, 3):
            out[f"kconfirm stage {s}"] = ms(lambda: K.filter_kconfirm(
                ct, ft, kt, use_classes=True, stage=s))
        segmented = hasattr(TW, "segment_counts")

        def words(corpus_t, tag):
            if segmented:
                cnt, lst = TW.filter_words_count(corpus_t, wt, segments=True)
            else:
                cnt = lst = TW.filter_words_count(corpus_t, wt)
            total = int(cnt.long().sum())
            out[f"words count{tag}"] = ms(lambda: TW.filter_words_count(
                corpus_t, wt))
            out[f"words list{tag}"] = ms(lambda: TW.filter_words_list(
                corpus_t, wt, lst, max(1, total)))

            def count_list():
                if segmented:
                    _c, segs = TW.filter_words_count(corpus_t, wt,
                                                     segments=True)
                else:
                    segs = TW.filter_words_count(corpus_t, wt)
                return TW.filter_words_list(corpus_t, wt, segs,
                                            max(1, total))

            out[f"words count+list{tag}"] = ms(count_list)
            out[f"teddy_scan{tag}"] = ms(lambda: TW.teddy_scan_tensor(
                corpus_t, wt, max(1, total)))
            return total

        total = words(ct, "")
        if segmented:  # the byte-table route, forced
            out["words count bytes"] = ms(lambda: TW.filter_words_count(
                ct, wt, use_classes=False))
        del ct
        words(T.corpus_tensor(gen_corpus(512 << 20, 1, "structured"), dev),
              " structured")
        return total

    def dfa():
        """Kernel C's chunk scan and row mode over 256 MiB."""
        edbs = CS.engine_dbs(ht)
        ecorpus = CS.gen_engine_corpus(CS.ENGINE_BYTES, 5)
        for route in ("bounded_dfa", "unbounded_dfa", "cyclic_nfa"):
            e = edbs[route][0].engines[0]
            d = e.spec_dfa if route == "cyclic_nfa" else e
            H, cs = DK.chunk_shape(d) if route == "bounded_dfa" else \
                (0, DK.SPEC_CS)
            shapes = ("one_block", "blocks_16k") if route == "bounded_dfa" \
                else ("one_block",)
            for shape in shapes:
                lens = [len(b) for b in CS.engine_blocks(ecorpus, shape)]
                corpus_t, tabs, meta, _p, _s, _l = CS.chunk_inputs(
                    torch, d, ecorpus, lens, H, cs,
                    np.full(len(lens), d.start_state))
                _r, tot, _f = DK.dfa_scan_chunks(corpus_t, tabs, meta, H, 1)
                cap = max(1, int(tot))
                for placement in ("shared", "global"):
                    out[f"dfa_scan {route} {shape} {placement}"] = ms(
                        lambda: DK.dfa_scan_chunks(
                            corpus_t, tabs, meta, H, cap,
                            placement=placement))
                del corpus_t
        eng = edbs["bounded_dfa"][0].engines[0]
        tabs = DK.device_tables(eng, dev)
        rows = CS.ENGINE_BYTES // CS.ENGINE_BLOCK
        d_t, l_t, _i = CS.dfa_batch_inputs(torch, eng, ecorpus, rows, 7)
        # larger bounded DFAs (a[^\n]{k}b: S = 3 x 2^k states, C = 4), both
        # placements forced, in the chunk scan over the 256 MiB block and in
        # the row mode over the 16,384 rows: where each mode's shared tables
        # stop paying
        for k in LARGE_DFA_K:
            big = compile_patterns([r"a[^\n]{%d}b" % k], [0], grey=Grey(
                allow_teddy=False)).engines[0]
            H, cs = DK.chunk_shape(big)
            corpus_t, btabs, meta, _p, _s, _l = CS.chunk_inputs(
                torch, big, ecorpus, [len(ecorpus)], H, cs,
                np.full(1, big.start_state))
            _r, tot, _f = DK.dfa_scan_chunks(corpus_t, btabs, meta, H, 1,
                                             placement="global")
            cap = max(1, int(tot))
            tag = f"S*C={btabs.S * btabs.C}"
            for placement in ("shared", "global"):
                out[f"dfa_scan {tag} {placement}"] = ms_or_error(
                    lambda: DK.dfa_scan_chunks(corpus_t, btabs, meta, H, cap,
                                               placement=placement))
                out[f"dfa_scan_rows {tag} {placement}"] = ms_or_error(
                    lambda: D.dfa_scan_rows(btabs, big.start_state, d_t, l_t,
                                            placement=placement))
            del corpus_t
        args_ = (tabs.trans.view(tabs.S, tabs.C), tabs.b2c, tabs.accept,
                 int(eng.start_state))
        out["dfa_scan_batch"] = ms(lambda: D.dfa_scan_batch(*args_, d_t, l_t))
        for q in (rows // 4, 32):  # one shard of four; one warp of rows
            out[f"dfa_scan_batch {q} rows"] = ms(
                lambda: D.dfa_scan_batch(*args_, d_t[:q], l_t[:q]))

    def nfa():
        """Kernel D over 256 MiB, one block and 16,384 blocks, each engine
        held exact against the plain version before it is timed."""
        from hyperscan_tpu_torch.ops import nfa_kernel as NK

        ecorpus = CS.gen_engine_corpus(CS.ENGINE_BYTES, 5)
        p = np.frombuffer(MANY_CLASS_PLANT, np.uint8)
        for off in range(1000, len(ecorpus) - 64, 65_537):
            ecorpus[off:off + len(p)] = p
        corpus_t = torch.from_numpy(ecorpus).to(dev)
        for name, (pat, grey) in NFA_ENGINES.items():
            eng = compile_patterns([pat], [0], grey=Grey(**grey)).engines[0]
            plan = NK.device_plan(eng, dev)
            for shape in ("one_block", "blocks_16k"):
                lens = [len(b) for b in CS.engine_blocks(ecorpus, shape)]
                starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
                bs, be, ba, _ne = NK.block_bounds(
                    starts, lens, np.ones(len(lens), bool), dev)
                cap = 1 << 22
                rk, tk, ek = NK.nfa_layered(corpus_t, plan, bs, be, ba, cap)
                rp, tp, ep = NK.nfa_layered_plain(corpus_t, plan, bs, be, ba,
                                                  cap)
                k = int(tp)
                same = int(tk) == k <= cap and torch.equal(ek, ep) and \
                    torch.equal(*(r[:k].long()[torch.argsort(r[:k, 0])]
                                  for r in (rk, rp)))
                if not same:
                    raise SystemExit(f"kernel D {name} {shape} != plain")
                cap = max(1, k)
                out[f"nfa_layered {name} {shape}"] = ms(
                    lambda: NK.nfa_layered(corpus_t, plan, bs, be, ba, cap))
                out[f"nfa_layered {name} {shape} records"] = k
                del rk, rp

    def engines():
        """The engine path end to end, as the checkout's own chip_smoke.py
        runs it (phase 3b): each route through scan_batch over 256 MiB as
        one block and as 16,384 blocks, GB/s over the mean timed scan."""
        ecorpus = CS.gen_engine_corpus(CS.ENGINE_BYTES, 5)
        runs = CS.engine_path(ht, CS.engine_dbs(ht), ecorpus)
        for (route, shape), (_n, _warm_s, times) in runs.items():
            out[f"engine path {route} {shape} GB/s"] = \
                CS.ENGINE_BYTES / (sum(times) / len(times)) / 1e9

    def confirm():
        """Kernel B at the main path's inputs: 512 MiB iid and structured,
        one StreamSet round's extents."""
        db = bench_db()
        ft, ctab = T.device_tables(db.lit, dev)
        lib = T._confirm_lib()
        # the kernel's entry alone: the tree's launch entry, the parent's
        # only entry (which launched nothing but the kernel)
        alone = getattr(lib, "hs_teddy_hash_confirm_launch", None) \
            or lib.hs_teddy_hash_confirm
        stream = torch.cuda.current_stream().cuda_stream
        out["torch.zeros(1)"] = ms_n(lambda: torch.zeros(
            1, dtype=torch.int32, device=dev), 50)
        sdb = ht.deserialize_database(ht.serialize_database(db))
        sdb.mode = ht.HS_MODE_STREAM
        inputs = (
            ("iid", lambda: T.corpus_tensor(gen_corpus(512 << 20, 2, "iid"),
                                            dev)),
            ("structured", lambda: T.corpus_tensor(
                gen_corpus(512 << 20, 1, "structured"), dev)),
            ("streamset round", lambda: torch.from_numpy(stream_extents(
                CS.STREAMS, CS.STREAM_WRITE, history_required(sdb),
                2)).to(dev)))
        for tag, make in inputs:
            corpus_t = make()
            pos_c, cnt = T.filter_compact(corpus_t, ft, 256, use_classes=True)
            cand = int(cnt.long().sum())
            cap1 = T._p2(max(1, cand))
            _meta1, pos = T.compact_combine(pos_c, cnt, 256, cap1)
            _p, tot = T.hash_confirm_plain(corpus_t, pos, ctab, 1)
            k = int(tot)
            cap2 = T._p2(k + 1)
            none = torch.full_like(pos, -1)
            # the entry alone runs on a counter zeroed once: room for the
            # pairs of every call (ms_n makes 51), so each writes them all
            cap_t = 51 * max(k, 1)
            pairs = torch.empty((cap_t, 2), dtype=torch.int32, device=dev)
            total = torch.zeros(1, dtype=torch.int32, device=dev)

            def launch(p):
                rc = alone(corpus_t.data_ptr(), corpus_t.numel(),
                           p.data_ptr(), p.numel(), ctab.meta.data_ptr(),
                           len(ctab.groups), ctab.slots.data_ptr(),
                           pairs.data_ptr(), cap_t, total.data_ptr(), stream)
                if rc:
                    raise SystemExit(f"kernel B launch failed: {rc}")

            got, gt = T.hash_confirm(corpus_t, pos, ctab, cap2)
            want, wt = T.hash_confirm_plain(corpus_t, pos, ctab, cap2)
            keys = [torch.sort((x[:k, 1].long() << 20) | x[:k, 0]).values
                    for x in (got, want)]
            if int(gt) != k or not torch.equal(*keys):
                raise SystemExit(f"kernel B {tag} != plain")
            out[f"confirm {tag} inputs"] = {"candidates": cand, "cap1": cap1,
                                            "pairs": k, "cap2": cap2}
            out[f"confirm {tag} wrapper"] = ms_n(lambda: T.hash_confirm(
                corpus_t, pos, ctab, cap2), 50)
            out[f"confirm {tag} kernel"] = ms_n(lambda: launch(pos), 50)
            torch.cuda.synchronize()
            if int(total) != 51 * k:
                raise SystemExit(f"kernel B {tag}: timing calls lost pairs")
            out[f"confirm {tag} floor"] = ms_n(lambda: T.hash_confirm(
                corpus_t, none, ctab, cap2), 50)
            out[f"confirm {tag} floor kernel"] = ms_n(lambda: launch(none),
                                                      50)
            del corpus_t

    def e2e():
        """The literal main path (both corpora) and the streaming path,
        end to end, as the checkout's chip_smoke.py runs them."""
        db = bench_db()
        for kind in ("structured", "iid"):
            corpus, _o, _w, times, _f = CS.main_path(ht, T, db, kind)
            out[f"literal {kind} GB/s"] = [CS.MAIN_BYTES / t / 1e9
                                           for t in times]
            out[f"literal {kind} stages"] = [
                CS.breakdown(torch, T, db, corpus) for _ in range(3)]
            del corpus
        st = CS.streaming_path(torch, ht, T, db, CS.engine_dbs(ht),
                               CS.gen_engine_corpus(CS.ENGINE_BYTES, 5))
        vol = CS.STREAMS * CS.STREAM_WRITE * CS.STREAM_ROUNDS
        out["streamset GB/s"] = [vol / p_[1] / 1e9 for p_ in st["passes"]]
        out["streamset round stages"] = st["round_stages"]
        _o, sc_times, _w = st["sc"]
        out["scan_streams GB/s"] = [CS.SCAN_STREAMS * CS.STREAM_WRITE / t
                                    / 1e9 for t in sc_times]

    total = literal() if args.part in ("all", "literal") else None
    if args.part == "confirm":
        confirm()
    if args.part == "e2e":
        e2e()
    if args.part in ("all", "dfa"):
        dfa()
    if args.part in ("all", "nfa"):
        nfa()
    if args.part == "engines":
        engines()
    print(json.dumps({"root": root, "card": card, "build_s": build_s,
                      "candidates": total, "ms": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
