"""Times the port's filter-loop kernels and its batch DFA scan, for two
checkouts of the port compared on one card.

The kernels that share the Teddy filter loop (csrc/teddy_filter.cuh) at
the literal main path's shape (the 10k bench ruleset over 512 MiB iid):
kernel A in compact and plane mode, the gate, the survivor-row rescan,
kernel 4 (kconfirm) at stages 0-3, kernel 7 in count and list mode; and
`dfa_scan_batch` with the bounded bench DFA over 16,384 x 16 KiB rows
(the sharded DFA path's batch), over 4,096 of them (one shard of four)
and over 32 (a single warp of rows: the serial chain alone). Each time is the mean of CUDA events over `--reps` calls after a
warm-up call. Only calls that the port has had since its kernel 7 and
batch scan existed are used, so a parent checkout can be timed by the
same script.

Usage, on a machine with a CUDA card:

    python3 tools_torch_kernel_ab.py [--root DIR] [--db FILE] [--reps 10]

`--root` is the checkout whose `hyperscan_tpu_torch` is timed (this one by
default; its kernels are built there); `--db` caches the serialized 10k
database (made when missing), so runs over two checkouts compile it once.
Prints one JSON line: the card's name and power limit, the build seconds,
and each kernel's ms.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(
        __file__)))
    ap.add_argument("--db", default=None)
    ap.add_argument("--reps", type=int, default=10)
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
    from hyperscan_tpu_torch.ops import teddy as T
    from hyperscan_tpu_torch.ops import teddy_gate as G
    from hyperscan_tpu_torch.ops import teddy_kconfirm as K
    from hyperscan_tpu_torch.ops import teddy_words as TW
    from hyperscan_tpu_torch.tools.benchdata import gen_corpus, patterns
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
    if args.db and os.path.exists(args.db):
        with open(args.db, "rb") as f:
            db = ht.deserialize_database(f.read())
    else:
        pats, ids = patterns(10_000)
        db = ht.compile_multi(pats, ids=ids)
        if args.db:
            with open(args.db, "wb") as f:
                f.write(ht.serialize_database(db))
    lit = db.lit
    corpus = gen_corpus(512 << 20, 2, "iid")
    ct = T.corpus_tensor(corpus, dev)
    ft, _ct = T.device_tables(lit, dev)
    gt = G.device_gate_table(lit, dev)
    kt = K.confirm_planes(lit, dev)
    # the byte tables of kernel 7, made by this checkout's own function
    make_words = getattr(TW, "word_tables", None) or TW.masks_tensor
    wt = make_words(lit.masks, dev)

    def ms(fn):
        fn()
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(args.reps):
            fn()
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / args.reps

    out = {}
    out["compact"] = ms(lambda: T.filter_compact(ct, ft, 256,
                                                 use_classes=True))
    out["plane"] = ms(lambda: T.filter_plane(ct, ft, use_classes=True))
    out["gate"] = ms(lambda: G.gate_rows(ct, gt))
    flags, _k = G.gate_rows(ct, gt)
    out["rescan"] = ms(lambda: G.rescan_rows(ct, ft, flags, 256))
    for s in (0, 1, 2, 3):
        out[f"kconfirm stage {s}"] = ms(lambda: K.filter_kconfirm(
            ct, ft, kt, use_classes=True, stage=s))
    cnt = TW.filter_words_count(ct, wt)
    total = int(cnt.long().sum())
    out["words count"] = ms(lambda: TW.filter_words_count(ct, wt))
    out["words list"] = ms(lambda: TW.filter_words_list(ct, wt, cnt,
                                                        max(1, total)))
    del ct, flags, cnt
    eng = CS.engine_dbs(ht)["bounded_dfa"][0].engines[0]
    tabs = DK.device_tables(eng, dev)
    rows = CS.ENGINE_BYTES // CS.ENGINE_BLOCK
    d_t, l_t, _i = CS.dfa_batch_inputs(
        torch, eng, CS.gen_engine_corpus(CS.ENGINE_BYTES, 5), rows, 7)
    args_ = (tabs.trans.view(tabs.S, tabs.C), tabs.b2c, tabs.accept,
             int(eng.start_state))
    out["dfa_scan_batch"] = ms(lambda: D.dfa_scan_batch(*args_, d_t, l_t))
    for q in (rows // 4, 32):  # one shard of four; one warp of rows
        out[f"dfa_scan_batch {q} rows"] = ms(
            lambda: D.dfa_scan_batch(*args_, d_t[:q], l_t[:q]))
    print(json.dumps({"root": root, "card": card, "build_s": build_s,
                      "candidates": total, "ms": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
