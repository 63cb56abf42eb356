"""Stage probe of kernel 4, the kconfirm filter with its in-kernel confirm:
where does a kconfirm scan spend its time?

The counterpart of the JAX package's stage-bisect probes
(tools_probe_kconf_split.py, tools_probe_rank_bisect.py). Over one
corpus it times, on the card:

- "D plane": kernel A's plane mode, the bare filter without any confirm;
- "stage 0" .. "stage 2": kernel 4 cut after the candidate count, after
  the tail bytes and hashes, and after the bucket-row compares
  (`ops.teddy_kconfirm.filter_kconfirm(..., stage=s)`);
- "stage 3": the full kernel;
- "B stage 3 + combine": the full kernel and `kconf_combine`;
- "C end to end": `confirm_start` / `confirm_fetch_many` /
  `confirm_finish` with the kconfirm family forced, host stages included.

Before they are timed, stages 0-2 are held against their plain versions
on the probe's corpus (candidate counts, checksums, match counts); a
difference raises, so the tool exits non-zero. Kernel times are
CUDA-event means after one warm-up call, queued behind a spin of the
card (`kernel_bench.time_ms`); the end-to-end time is the kconfirm
bench's forced-family loop (`kconf_bench.run_family`), wall-clock. Every
line gives ms and GB/s of corpus; the plane mode's and the stages' lines
also their bound (`kernel_bench.lit_bound`) and stages 0-2 their plain
versions' ms.

It first prints the fill of kernel 4's bucket rows per confirm group
(`--fills` stops there, and needs no card).

Usage, on a machine with a CUDA card:

    python3 tools_torch_probe_kconfirm.py [--mb 512] [--reps 10] [--fills]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from .benchdata import gen_corpus, patterns
from .kconf_bench import WARM, run_family
from .kernel_bench import (H100_SM_CLOCK_HZ, check, lit_bound, nvidia_smi,
                           time_ms)

STAGE_NAMES = ("D plane", "stage 0", "stage 1", "stage 2", "stage 3",
               "B stage 3 + combine", "C end to end")


def stage_times(db, corpus: np.ndarray, reps: int = 10, device="cuda",
                clock_hz=None) -> dict:
    """ms of each probe variant (STAGE_NAMES) over `corpus` with the
    literal database `db`, stages 0-2 first held against their plain
    versions there (exact), and what they counted: the candidates, the
    matches, and the families the end-to-end scans ran; the bounds of the
    plane mode and of stages 0-3 (per candidate and group ~20 hash
    operations; from stage 2 on also one 256-byte row read and 128
    signature compares) and the plain versions' ms of stages 0-2. The
    database's learned capacities come from the end-to-end loop's warm
    scans."""
    import torch

    from ..ops import teddy as T
    from ..ops import teddy_families as F
    from ..ops import teddy_kconfirm as K
    from ..ops._build import LAUNCHES
    from ..runtime.scan import resolve_device

    device = resolve_device(device)
    lit = db.lit
    corpus_t = T.corpus_tensor(corpus, device)
    ft, _ct = T.device_tables(lit, device)
    kt = K.confirm_planes(lit, device)
    if kt is None:
        raise ValueError("the database has no kconfirm tables")
    uc = ft.cmasks is not None
    e2e = run_family(db, [corpus_t] * (WARM + reps), [corpus] * (WARM + reps),
                     reps, "kconfirm")
    cap2 = F._caps_for(lit, 1 << 14)[2]

    def kc(stage):
        return K.filter_kconfirm(corpus_t, ft, kt, use_classes=uc,
                                 stage=stage)

    plain_ms = {}
    before = LAUNCHES["teddy_kconfirm_stage"]
    for s in K.STAGES[:3]:
        k = kc(s)
        p = K.filter_kconfirm_stage_plain(corpus_t, ft, kt, use_classes=uc,
                                          stage=s)
        check(all(torch.equal(a.long(), b.long()) for a, b in zip(k, p)),
              f"kernel 4 stage {s} at {corpus_t.numel()} bytes != plain "
              "version")
        plain_ms[f"stage {s}"] = time_ms(
            torch, lambda: K.filter_kconfirm_stage_plain(
                corpus_t, ft, kt, use_classes=uc, stage=s), 1, device)
    check(not corpus_t.is_cuda or LAUNCHES["teddy_kconfirm_stage"] > before,
          "the stage probe launched no stage mode")
    out = {"D plane": time_ms(torch, lambda: T.filter_plane(
        corpus_t, ft, use_classes=uc), reps, device)}
    for s in K.STAGES:
        out[f"stage {s}"] = time_ms(torch, lambda: kc(s), reps, device)
    out["B stage 3 + combine"] = time_ms(
        torch, lambda: K.kconf_combine(*kc(3), cap2), reps, device)
    out["C end to end"] = e2e["s_per_scan"] * 1e3
    cand, conf, _pos, _cls = kc(3)
    n, groups = corpus_t.numel(), len(kt.groups)
    n_cells = T._n_cells(n)
    c_g = int(cand.long().sum()) * groups
    lookups = n * ft.M * ft.W
    bound = lit_bound(clock_hz or H100_SM_CLOCK_HZ)
    bounds = {
        "D plane": bound(n + T.plane_len(n), lookups),
        "stage 0": bound(n + 12 * n_cells, lookups),
        "stage 1": bound(n + 12 * n_cells, lookups, c_g * 20),
        "stage 2": bound(n + c_g * 256 + 12 * n_cells, lookups,
                         c_g * (20 + 128)),
        "stage 3": bound(n + c_g * 256 + n_cells * (2 + 2 * K.CAPC2) * 4,
                         lookups, c_g * (20 + 128)),
    }
    return {"ms": out, "candidates": int(cand.long().sum()),
            "matches": int(conf.long().sum()), "families": [e2e["family"]],
            "n_bytes": len(corpus), "groups": groups, "classes": uc,
            "bounds": bounds, "plain_ms": plain_ms}


def row_fills(lit) -> list:
    """The fill of kernel 4's bucket rows (`confirm_planes`' tables, read
    on the CPU), one dict per confirm group: its tail length cl, rows,
    entries, and the mean, median, 90th percentile and largest fill of
    its rows (each row holds 128 slots)."""
    import torch

    from ..ops import teddy_kconfirm as K

    kt = K.confirm_planes(lit, "cpu")
    out = []
    for (cl, _mlo, _mhi, t_rows, base) in (kt.groups if kt else ()):
        f = kt.fills[base // 128:base // 128 + t_rows].double()
        out.append({"cl": cl, "rows": t_rows, "entries": int(f.sum()),
                    "mean": float(f.mean()), "p50": float(f.median()),
                    "p90": float(torch.quantile(f, 0.9)),
                    "max": int(f.max())})
    return out


def report(res: dict, card: str) -> list:
    """One line per variant: ms and GB/s of corpus, the bound and the
    plain version's ms where the variant has them, with the card."""
    n = res["n_bytes"]
    lines = []
    for name, ms in res["ms"].items():
        more = ""
        if name in res["bounds"]:
            b = res["bounds"][name]
            more += (f"  bound {b['bound_ms']:.3f} ms ({b['bound_by']}), "
                     f"x{ms / b['bound_ms']:.2f}")
        if name in res["plain_ms"]:
            more += (f"  plain version {res['plain_ms'][name]:.1f} ms, "
                     "equal to it")
        lines.append(f"{name:<20s} {ms:9.3f} ms  {n / ms / 1e6:8.2f} GB/s"
                     f"{more}  [{card}]")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--mb", type=int, default=512)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--patterns", type=int, default=10_000)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--fills", action="store_true",
                    help="print the bucket rows' fill and stop (no card "
                         "needed)")
    args = ap.parse_args(argv)

    import hyperscan_tpu_torch as ht

    t0 = time.perf_counter()
    pats, ids = patterns(args.patterns)
    db = ht.compile_multi(pats, ids=ids)
    print(f"compiled {args.patterns} patterns in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for g in row_fills(db.lit):
        print("bucket rows " + " ".join(
            f"{k}={v:.1f}" if isinstance(v, float) else f"{k}={v}"
            for k, v in g.items()), flush=True)
    if args.fills:
        return 0
    corpus = gen_corpus(args.mb << 20, 1, "iid")
    on_card = args.device != "cpu"
    clock_hz = (float(nvidia_smi("clocks.max.sm").split()[0]) * 1e6
                if on_card else None)
    res = stage_times(db, corpus, args.reps, args.device, clock_hz)
    card = nvidia_smi("name,power.limit") if on_card else "cpu"
    print(f"{args.mb} MiB iid: {res['candidates']} candidates, "
          f"{res['matches']} hash matches, {res['groups']} confirm groups, "
          f"end-to-end families {res['families']}")
    for line in report(res, card):
        print(line)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
