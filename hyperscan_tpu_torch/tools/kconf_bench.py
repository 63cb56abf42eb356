"""Device bench of the literal path's two confirm families: the in-kernel
confirm (the kconfirm family: kernel 4, `csrc/teddy_kconfirm.cu`) against
the separate confirm (the compact family: kernel A's compact mode, then
kernel B's hash confirm). The counterpart of the JAX package's
`tools_bench_kconfirm.py` (its `--xla` is `--separate` here).

The bench's 10k ruleset (`benchdata.patterns`) over `--iters` + 2
corpora of `--mb` MiB (`benchdata.gen_corpus`, salts 0, 1, ...; iid
printable noise by default, the adversarial candidate rate), made on the
host and uploaded before the timing. Each family is forced in turn
(`ops.teddy_families.force_family`) and run as the reference runs it:
two warm scans through `confirm_start` / `confirm_finish`, then
`--iters` timed starts, ONE `confirm_fetch_many` and a `confirm_finish`
each. It prints the family, seconds a scan and GB/s (10^9 bytes a
second). With both families in one call, the verified (fid, pos) pairs of
each timed scan must be equal as sets (kconfirm may emit a pair twice),
or it raises.

Usage, on a machine with a CUDA card:

    python3 tools_torch_bench_kconfirm.py [--mb 512] [--iters 3]
        [--n 10000] [--kind iid] [--separate] [--device cuda]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from .benchdata import gen_corpus, patterns

FAMILIES = ("kconfirm", "compact")  # in-kernel confirm, separate confirm
WARM = 2  # warm scans a family: the first learns the capacities


def run_family(db, corpora_t, corpora, iters: int, family: str) -> dict:
    """One family forced over the uploaded corpora (`corpora_t`, and the
    same bytes on the host, `corpora`): WARM warm scans of corpora 0..,
    then `iters` timed scans of corpora WARM.. (one fetch). Raises where
    another family ran. Returns its seconds a scan, GB/s, the families
    the warm scans ran, the re-dispatches in the timed scans, the
    verified (fid, pos) pairs of each timed scan as a set, and the last
    timed scan's ConfirmHandle (its kernels' inputs and capacities)."""
    import torch

    from ..ops import teddy_families as F
    from ..runtime.lit_runtime import verify_pairs

    lit = db.lit
    n = len(corpora[0])
    st = F.family_state(lit)
    forced = st.force
    F.force_family(lit, family)
    try:
        warm = []
        for w in range(WARM):
            h = F.confirm_start(corpora_t[w], lit, n)
            f, _p = F.confirm_finish(h)
            warm.append((h.family, len(f)))
        before = dict(st.dispatches)
        if corpora_t[0].device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        handles = [F.confirm_start(corpora_t[WARM + s], lit, n)
                   for s in range(iters)]
        gots = F.confirm_fetch_many(handles)
        got_pairs = [F.confirm_finish(h, got=g)
                     for h, g in zip(handles, gots)]
        dt = time.perf_counter() - t0
        ran = {k: st.dispatches[k] - before[k] for k in F.FAMILIES
               if st.dispatches[k] > before[k]}
    finally:
        F.force_family(lit, forced)
    if set(ran) != {family} or any(fam != family for fam, _ in warm):
        raise RuntimeError(f"forced {family}, ran {warm} warm and {ran}")
    starts = np.zeros(1, np.int64)
    pairs = []
    for s, (f, p) in enumerate(got_pairs):
        f, p = verify_pairs(lit, corpora[WARM + s], starts, f, p)
        pairs.append(set(zip(f.tolist(), p.tolist())))
    return {"family": family, "s_per_scan": dt / iters,
            "gb_s": n * iters / dt / 1e9, "warm": warm,
            "redispatches": sum(ran.values()) - iters,
            "hash_pairs": sum(len(f) for f, _p in got_pairs),
            "pairs": pairs, "handle": handles[-1]}


def run(db, mb: int = 512, iters: int = 3, kind: str = "iid",
        families=FAMILIES, device="cuda") -> dict:
    """Every family of `families` over the same corpora; where there are
    two or more, their verified pairs must be equal scan by scan. Returns
    family -> run_family's result."""
    from ..ops.teddy import corpus_tensor
    from ..runtime.scan import resolve_device

    dev = resolve_device(device)
    if db.lit is None or db.engines:
        raise ValueError("the bench needs a literal-routed database")
    corpora = [gen_corpus(mb << 20, s, kind) for s in range(WARM + iters)]
    corpora_t = [corpus_tensor(c, dev) for c in corpora]
    out = {fam: run_family(db, corpora_t, corpora, iters, fam)
           for fam in families}
    first = out[families[0]]
    for fam in families[1:]:
        for s, (a, b) in enumerate(zip(first["pairs"], out[fam]["pairs"])):
            if a != b:
                raise RuntimeError(
                    f"timed scan {s}: {families[0]} verified {len(a)} pairs, "
                    f"{fam} {len(b)}; {len(a ^ b)} differ")
    return out


def report(res: dict, mb: int, iters: int, card: str) -> list:
    """One line per family."""
    return [f"{r['family']}: {iters} x {mb} MiB, {r['s_per_scan']:.4f} s a "
            f"scan -> {r['gb_s']:.3f} GB/s; warm {r['warm']}, "
            f"re-dispatches {r['redispatches']}, hash-matched pairs "
            f"{r['hash_pairs']}, verified {sum(map(len, r['pairs']))} "
            f"[{card}]" for r in res.values()]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="In-kernel confirm (kconfirm) against the separate "
                    "confirm (compact) over the bench ruleset.")
    ap.add_argument("--mb", type=int, default=512)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--n", type=int, default=10_000)
    ap.add_argument("--kind", default="iid", choices=("iid", "structured"))
    ap.add_argument("--separate", action="store_true",
                    help="the separate confirm (compact) alone")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import hyperscan_tpu_torch as ht

    from .bench import card_name
    from ..runtime.scan import resolve_device

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        from ..ops import _build

        _build.build()
    t0 = time.perf_counter()
    pats, ids = patterns(args.n)
    db = ht.compile_multi(pats, ids=ids)
    print(f"[{time.perf_counter() - t0:6.1f}s] compiled {args.n} patterns",
          flush=True)
    families = ("compact",) if args.separate else FAMILIES
    res = run(db, args.mb, args.iters, args.kind, families, dev)
    card = card_name(dev)
    for line in report(res, args.mb, args.iters, card):
        print(f"[{time.perf_counter() - t0:6.1f}s] {line}", flush=True)
    if len(families) > 1:
        print(f"verified pairs equal in every timed scan: "
              f"{[len(p) for p in res[families[0]]['pairs']]}", flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
