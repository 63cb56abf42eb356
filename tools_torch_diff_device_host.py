"""Device-host differential of the PyTorch/CUDA port over the bench
corpora: the counterpart of the JAX package's tools_diff_device_host.py.

The literal path's exactness rests on the host verifying the candidates
the device EMITS: a candidate the card's filter silently drops would be
caught neither by that verification nor by the CPU tests, which run the
kernels' plain versions. So for each corpus kind (structured and iid,
salt 1, the whole corpus) this compares the verified (factor, position)
pairs of the device chain (upload, `confirm_start` under the learned
family, `confirm_finish`, `verify_pairs`) with those of the port's host
filter and confirm (`runtime/smallwrite.teddy_filter_host` ->
`lit_runtime.confirm_candidates` -> `verify_pairs`), prints the missing
and extra pairs, and exits non-zero on any difference.

Usage, from the root of the repository on a machine with a CUDA card:

    python3 tools_torch_diff_device_host.py [--mb 512] [--n 10000]
        [--device cuda]
"""

import argparse
import sys
import time

import numpy as np


def pairs(f, p) -> set:
    return set(zip(np.asarray(f).tolist(), np.asarray(p).tolist()))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mb", type=int, default=512)
    ap.add_argument("--n", type=int, default=10_000,
                    help="bench patterns compiled")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    from hyperscan_tpu_torch.ops import teddy_families as F
    from hyperscan_tpu_torch.ops.teddy import corpus_tensor
    from hyperscan_tpu_torch.runtime.lit_runtime import (confirm_candidates,
                                                         verify_pairs)
    from hyperscan_tpu_torch.runtime.scan import resolve_device
    from hyperscan_tpu_torch.runtime.smallwrite import teddy_filter_host
    from hyperscan_tpu_torch.tools.bench import bench_db, card_name
    from hyperscan_tpu_torch.tools.benchdata import gen_corpus

    dev = resolve_device(args.device)
    card = card_name(dev)
    t0 = time.perf_counter()
    db = bench_db(args.n)
    print(f"compiled {args.n} patterns in {time.perf_counter() - t0:.1f} s",
          flush=True)
    lit = db.lit
    z = np.zeros(1, np.int64)
    diffs = 0
    for kind in ("structured", "iid"):
        corpus = gen_corpus(args.mb << 20, 1, kind)
        n = len(corpus)
        corpus_t = corpus_tensor(corpus, dev)
        fams = []
        for _w in range(2):  # the first scan learns the capacities
            h = F.confirm_start(corpus_t, lit, n)
            fams.append(h.family)
            f, p = F.confirm_finish(h)
        t0 = time.perf_counter()
        dev_p = pairs(*verify_pairs(lit, corpus, z, f, p))
        pos, words = teddy_filter_host(corpus, lit.masks)
        fh, ph = confirm_candidates(lit, corpus, z, pos, words)
        host = pairs(*verify_pairs(lit, corpus, z, fh, ph))
        host_s = time.perf_counter() - t0
        missing, extra = host - dev_p, dev_p - host
        diffs += len(missing) + len(extra)
        print(f"{kind} {args.mb} MiB [{card}]: device={len(dev_p)} "
              f"host={len(host)} missing={len(missing)} extra={len(extra)} "
              f"(device families {fams}, {len(pos)} host candidates, host "
              f"side {host_s:.1f} s)", flush=True)
        if missing or extra:
            print(f"  first missing {sorted(missing)[:5]}, first extra "
                  f"{sorted(extra)[:5]}", flush=True)
        del corpus_t
    if diffs:
        print(f"DEVICE != HOST: {diffs} pairs differ")
        return 1
    print("DEVICE==HOST differential OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
