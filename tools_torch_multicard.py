"""Multi-card check of the port's sharded path: make_mesh() over every
visible card against a one-card mesh, at chip_smoke.py's widths (the 10k
ruleset over 512 MiB as 1,024 blocks of 512 KiB, structured and
iid; the bounded DFA over 16,384 x 16 KiB). The outputs must be equal;
end-to-end times are printed beside the card's name and power limit.

Usage, from the root of the repository on a machine with several cards:

    python3 tools_torch_multicard.py
"""
import sys
import time

import numpy as np
import torch

sys.path.insert(0, ".")
import hyperscan_tpu_torch as ht  # noqa: E402
from hyperscan_tpu_torch import parallel as P  # noqa: E402
from hyperscan_tpu_torch.tools.benchdata import (  # noqa: E402
    gen_corpus, patterns)
from hyperscan_tpu_torch.tools.kernel_bench import (  # noqa: E402
    ENGINE_BLOCK, ENGINE_BYTES, MAIN_BYTES, SHARD_BLOCK, engine_blocks,
    engine_db, nvidia_smi, plant_engines)

card = nvidia_smi("name,power.limit")
print("cards", torch.cuda.device_count(), card, flush=True)
from hyperscan_tpu_torch.ops import _build  # noqa: E402
_build.build()
cards, one = P.make_mesh(), P.make_mesh(1)
print(cards, flush=True)
pats, ids = patterns(10_000)
db = ht.compile_multi(pats, ids=ids)
for kind in ("structured", "iid"):
    corpus = gen_corpus(MAIN_BYTES, 1, kind)
    blocks = [corpus[i:i + SHARD_BLOCK]
              for i in range(0, len(corpus), SHARD_BLOCK)]
    want = ht.scan_batch(db, blocks)
    for name, m in (("1 card", one), ("4 cards", cards)):
        got = ht.scan_batch(db, blocks, mesh=m)
        assert got == want, (kind, name)
        times = []
        for _ in range(2):
            t0 = time.perf_counter()
            ht.scan_batch(db, blocks, mesh=m)
            times.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        cnt = P.sharded_teddy_count(corpus, db.lit.masks, m)
        t_cnt = time.perf_counter() - t0
        print(f"{kind} {name}: scan_batch(mesh=) == unsharded, "
              f"{sum(map(len, got))} matches, timed {times} s -> "
              f"{MAIN_BYTES / np.mean(times) / 1e9:.3f} GB/s; "
              f"sharded_teddy_count {cnt} in {t_cnt:.3f} s [{card}]",
              flush=True)
        if name == "1 card":
            cnt1 = cnt
        else:
            assert cnt == cnt1
eng = engine_db("bounded_dfa").engines[0]
ecorpus = plant_engines(gen_corpus(ENGINE_BYTES, 5, "iid"))
eblocks = engine_blocks(ecorpus, "blocks_16k")
data, lengths = P.pad_batch_for_mesh(eblocks, cards, ENGINE_BLOCK)
out = {}
for name, m in (("1 card", one), ("4 cards", cards)):
    t0 = time.perf_counter()
    cnt = P.sharded_scan_counts(eng, data, lengths, m)
    t1 = time.perf_counter()
    # every shard's buffer holds the whole count, so none is clamped
    mt = [x.cpu() for x in P.sharded_scan_matches(
        eng, data, lengths, m, capacity=1 << max(cnt, 1).bit_length())]
    t2 = time.perf_counter()
    n_sh = mt[0].shape[0]
    rows = data.shape[0] // n_sh
    trip = torch.cat([torch.stack([mt[2][d, :int(mt[0][d])] + d * rows,
                                   mt[3][d, :int(mt[0][d])],
                                   mt[1][d, :int(mt[0][d])]])
                      for d in range(n_sh)], 1)
    out[name] = (cnt, trip, mt[4].reshape(-1))
    print(f"sharded DFA {name}: {cnt} matches; counts {t1 - t0:.3f} s, "
          f"matches {t2 - t1:.3f} s [{card}]", flush=True)
a, b = out["1 card"], out["4 cards"]
assert a[0] == b[0] and torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])
print("multicard ok", flush=True)
