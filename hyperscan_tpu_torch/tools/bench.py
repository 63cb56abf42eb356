"""The port's throughput bench: the counterpart of the JAX package's
`bench.py` (the hsbench analogue), of `tools_bench_stream.py:99-188` and
of `tools_probe_som512.py`.

`main()` prints ONE JSON line on stdout: {"metric", "value", "unit",
"vs_baseline"}. The value is the end-to-end block-scan rate (GB/s) of the
10k-pattern bench ruleset over a structured corpus; the metric text adds
the iid corpus, the 100-pattern configuration and its SOM_LEFTMOST form,
StreamSets of 1,024 / 4,096 / 16,384 streams, a SOM StreamSet and the
host-path streams with and without SOM, and names the card and its power
limit. vs_baseline compares against the reference's only published
figure, the hsbench doc sample of 19,241.10 Mbit/s = 2.405 GB/s (the JAX
package's bench.py:18-20).

What is timed is the chain below `scan_batch` that bench.py:205-216
times: per scan the corpus upload (`ops.teddy.corpus_tensor`) and
`confirm_start`, then ONE `confirm_fetch_many` of every scan's buffers,
then per scan `confirm_finish` -> `verify_pairs` -> `finish_confirmed`
-> `RecordSink` -> `finalize_reports`. Unlike the reference, the corpora
are made on the host (`benchdata.gen_corpus`) and uploaded inside the
timed loop. Each configuration also prints on stderr, beside the card,
its families and re-dispatches and the same corpora through
`scan_batch`, timed the same way. The seconds of each stage are in any
`torch.profiler` trace of these scans, as the `hs.*` spans of
`hyperscan_tpu_torch.trace`.

Every function scans on `device`, the CUDA card unless the caller passes
another ("cpu" runs the kernels' plain versions); a missing card raises.

Usage: python3 tools_torch_bench.py [--mb 512] [--iters 6]
    [--svals 1024 4096 16384] [--som-streams 4096] [--patterns 10000]
    [--device cuda]; `--stream [S ...]` runs the stream sweep of
    tools_bench_stream.py, `--som-only` the SOM block configuration
    alone (tools_probe_som512.py).
"""

from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import time

import numpy as np
import torch

import hyperscan_tpu_torch as ht
from hyperscan_tpu_torch.database import compile_patterns
from hyperscan_tpu_torch.grey import Grey
from hyperscan_tpu_torch.ops import teddy_families as F
from hyperscan_tpu_torch.ops.teddy import corpus_tensor
from hyperscan_tpu_torch.runtime import streamset as SS
from hyperscan_tpu_torch.runtime.lit_runtime import (finish_confirmed,
                                                     verify_pairs)
from hyperscan_tpu_torch.runtime.scan import (RecordSink, finalize_reports,
                                              resolve_device)
from hyperscan_tpu_torch.runtime.stream import history_required

from . import benchdata as BD

BASELINE_GBPS = 19241.10 / 8 / 1000.0  # doc sample, Mbit/s -> GB/s
CORPUS_MB = 512  # one block a scan
ITERS = 6  # timed scans a configuration, all served by one fetch
WARM_MAX = 4  # warm passes at most (run_config)
WRITE = 8192  # bytes a stream writes a round
STREAM_SVALS = (1024, 4096, 16384)  # StreamSet sizes of the bench
SOM_STREAMS = 4096  # the SOM StreamSet's size
SWEEP_SVALS = (16, 256, 1024, 4096)  # the stream sweep's default sizes
HOST_LIMIT = Grey(host_scan_limit=1 << 21)  # the bench's stream databases

_T0 = time.perf_counter()


def _phase(msg: str) -> None:
    """Wall-clock phase marker on stderr (stdout carries the result)."""
    print(f"[bench +{time.perf_counter() - _T0:7.1f}s] {msg}",
          file=sys.stderr, flush=True)


def card_name(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi reports them, or
    "cpu"."""
    if dev.type != "cuda":
        return "cpu"
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0].strip()


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _timed(dev, fn):
    """fn()'s result and seconds, with the heap made before it frozen out
    of the cyclic collector (gen-2 collections of the compile graph cost
    the JAX package's bench 145 ms pauses, tools_bench_stream.py:151-161)
    and the device synchronized before each read of the clock."""
    gc.collect()
    gc.freeze()
    try:
        _sync(dev)
        t0 = time.perf_counter()
        out = fn()
        _sync(dev)
        return out, time.perf_counter() - t0
    finally:
        gc.unfreeze()


def bench_db(n_patterns: int, flags: int = 0, drop_shapes=(),
             mode: int = ht.HS_MODE_BLOCK, grey=None):
    """The first `n_patterns` bench patterns without `drop_shapes`, each
    with `flags`."""
    pats, ids = BD.patterns(n_patterns, drop_shapes)
    return compile_patterns(pats, [flags] * len(pats), ids, mode, grey=grey)


# --- block scans (bench.py:138-262) -------------------------------------------


def _finish(db, handle, corpus: np.ndarray, got) -> list:
    """The host half of one started scan of one block, as scan_batch runs
    it: the pairs sorted and expanded, verified, the windows validated,
    the reports made. Returns the match list."""
    n = len(corpus)
    starts, ends = np.zeros(1, np.int64), np.asarray([n], np.int64)
    f, p = F.confirm_finish(handle, got=got)
    f, p = verify_pairs(db.lit, corpus, starts, f, p)
    recs = finish_confirmed(db, corpus, starts, ends, f, p)
    sink = RecordSink()
    for (_b, e, to, frm) in recs:
        sink.add(e, to, frm)
    return finalize_reports(db, sink.materialize(n), end_offset=n)[0]


def scan_chain(db, corpora, dev) -> list:
    """The timed chain over the blocks `corpora`: each uploaded and its
    filter + confirm started, one fetch of every scan's buffers, each
    finished in order. Returns each block's match list."""
    handles = [F.confirm_start(corpus_tensor(c, dev), db.lit, len(c))
               for c in corpora]
    gots = F.confirm_fetch_many(handles)
    return [_finish(db, h, c, g) for h, c, g in zip(handles, corpora, gots)]


def run_config(n_patterns: int, device="cuda", flags: int = 0,
               corpus_mb: int = CORPUS_MB, iters: int = ITERS,
               drop_shapes=(), corpus_kind: str = "structured", db=None,
               corpora=None, out=None):
    """One block-scan configuration: `iters` timed scans of distinct
    `corpus_mb` MiB corpora (salts 1..iters; salt 0 warms) through the
    chain, after warm passes of `iters` scans: at least two (the first
    finish learns the capacities and the gate's survival rate,
    ops/teddy_families.py _caps_for / _observe_finish), and more while a
    pass dispatched other families than the pass before it (what the
    first pass learns can move the database from the gated family to
    compact, and the mean candidates compact learns to kconfirm, whose
    first dispatch builds its tables), up to WARM_MAX. `db` reuses a
    compiled database, `corpora` the iters + 1 host corpora of this kind
    and size; `out`, a list, receives each timed scan's match list.
    Returns (GB/s, matches of the timed scans, compile seconds)."""
    dev = resolve_device(device)
    tag = (f"{n_patterns}p flags={flags} {corpus_kind} {corpus_mb} MiB x "
           f"{iters}")
    t_compile = 0.0
    if db is None:
        _phase(f"{tag}: compile")
        t0 = time.perf_counter()
        db = bench_db(n_patterns, flags, drop_shapes)
        t_compile = time.perf_counter() - t0
    if db.lit is None or db.engines:
        raise RuntimeError("a bench ruleset must be literal-routed")
    n = corpus_mb << 20
    if corpora is None:
        _phase(f"{tag}: {iters + 1} host corpora")
        corpora = [BD.gen_corpus(n, s, corpus_kind)
                   for s in range(iters + 1)]
    if len(corpora) != iters + 1 or any(len(c) != n for c in corpora):
        raise ValueError(f"need {iters + 1} corpora of {n} bytes")
    _phase(f"{tag}: warm passes")
    # the two gate* plants are shape 5's (dropped by the SOM configuration)
    need = len(BD.PLANTS) - (2 if 5 in drop_shapes else 0)
    st = F.family_state(db.lit)
    warm_fams = []  # the families each warm pass dispatched
    while len(warm_fams) < 2 or (warm_fams[-1] != warm_fams[-2]
                                 and len(warm_fams) < WARM_MAX):
        before = dict(st.dispatches)
        warm = scan_chain(db, [corpora[0]] * iters, dev)
        if len(warm[0]) < need:
            raise RuntimeError(f"{tag}: a warm scan found {len(warm[0])} "
                               f"matches, the plants alone make {need}")
        warm_fams.append([f for f in F.FAMILIES
                          if st.dispatches[f] > before[f]])
    before = dict(st.dispatches)
    timed = corpora[1:]
    lists, dt = _timed(dev, lambda: scan_chain(db, timed, dev))
    ran = {f: st.dispatches[f] - before[f] for f in F.FAMILIES
           if st.dispatches[f] > before[f]}
    batch, dt_b = _timed(dev, lambda: [
        ht.scan_batch(db, [c], device=dev)[0] for c in timed])
    if batch != lists:
        raise RuntimeError(f"{tag}: scan_batch's matches differ from the "
                           "chain's")
    total = sum(map(len, lists))
    gbps = n * iters / dt / 1e9
    _phase("config " + json.dumps({
        "config": tag, "card": card_name(dev), "gb_s": gbps, "seconds": dt,
        "matches": total, "compile_s": t_compile,
        "warm_families": warm_fams, "families": ran,
        "redispatches": sum(ran.values()) - iters,
        "scan_batch_gb_s": n * iters / dt_b / 1e9, "scan_batch_s": dt_b}))
    if out is not None:
        out.extend(lists)
    return gbps, total, t_compile


# --- streams (tools_bench_stream.py:99-170, bench.py:264-344) ------------------


def run_streamset(db, S: int, rounds: int, device="cuda", out=None):
    """A StreamSet of S streams writing WRITE bytes a round: round 0 (its
    writes alone) and round 1 (history_required bytes of history + the
    write) synchronous, then `rounds` rounds pipelined and timed: each
    round's extents (benchdata.stream_extents) uploaded and its filter
    started, one confirm_fetch_many of every round's buffers, the rounds
    finished in order. Two warm passes (the first learns the capacities)
    and three timed ones, each on a fresh StreamSet; the best counts.
    Every pass must give the same matches, and every plant that
    benchdata.stream_plants predicts must be found. `out`, a list,
    receives each round's per-stream match lists. Returns (GB/s of new
    bytes, matches of the timed rounds)."""
    dev = resolve_device(device)
    hreq = history_required(db)
    _phase(f"S={S}: {rounds + 2} rounds of extents ({hreq} B of history)")
    ext = [BD.stream_extents(S, WRITE, hreq if r else 0, r)
           for r in range(rounds + 2)]
    wl = np.full(S, WRITE, np.int64)
    hlens = [np.zeros(S, np.int64)] + [np.full(S, hreq, np.int64)] * (
        rounds + 1)

    def start(ss, r):
        return SS.streamset_write_start(
            db, ss, ext_np=ext[r], ext_t=corpus_tensor(ext[r], dev),
            hlens=hlens[r], chunk_lens=wl)

    def one_pass():
        ss = SS.open_streamset(db, S, device=dev)
        res = [SS.streamset_write_finish(db, ss, start(ss, r))
               for r in (0, 1)]

        def pipelined():
            handles = [start(ss, r) for r in range(2, rounds + 2)]
            gots = F.confirm_fetch_many([h.dev_handle for h in handles])
            return [h.dev_handle.family for h in handles], [
                SS.streamset_write_finish(db, ss, h, got=g)
                for h, g in zip(handles, gots)]

        (fams, rest), dt = _timed(dev, pipelined)
        return dt, res + rest, fams

    passes = [one_pass() for _ in range(5)]  # two warm, three timed
    dt, res, fams = min(passes[2:], key=lambda p: p[0])
    if any(p[1] != passes[0][1] for p in passes[1:]):
        raise RuntimeError(f"S={S}: the passes' matches differ")
    nm = sum(len(m) for rnd in res[2:] for m in rnd)
    plants = BD.stream_plants(S, (rounds + 2) * WRITE)
    found = {(i, m[2]) for rnd in res for i, ms in enumerate(rnd)
             for m in ms if m[0] == 0}
    if not plants or not plants <= found:
        raise RuntimeError(f"S={S}: {len(plants - found)} of {len(plants)} "
                           "planted matches missing")
    vol = S * WRITE * rounds
    _phase(f"S={S} [{card_name(dev)}]: passes "
           f"{[round(p[0], 4) for p in passes]} s, best {dt:.4f} s -> "
           f"{vol / dt / 1e9:.3f} GB/s; {nm} matches in the timed rounds, "
           f"{len(plants)} plants found; families per round {fams}")
    if out is not None:
        out.extend(res)
    return vol / dt / 1e9, nm


def run_stream_device(db, device="cuda", svals=STREAM_SVALS) -> dict:
    """run_streamset at each S of `svals`, max(6, min(16, 96 MiB / (S x
    WRITE))) rounds (bench.py:264-278). Returns {S: GB/s}."""
    out = {}
    for S in svals:
        rounds = max(6, min(16, (96 << 20) // (S * WRITE)))
        out[S] = run_streamset(db, S, rounds, device)[0]
    return out


def _host_streams(db, writes, device, out):
    """scan_streams over BD.HOST_STREAMS streams, one round of `writes`
    to warm, the others timed (under the database's host_scan_limit, so
    on the host path). Returns (GB/s, matches of the timed rounds)."""
    streams = [ht.open_stream(db, device=device)
               for _ in range(BD.HOST_STREAMS)]
    res = [ht.scan_streams(db, streams, writes[0])]
    t0 = time.perf_counter()
    res += [ht.scan_streams(db, streams, w) for w in writes[1:]]
    dt = time.perf_counter() - t0
    res.append([ht.close_stream(st) for st in streams])
    if out is not None:
        out.extend(res)
    nm = sum(len(m) for rnd in res[1:-1] for m in rnd)
    return BD.HOST_STREAMS * BD.HOST_WRITE * (len(writes) - 1) / dt / 1e9, nm


def run_stream_som(device="cuda", rounds: int = 16, out=None):
    """Streaming SOM on the host path (bench.py:280-313): the first 96
    bench patterns without shape 5, SOM_LEFTMOST, 16 streams x 8 KiB
    writes, `attack0 ` in every 4th (round + stream). `out`, a list,
    receives each round's per-stream match lists (and the close's).
    Returns (GB/s, matches of the timed rounds)."""
    dev = resolve_device(device)
    db = bench_db(96, ht.HS_FLAG_SOM_LEFTMOST, (5,), ht.HS_MODE_STREAM,
                  HOST_LIMIT)
    return _host_streams(db, BD.host_stream_writes(3, 4, rounds), dev, out)


def run_stream_config(db, device="cuda", rounds: int = 24, out=None):
    """Streaming on the host path (bench.py:315-344): 16 streams x 8 KiB
    writes through the stream database `db`, `attack0 ` in every 5th
    (round + stream). As run_stream_som otherwise."""
    dev = resolve_device(device)
    return _host_streams(db, BD.host_stream_writes(7, 5, rounds), dev, out)


# --- the entry point (bench.py:346-426) ---------------------------------------


def stream_sweep(svals, n_patterns: int, device) -> dict:
    """tools_bench_stream.py:173-188: the ruleset in stream mode, a
    StreamSet at each S of `svals` with max(6, min(24, 128 MiB / (S x
    WRITE))) rounds; prints a line for each. Returns {S: GB/s}."""
    dev = resolve_device(device)
    card = card_name(dev)
    _phase(f"compile {n_patterns} patterns, stream mode")
    db = bench_db(n_patterns, mode=ht.HS_MODE_STREAM)
    out = {}
    for S in svals:
        rounds = max(6, min(24, (128 << 20) // (S * WRITE)))
        gbps, nm = run_streamset(db, S, rounds, dev)
        out[S] = gbps
        print(f"S={S:5d}: {gbps:.3f} GB/s aggregate ({nm} matches) [{card}]",
              flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--mb", type=int, default=CORPUS_MB,
                    help="MiB a block scan")
    ap.add_argument("--iters", type=int, default=ITERS,
                    help="timed scans a block configuration")
    ap.add_argument("--svals", type=int, nargs="+",
                    default=list(STREAM_SVALS), help="StreamSet sizes")
    ap.add_argument("--som-streams", type=int, default=SOM_STREAMS,
                    help="the SOM StreamSet's size")
    ap.add_argument("--patterns", type=int, default=10_000,
                    help="the large ruleset's size")
    ap.add_argument("--stream", type=int, nargs="*", metavar="S",
                    help="only the stream sweep (default sizes "
                         f"{' '.join(map(str, SWEEP_SVALS))})")
    ap.add_argument("--som-only", action="store_true",
                    help="only the SOM block configuration")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    card = card_name(dev)
    if args.stream is not None:
        res = stream_sweep(args.stream or SWEEP_SVALS, args.patterns, dev)
        print(json.dumps({str(k): round(v, 3) for k, v in res.items()}))
        return 0
    som = ht.HS_FLAG_SOM_LEFTMOST
    if args.som_only:
        g, m, c = run_config(100, dev, som, args.mb, args.iters, (5,))
        print(f"SOM {args.mb} MB: {g:.2f} GB/s, {m} matches, compile "
              f"{c:.1f}s [{card}]", flush=True)
        return 0

    _phase(f"stream db: compile {args.patterns} patterns")
    sdb = bench_db(args.patterns, mode=ht.HS_MODE_STREAM, grey=HOST_LIMIT)
    gs, ms_n = run_stream_config(sdb, dev)
    gss, _nms = run_stream_som(dev)
    gdev = run_stream_device(sdb, dev, args.svals)
    del sdb
    _phase("SOM stream db (StreamSet): compile")
    sdb_som = bench_db(96, som, (5,), ht.HS_MODE_STREAM, HOST_LIMIT)
    gdev_som = run_stream_device(sdb_som, dev, (args.som_streams,))
    gdev_som = gdev_som[args.som_streams]
    del sdb_som
    # the structured corpora serve three configurations
    n = args.mb << 20
    _phase(f"{args.iters + 1} structured host corpora")
    corpora = [BD.gen_corpus(n, s, "structured")
               for s in range(args.iters + 1)]
    common = dict(corpus_mb=args.mb, iters=args.iters)
    g100, m100, c100 = run_config(100, dev, corpora=corpora, **common)
    gsom, msom, _c = run_config(100, dev, som, drop_shapes=(5,),
                                corpora=corpora, **common)
    g10k, m10k, c10k = run_config(args.patterns, dev, corpora=corpora,
                                  **common)
    del corpora
    g10i, m10i, _c = run_config(args.patterns, dev, corpus_kind="iid",
                                **common)
    _phase("done")
    gdev_txt = ", ".join(f"{s}str {v:.2f}" for s, v in gdev.items())
    k = f"{args.patterns // 1000}k" if args.patterns >= 1000 else \
        str(args.patterns)
    print(json.dumps({
        "metric": f"block scan GB/s, {k}-pattern ruleset, one device: "
                  f"{card} (literal path: filter + hash confirm on the "
                  "device, corpus uploaded inside the timed loop), e2e "
                  "structured "
                  f"{g10k:.2f} / iid-noise {g10i:.2f} GB/s ({m10i} "
                  f"matches), {args.mb}MB/scan, compile {c10k:.1f}s, "
                  f"{m10k} matches; 100-pattern config: {g100:.2f} GB/s, "
                  f"compile {c100:.2f}s, {m100} matches; 100-pattern "
                  f"SOM_LEFTMOST: {gsom:.2f} GB/s, {msom} matches; "
                  f"streaming {k} x 8KB writes, device-batched StreamSet: "
                  f"{gdev_txt} GB/s aggregate; SOM StreamSet 96p "
                  f"{args.som_streams}str: {gdev_som:.2f} GB/s; 16 streams "
                  f"host path: {gs:.3f} GB/s, {ms_n} matches; SOM "
                  f"streaming 16str host: {gss:.3f} GB/s",
        "value": round(g10k, 4),
        "unit": "GB/s",
        "vs_baseline": round(g10k / BASELINE_GBPS, 4),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
