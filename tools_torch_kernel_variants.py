"""Times the extraction kernel (csrc/plane_extract.cu) or the survivor
rescan (csrc/teddy_rescan_rows.cu) against copies of itself with other
constants or with parts of its work taken out, on one card in one call,
so that a design choice is made by measurement.

A variant is the kernel's source with texts replaced (VARIANTS: kernel ->
name -> the texts replaced); a variant whose text the source no longer
holds is reported as absent. Probes (PROBES) take a part of the work out
to show where the time goes; their output is wrong by construction and
is not checked. Every other variant is held exact against the kernel's
plain version on each input first. Each variant is built with the port's
nvcc flags into `hyperscan_tpu_torch/build/variants/` (all at once),
loaded in place of the kernel's library, and timed in turns: the kernel,
each variant, each variant again in reverse order, the kernel again.

Inputs. The extraction: 512 MiB planes made on the card from a seed, one
with the iid corpus's candidate share (178,771 of 512 Mi, chip_smoke.py
phase 4c) and one with 5% of its bytes nonzero (the dense plane). The
rescan: the 10k bench ruleset's gate flags and row counts over the 512 MiB
iid and structured corpora and over one StreamSet round's 16,384 extents,
at capc 256, as the gated family calls it.

Usage, on a machine with a CUDA card:

    python3 tools_torch_kernel_variants.py [--kernel extract|rescan]
                                          [--db FILE] [--reps 10]

`--db` caches the serialized 10k database (the rescan's; made when
missing). Prints one JSON line: the card's name and power limit, each
variant's build report (registers) or absence, and per input the ms of
each turn.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

# name -> [(text in the source, what replaces it)]
_LOADS = "constexpr int kLoads = 2;"
_STEPS = "constexpr int kSteps = 8;"
_BACKOFF = "constexpr unsigned kBackoffNs = 1000;"
_NO_SCATTER = ("if (first < cap1) {", "if (false) {")
_NO_LOOKBACK = ("} else if (range > 0) {", "} else if (false) {")
_NO_FILL = ("if (range < n_ranges - fillers) return;", "return;")
_HOT = "constexpr int kHot = 32;"
_NO_FILTER = ("""    uint32_t bits =
        cand_bits<M, true, V>(win, a.s_b2c, a.s_tab, a.H, a.R, p0, n);
    const int cnt""", """    uint32_t bits = win[2] == 0x5a5a5a5au;
    const int cnt""")
VARIANTS = {
    "extract": {
        "loads4": [(_LOADS, "constexpr int kLoads = 4;")],
        "steps4": [(_STEPS, "constexpr int kSteps = 4;")],
        "steps16": [(_STEPS, "constexpr int kSteps = 16;")],
        "backoff400": [(_BACKOFF, "constexpr unsigned kBackoffNs = 400;")],
        "no_scatter": [_NO_SCATTER],
        "no_lookback": [_NO_LOOKBACK, _NO_SCATTER, _NO_FILL],
    },
    "rescan": {
        "hot64": [(_HOT, "constexpr int kHot = 64;")],
        "hot128": [(_HOT, "constexpr int kHot = 128;")],
        "no_filter": [_NO_FILTER],
    },
}
PROBES = {"no_scatter", "no_lookback", "no_filter"}
LIBRARY = {"extract": "plane_extract", "rescan": "teddy_rescan_rows"}
PLANES = {"iid": 178_771 / (512 << 20), "dense": 0.05}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--kernel", choices=tuple(VARIANTS), default="extract")
    ap.add_argument("--db", default=None)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

    import torch

    if not torch.cuda.is_available():
        print("tools_torch_kernel_variants: no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as CS
    import hyperscan_tpu_torch as ht
    from hyperscan_tpu_torch.ops import _build
    from hyperscan_tpu_torch.ops import extract as X
    from hyperscan_tpu_torch.ops import teddy as T
    from hyperscan_tpu_torch.ops import teddy_gate as G
    from hyperscan_tpu_torch.runtime.stream import history_required
    from hyperscan_tpu_torch.tools.benchdata import (gen_corpus, patterns,
                                                     stream_extents)

    card = CS.nvidia_smi("name,power.limit")
    dev = "cuda"
    lib = LIBRARY[args.kernel]
    src = _build.sources()[lib].read_text()
    vdir = _build.BUILD_DIR / "variants"
    vdir.mkdir(parents=True, exist_ok=True)
    built, procs = {}, {}
    for name, edits in VARIANTS[args.kernel].items():
        if any(src.count(old) != 1 for old, _new in edits):
            built[name] = "absent"
            continue
        text = src
        for old, new in edits:
            text = text.replace(old, new)
        cu = vdir / f"{lib}_{name}.cu"
        cu.write_text(text)
        so = cu.with_suffix(".so")
        procs[name] = (so, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
             "-o", str(so), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT))
    _build.build([lib])
    libs = {"kernel": _build.library(lib)}
    for name, (so, proc) in procs.items():
        out, _ = proc.communicate()
        text = out.decode(errors="replace")
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for variant {name}:\n{text}")
        built[name] = [ln.strip() for ln in text.splitlines()
                       if "registers" in ln]
        libs[name] = ctypes.CDLL(str(so))

    def use(name):
        _build._libs[lib] = libs[name]

    # input name -> (the kernel's call, its plain version's output, a test
    # of the kernel's output against it)
    inputs = {}
    if args.kernel == "extract":
        g = torch.Generator(device=dev).manual_seed(9)
        for pname, share in PLANES.items():
            plane = (torch.rand(512 << 20, generator=g, device=dev)
                     < share).to(torch.uint8)
            n, cap1 = plane.numel(), T._p2(int(plane.sum()))
            inputs[pname] = (
                lambda p=plane, n=n, c=cap1: X.plane_extract(p, n, c),
                X.plane_extract_plain(plane, n, cap1),
                lambda got, want: all(torch.equal(a, b)
                                      for a, b in zip(got, want)))
    else:
        if args.db and os.path.exists(args.db):
            with open(args.db, "rb") as f:
                db = ht.deserialize_database(f.read())
        else:
            pats, ids = patterns(10_000)
            db = ht.compile_multi(pats, ids=ids)
            if args.db:
                with open(args.db, "wb") as f:
                    f.write(ht.serialize_database(db))
        ft, _ct = T.device_tables(db.lit, dev)
        gt = G.device_gate_table(db.lit, dev)
        sdb = ht.deserialize_database(ht.serialize_database(db))
        sdb.mode = ht.HS_MODE_STREAM
        corpora = {
            "iid": gen_corpus(512 << 20, 2, "iid"),
            "structured": gen_corpus(512 << 20, 1, "structured"),
            "streamset round": stream_extents(
                CS.STREAMS, CS.STREAM_WRITE, history_required(sdb), 2)}
        capc = 256
        for cname, corpus in corpora.items():
            ct = T.corpus_tensor(corpus, dev)
            flags, k = G.gate_rows(ct, gt)
            inputs[cname] = (
                lambda c=ct, f=flags, k=k: G.rescan_rows(
                    c, ft, f, capc, row_counts=k),
                T.filter_compact_plain(ct, ft, capc, use_classes=True,
                                       row_flags=flags),
                lambda got, want: CS.cell_err(torch, got[0], got[1],
                                              want[0], want[1], capc) == 0)
    names = list(libs)
    order = names + names[:0:-1] + names[:1]  # kernel, v..., ...v, kernel
    out = {}
    for iname, (call, want, same) in inputs.items():
        for name in names:
            if name in PROBES:
                continue
            use(name)
            if not same(call(), want):
                raise SystemExit(f"{name} on {iname} != plain")
        turns = {name: [] for name in names}
        for name in order:
            use(name)
            turns[name].append(CS.cuda_ms(torch, call, args.reps))
        out[iname] = turns
    use("kernel")
    print(json.dumps({"card": card, "kernel": args.kernel, "built": built,
                      "reps": args.reps,
                      "turns": "kernel, variants, variants reversed, "
                               "kernel", "ms": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
