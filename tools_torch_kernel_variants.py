"""Times the extraction kernel (csrc/plane_extract.cu), the survivor
rescan (csrc/teddy_rescan_rows.cu) or the hash confirm (kernel B,
csrc/teddy_hash_confirm.cu) against copies of itself with other
constants or with parts of its work taken out, on one card in one call,
so that a design choice is made by measurement.

A variant is the kernel's source with texts replaced (VARIANTS: kernel ->
name -> the texts replaced, or the span between two texts); a variant
whose text the source no longer holds is reported as absent. Probes (PROBES) take a part of the work out
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
at capc 256, as the gated family calls it. The hash confirm: the same
three corpora's candidate lists (kernel A's compact mode at capc 256,
cap1 and cap2 the next powers of two past the candidate and pair
totals), called as the literal path calls it.

Usage, on a machine with a CUDA card:

    python3 tools_torch_kernel_variants.py [--kernel extract|rescan|confirm]
                                          [--db FILE] [--reps 10]

`--db` caches the serialized 10k database (the rescan's and the
confirm's; made when missing). Prints one JSON line: the card's name and power limit, each
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
_MIN_BLOCKS = "constexpr int kMinBlocks = 6;"
_VECTOR = "    if (vec && ((b.y | int(tmask + 1u)) & 3) == 0"
_NO_TAIL = ("  tail_words(corpus, n, p, lo, hi);\n",
            "  lo = uint32_t(p);\n  hi = lo * 3u;\n")
_NO_PROBES = ("      const uint4 w0 = __ldg(w);\n"
              "      const uint4 w1 = __ldg(w + 1);",
              "      const uint4 w0 = make_uint4(h & 0xFFFFFu, h & 0xFFFFFu, "
              "h & 0xFFFFFu, h & 0xFFFFFu);\n"
              "      const uint4 w1 = w0;")
# kernel B: the group loop as two passes (every group's loads and
# compares first, unrolled by 4 so that their loads can be in flight
# together; then the appends, recomputing a hit's slot)
_TWO_PASS_NEW = '__device__ __forceinline__ void confirm_one(\n    const uint8_t* __restrict__ corpus, long long n, int p,\n    const Group* groups, const int32_t* __restrict__ gmeta, int G,\n    const uint32_t* __restrict__ slots, bool vec, int32_t* __restrict__ out,\n    int cap2, int32_t* __restrict__ total) {\n  uint32_t lo, hi;\n  tail_words(corpus, n, p, lo, hi);\n  for (int g0 = 0; g0 < G; g0 += 8) {\n    const int gn = min(8, G - g0);\n    unsigned long long hits = 0ull;  // 8 bits a group\n    unsigned slow = 0u;              // groups probed slot by slot\n#pragma unroll 4\n    for (int j = 0; j < gn; ++j) {\n      const Group r =\n          kStaged ? groups[g0 + j] : load_group(gmeta, g0 + j);\n      const int4 a = r.a;\n      const int4 b = r.b;\n      const uint32_t h = avalanche_hash(lo & uint32_t(a.y),\n                                        hi & uint32_t(a.z));\n      const uint32_t tmask = uint32_t(a.w);\n      const uint32_t first = h & tmask;\n      const uint32_t skew = first & 3u;\n      const bool on = p >= a.x;\n      const bool fast = vec && ((b.y | int(tmask + 1u)) & 3) == 0 &&\n                        skew + b.x <= kWords &&\n                        (first & ~3u) + kWords <= tmask + 1u;\n      if (on && fast) {\n        const uint4* w = reinterpret_cast<const uint4*>(\n            slots + b.y + (first & ~3u));\n        const uint4 w0 = __ldg(w);\n        const uint4 w1 = __ldg(w + 1);\n        const uint32_t sig = h >> 20;\n        uint32_t m =\n            uint32_t(slot_hit(w0.x, sig)) | uint32_t(slot_hit(w0.y, sig)) << 1 |\n            uint32_t(slot_hit(w0.z, sig)) << 2 |\n            uint32_t(slot_hit(w0.w, sig)) << 3 |\n            uint32_t(slot_hit(w1.x, sig)) << 4 |\n            uint32_t(slot_hit(w1.y, sig)) << 5 |\n            uint32_t(slot_hit(w1.z, sig)) << 6 |\n            uint32_t(slot_hit(w1.w, sig)) << 7;\n        m = (m >> skew) & ((1u << b.x) - 1u);\n        hits |= (unsigned long long)m << (8 * j);\n      } else if (on) {\n        slow |= 1u << j;\n      }\n    }\n    while (hits | slow) {\n      int j, k;\n      if (hits) {\n        const int bit = __ffsll(hits) - 1;\n        hits &= hits - 1ull;\n        j = bit >> 3;\n        k = bit & 7;\n      } else {\n        j = __ffs(slow) - 1;\n        slow &= slow - 1u;\n        k = -1;\n      }\n      const Group r =\n          kStaged ? groups[g0 + j] : load_group(gmeta, g0 + j);\n      const int4 a = r.a;\n      const int4 b = r.b;\n      const uint32_t h = avalanche_hash(lo & uint32_t(a.y),\n                                        hi & uint32_t(a.z));\n      const uint32_t* tab = slots + b.y;\n      if (k >= 0) {\n        const uint32_t sl = __ldg(tab + (h & uint32_t(a.w)) + uint32_t(k));\n        append(int32_t(sl & 0xFFFFFu), p, out, cap2, total);\n        continue;\n      }\n      for (int q = 0; q < b.x; ++q) {\n        const uint32_t sl = __ldg(tab + ((h + uint32_t(q)) & uint32_t(a.w)));\n        if (slot_hit(sl, h >> 20))\n          append(int32_t(sl & 0xFFFFFu), p, out, cap2, total);\n      }\n    }\n  }\n}\n\n'
_GROUP_LOOP = "  for (int g = 0; g < G; ++g) {\n    const Group r ="
_CONFIRM_ONE = ("__device__ __forceinline__ void confirm_one(",
                "// kStaged: the group records")  # from, up to
_XOR_HIT = ("  return sl != 0u && (sl >> 20) == sig;",
            "  return ((sl ^ (sig << 20)) < 0x100000u) && sl != 0u;")
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
    "confirm": {
        "min_blocks4": [(_MIN_BLOCKS, "constexpr int kMinBlocks = 4;")],
        "min_blocks8": [(_MIN_BLOCKS, "constexpr int kMinBlocks = 8;")],
        "slot_by_slot": [(_VECTOR, "    if (false")],
        "no_tail": [_NO_TAIL],
        "no_probes": [_NO_PROBES],
        "unroll2": [(_GROUP_LOOP, "#pragma unroll 2\n" + _GROUP_LOOP)],
        "xor_hit": [_XOR_HIT],
        "two_pass": [(_CONFIRM_ONE, _TWO_PASS_NEW)],
        "two_pass_xor": [(_CONFIRM_ONE, _TWO_PASS_NEW), _XOR_HIT],
    },
}
PROBES = {"no_scatter", "no_lookback", "no_filter", "no_tail", "no_probes"}
LIBRARY = {"extract": "plane_extract", "rescan": "teddy_rescan_rows",
           "confirm": "teddy_hash_confirm"}
PLANES = {"iid": 178_771 / (512 << 20), "dense": 0.05}


def edit(text: str, old, new: str):
    """`text` with `old` replaced by `new`, or None where `old` is not
    there once. `old` is a text, or a pair of texts: everything from the
    first up to the second is replaced."""
    if isinstance(old, tuple):
        a, b = text.find(old[0]), text.find(old[1])
        return text[:a] + new + text[b:] if 0 <= a < b else None
    return text.replace(old, new) if text.count(old) == 1 else None


def confirm_input(torch, T, corpus_t, ft, ctab, capc):
    """The hash confirm's call over one corpus's candidate list, its plain
    version's output, and a test of the kernel's output against it (the
    same total, the same pairs in any order)."""
    pos_c, cnt = T.filter_compact(corpus_t, ft, capc, use_classes=True)
    _meta1, pos = T.compact_combine(pos_c, cnt, capc,
                                   T._p2(max(1, int(cnt.long().sum()))))
    cap2 = T._p2(int(T.hash_confirm_plain(corpus_t, pos, ctab, 1)[1]) + 1)

    def keys(out):
        k = int(out[1])
        return int(out[1]), torch.sort(
            (out[0][:k, 1].long() << 20) | out[0][:k, 0]).values

    def same(got, want):
        (tg, kg), (tw, kw) = keys(got), keys(want)
        return tg == tw and torch.equal(kg, kw)

    return (lambda: T.hash_confirm(corpus_t, pos, ctab, cap2),
            T.hash_confirm_plain(corpus_t, pos, ctab, cap2), same)


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
        text = src
        for old, new in edits:
            text = edit(text, old, new)
            if text is None:
                break
        if text is None:
            built[name] = "absent"
            continue
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
        ft, ctab = T.device_tables(db.lit, dev)
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
            if args.kernel == "confirm":
                inputs[cname] = confirm_input(torch, T, ct, ft, ctab, capc)
                continue
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
