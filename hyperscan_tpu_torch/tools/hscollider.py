"""hscollider — differential conformance harness.

Reference: tools/hscollider (7.7k LoC): compiles patterns singly and
together, scans corpora in every mode and alignment, and diffs match sets
against ground truth. Here the ground truth is the AST oracle
(GroundTruth/GraphTruth analogue) and the cross-checks are:

  - block vs AST oracle (exact (id, to) sets)
  - stream with random write splits vs block
  - vectored vs block
  - serialize/deserialize round trip
  - multi-compile vs single-compile

Usage:
  python -m hyperscan_tpu_torch.tools.hscollider patterns.txt [--corpus FILE]
      [--seed N] [--device cuda|cpu]

Pattern file format: `id:/pattern/flags` or bare patterns (see hscheck).
Without --corpus, corpora are generated from the patterns' own literal
factors embedded in random noise (NfaGeneratedCorpora analogue).

The port's copy of `hyperscan_tpu.tools.hscollider`. Every scan runs on
`--device` (the CUDA card by default; a missing card raises; `cpu` runs
the kernels' plain versions). Its corpora are far below the databases'
`host_scan_limit` (128 KiB), where every scan would stay on the host,
so the collider compiles each database with `Grey(host_scan_limit=0)`:
every non-empty scan then takes the device branch and its kernels.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, List, Set

import numpy as np

import hyperscan_tpu_torch as hs
from hyperscan_tpu_torch.compiler.parser import parse
from hyperscan_tpu_torch.database import compile_patterns
from hyperscan_tpu_torch.grey import Grey
from hyperscan_tpu_torch.runtime.scan import resolve_device
from hyperscan_tpu_torch.utils.oracle import (ast_leftmost_som,
                                              ast_match_ends,
                                              re_leftmost_som,
                                              re_match_ends)

from .hscheck import parse_line

ORACLE_SKIP = hs.HS_FLAG_COMBINATION | hs.HS_FLAG_PREFILTER
# every non-empty scan takes the device branch (module docstring)
DEVICE_GREY = Grey(host_scan_limit=0)


def compile_on_device(exprs, flags, ids, mode=hs.HS_MODE_BLOCK):
    """`hs.compile_multi` with `DEVICE_GREY`."""
    return compile_patterns(exprs, flags, ids, mode, grey=DEVICE_GREY)


def _nfa_walks(pat: str, flags: int, rng, n_walks: int = 4,
               max_len: int = 300) -> List[bytes]:
    """Accept-path-derived strings: random walks over the pattern's
    Glushkov NFA, stopping (sometimes) at accept positions — exercises
    deep branches (long counted gaps, multi-byte paths) that factor
    seeding reaches only by luck (reference analogue:
    tools/hscollider/NfaGeneratedCorpora.cpp). Truncated walks double
    as near-miss corpora."""
    from hyperscan_tpu_torch.compiler.glushkov import build_nfa

    try:
        g = build_nfa(parse(pat, flags))
    except hs.HyperscanError:
        return []
    firsts = sorted(g.anchored_first | g.float_first)
    if not firsts:
        return []
    out: List[bytes] = []
    for _w in range(n_walks):
        s = bytearray()
        p = firsts[int(rng.integers(0, len(firsts)))]
        for _step in range(max_len):
            ok = np.flatnonzero(g.reach[p])
            if not len(ok):
                break
            s.append(int(ok[int(rng.integers(0, len(ok)))]))
            if p in g.accept and rng.integers(0, 3) == 0:
                break
            nxt = sorted(g.follow[p])
            if not nxt:
                break
            p = nxt[int(rng.integers(0, len(nxt)))]
        if s:
            out.append(bytes(s))
            if len(s) > 2:  # near-miss prefix
                out.append(bytes(s[: int(rng.integers(1, len(s)))]))
    return out


def _gen_corpora(entries, rng, n=6) -> List[bytes]:
    """Noise corpora seeded with pattern fragments AND NFA-accept-path
    walks (NfaGeneratedCorpora analogue)."""
    from hyperscan_tpu_torch.compiler.literals import extract_factors

    frags: List[bytes] = []
    for (_id, pat, flags) in entries:
        try:
            fs = extract_factors(parse(pat, flags))
        except hs.HyperscanError:
            continue
        for fi in fs or []:
            frags.append(bytes(a.value for a in fi.factor.atoms))
        frags.extend(_nfa_walks(pat, flags, rng))
    out = [b"", b"\x00" * 16]
    for k in range(n):
        blob = bytearray(rng.integers(32, 127, 768, dtype=np.uint8).tobytes())
        for j, frag in enumerate(frags):
            if (j + k) % 3 == 0:
                off = int(rng.integers(0, max(1, len(blob) - len(frag))))
                blob[off : off + len(frag)] = frag
        out.append(bytes(blob))
    return out


def _splits(data: bytes, rng) -> List[List[bytes]]:
    res = [[data]]
    if len(data) > 2:
        for _ in range(2):
            k = int(rng.integers(1, min(6, len(data))))
            cuts = sorted(rng.choice(len(data), size=k, replace=False).tolist())
            parts, prev = [], 0
            for c in cuts + [len(data)]:
                parts.append(data[prev:c])
                prev = c
            res.append(parts)
    return res


def run(entries, corpora, rng, verbose=False,
        max_ast_bytes: int = 2048, device="cuda") -> int:
    exprs = [p for (_i, p, _f) in entries]
    flags = [f for (_i, _p, f) in entries]
    ids = [i for (i, _p, _f) in entries]

    fails = 0

    def report(kind, detail):
        nonlocal fails
        fails += 1
        print(f"FAIL [{kind}] {detail}")

    bdb = compile_on_device(exprs, flags, ids, hs.HS_MODE_BLOCK)
    sdb = compile_on_device(exprs, flags, ids, hs.HS_MODE_STREAM)
    vdb = compile_on_device(exprs, flags, ids, hs.HS_MODE_VECTORED)
    rdb = hs.deserialize_database(hs.serialize_database(bdb))

    # per-pattern oracle databases (single-compile cross-check);
    # combinations reference sibling expressions and cannot stand alone
    singles = {}
    for (i, p, f) in entries:
        if f & hs.HS_FLAG_COMBINATION:
            continue
        singles[i] = compile_on_device([p], [f], [i])

    def _valid_utf8(data: bytes) -> bool:
        try:
            data.decode("utf-8")
            return True
        except UnicodeDecodeError:
            return False

    for data in corpora:
        data_utf8 = _valid_utf8(data)
        # Python AST/NFA oracles are O(n * positions) interpreted — on
        # file corpora past this size only the C-level `re` truths diff
        # match sets (reference: hscollider file corpora run against
        # PCRE GroundTruth; GraphTruth is reserved for what PCRE can't)
        ast_ok = len(data) <= max_ast_bytes
        block = hs.scan(bdb, data, device=device)
        got: Dict[int, Set[int]] = {}
        got_t: Dict[int, Set[tuple]] = {}
        for (mid, frm, to) in block:
            got.setdefault(mid, set()).add(to)
            got_t.setdefault(mid, set()).add((frm, to))

        # oracle diff (skip combination/prefilter patterns)
        for (i, p, f) in entries:
            if f & ORACLE_SKIP:
                continue
            ext_irrelevant = f & (hs.HS_FLAG_QUIET | hs.HS_FLAG_SINGLEMATCH)
            if ext_irrelevant:
                continue
            if (f & hs.HS_FLAG_UTF8) and not data_utf8:
                # scanning invalid UTF-8 with a UTF8 pattern is UNDEFINED
                # in the reference (src/hs_compile.h HS_FLAG_UTF8 docs);
                # self-consistency checks below still apply
                continue
            if ast_ok:
                want = ast_match_ends(parse(p, f), data)
                if got.get(i, set()) != want:
                    report("oracle",
                           f"id {i} pattern {p!r} corpus {data[:40]!r}: "
                           f"{sorted(got.get(i, set()))} != {sorted(want)}")
            # independent PCRE-style truth (reference: GroundTruth.cpp);
            # Python `re` shares no code with the engine or AST oracle
            want_re = re_match_ends(p, f, data)
            if want_re is not None and got.get(i, set()) != want_re:
                report("re", f"id {i} pattern {p!r} corpus {data[:40]!r}: "
                       f"{sorted(got.get(i, set()))} != {sorted(want_re)}")
            # SOM: full (from, to) diffing (reference: hscollider diffs
            # exact ResultSets incl. from, tools/hscollider/ResultSet.h)
            if f & hs.HS_FLAG_SOM_LEFTMOST:
                if ast_ok:
                    som = ast_leftmost_som(parse(p, f), data)
                    want_t = {(s, e) for (e, s) in som.items()}
                    if got_t.get(i, set()) != want_t:
                        report("som", f"id {i} pattern {p!r} corpus "
                               f"{data[:40]!r}: "
                               f"{sorted(got_t.get(i, set()))} "
                               f"!= {sorted(want_t)}")
                som_re = re_leftmost_som(p, f, data)
                if som_re is not None:
                    want_rt = {(s, e) for (e, s) in som_re.items()}
                    if got_t.get(i, set()) != want_rt:
                        report("som-re", f"id {i} pattern {p!r} corpus "
                               f"{data[:40]!r}")

        # serialize round trip
        if hs.scan(rdb, data, device=device) != block:
            report("serialize", f"corpus {data[:40]!r}")

        # single-compile equivalence
        for (i, p, f) in entries:
            if f & hs.HS_FLAG_COMBINATION:
                continue
            single = set(hs.scan(singles[i], data, device=device))
            multi = {(i, fr, t) for (fr, t) in got_t.get(i, set())}
            if single != multi:
                report("single-vs-multi", f"id {i} corpus {data[:40]!r}")

        # streaming splits; every other split also round-trips the
        # stream state codec between writes and checks copy_stream
        # independence (reference: UltimateTruth.cpp compression sweeps).
        # Full (id, from, to) triples are diffed — SOM starts must
        # survive write boundaries and the state codec.
        want_set = set(block)
        for si, parts in enumerate(_splits(data, rng)):
            st = hs.open_stream(sdb, device=device)
            ms = []
            for pi, part in enumerate(parts):
                ms.extend(hs.scan_stream(st, part))
                if si % 2 == 1:
                    st = hs.expand_stream(sdb, hs.compress_stream(st),
                                          device=device)
                elif pi == 0 and len(parts) > 1:
                    st = hs.copy_stream(st)
            ms.extend(hs.close_stream(st))
            got_s = set(ms)
            if got_s != want_set:
                report("stream", f"splits {[len(x) for x in parts]} corpus "
                       f"{data[:40]!r}: {sorted(got_s)} != {sorted(want_set)}")
            vect = set(hs.scan_vector(vdb, parts, device=device))
            if vect != want_set:
                report("vectored", f"splits {[len(x) for x in parts]}")

    return fails


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("patterns")
    ap.add_argument("--corpus", action="append", default=[],
                    help="file scanned as an extra corpus (repeatable)")
    ap.add_argument("--corpus-dir",
                    help="directory of file corpora (every regular file)")
    ap.add_argument("--max-ast-bytes", type=int, default=2048,
                    help="corpora beyond this diff only vs the `re` truth")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device the scans run on (default: the "
                         "CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    entries = []
    with open(args.patterns, "r", errors="replace") as f:
        for line in f:
            parsed = parse_line(line)
            if parsed:
                entries.append(parsed)
    if not entries:
        print("no patterns")
        return 2
    rng = np.random.default_rng(args.seed)
    corpora = _gen_corpora(entries, rng)
    corpus_files = list(args.corpus)
    if args.corpus_dir:
        import os

        corpus_files += sorted(
            os.path.join(args.corpus_dir, n)
            for n in os.listdir(args.corpus_dir)
            if os.path.isfile(os.path.join(args.corpus_dir, n)))
    for path in corpus_files:
        with open(path, "rb") as f:
            corpora.append(f.read())

    fails = run(entries, corpora, rng, verbose=args.verbose,
                max_ast_bytes=args.max_ast_bytes, device=device)
    total_checks = len(corpora) * (3 + 2 * len(entries))
    if fails:
        print(f"COLLIDER: {fails} failures")
        return 1
    print(f"COLLIDER: all consistent ({len(entries)} patterns x "
          f"{len(corpora)} corpora, ~{total_checks} checks)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
