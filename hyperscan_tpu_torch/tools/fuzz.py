"""fuzz — random pattern/corpus generation for differential testing.

Reference: tools/fuzz/*.py (aristocrats/heuristocrats generators feeding
hscheck/hscollider). Generates random PCRE-subset patterns from a small
grammar plus corpora seeded with pattern fragments, then diffs the engine
against the AST oracle.

The port's copy of `hyperscan_tpu.tools.fuzz`: the same grammar and the
same patterns and corpora from a seed. Every scan runs on `--device` (the
CUDA card by default; a missing card raises; `cpu` runs the kernels'
plain versions), and every database is compiled with
`Grey(host_scan_limit=0)` so that the fuzz corpora, far below the
128 KiB `host_scan_limit`, take the device branch and its kernels.

Usage: python -m hyperscan_tpu_torch.tools.fuzz [--rounds N] [--seed S]
           [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys
from typing import List

import numpy as np

import hyperscan_tpu_torch as hs
from hyperscan_tpu_torch.compiler.parser import parse
from hyperscan_tpu_torch.runtime.scan import resolve_device
from hyperscan_tpu_torch.utils.oracle import ast_match_ends, re_match_ends

from .hscollider import compile_on_device

_CHARS = "abcxyz019"
_CLASSES = ["[a-c]", "[^x]", r"\d", r"\w", "[xy0-3]", "."]
_ANCHORS_L = ["", "", "", "^"]
_ANCHORS_R = ["", "", "", "$"]


def gen_pattern(rng) -> str:
    def atom() -> str:
        k = rng.integers(0, 10)
        if k < 5:
            return _CHARS[rng.integers(0, len(_CHARS))]
        if k < 8:
            return _CLASSES[rng.integers(0, len(_CLASSES))]
        inner = "".join(
            _CHARS[rng.integers(0, len(_CHARS))]
            for _ in range(rng.integers(1, 4))
        )
        return f"({inner})"

    def quant(a: str) -> str:
        k = rng.integers(0, 10)
        if k < 6:
            return a
        if k == 6:
            return a + "?"
        if k == 7:
            lo = int(rng.integers(0, 3))
            hi = lo + int(rng.integers(0, 3))
            return a + f"{{{lo},{hi}}}"
        if k == 8 and a not in ("$", "^"):
            return a + "*"
        return a + "+"

    def branch() -> str:
        n = rng.integers(1, 6)
        parts = [quant(atom()) for _ in range(n)]
        if rng.integers(0, 4) == 0 and n >= 2:
            # chain shape: SEG <unbounded gap> SEG [<gap> SEG] — class
            # gaps AND general group infixes ((ab|cd)* — the full Violet
            # decomposition shape)
            n_gaps = 1 + int(rng.integers(0, 2))
            for _ in range(n_gaps):
                gap = ["[a-c]*", ".*", "[^x]+", "b*",
                       "(ab|cd)*", "(ba|c)+", "(a[bc]d|xy)*",
                       "(abc)*"][rng.integers(0, 8)]
                k = int(rng.integers(1, len(parts)))
                parts.insert(k, gap)
        if rng.integers(0, 5) == 0:
            # leading / trailing gap shape (Castle-prefix / MPV-puff):
            # gap SEG or SEG gap, incl. counted runs
            gap = ["[a-c]*", ".*", "[a-c]{2,}", "b+"][rng.integers(0, 4)]
            if rng.integers(0, 2):
                parts = [gap] + parts
            else:
                parts = parts + [gap]
        if rng.integers(0, 6) == 0:
            # DFA-blowup shape (bit-NFA route): leading skip + wide
            # bounded window, `.*a.{k}b`-class
            w = int(rng.integers(8, 24))
            skip = [".*", "[a-d]*", ""][rng.integers(0, 3)]
            parts = [skip, _CHARS[rng.integers(0, len(_CHARS))],
                     f".{{{w}}}"] + parts
        if rng.integers(0, 5) == 0:
            # factor-anchored shape: fixed word head + bounded class
            # suffix (routes to the shared-suffix-automaton validator)
            head = "".join(_CHARS[rng.integers(0, len(_CHARS))]
                           for _ in range(rng.integers(4, 9)))
            cls = _CLASSES[rng.integers(0, len(_CLASSES))]
            lo = int(rng.integers(1, 3))
            hi = lo + int(rng.integers(0, 4))
            tail = [f"{cls}{{{lo},{hi}}}",
                    f"{cls}{{{lo},{hi}}}" + _CHARS[
                        rng.integers(0, len(_CHARS))]][rng.integers(0, 2)]
            parts = [head, tail] + parts
        return "".join(parts)

    body = "|".join(branch() for _ in range(rng.integers(1, 3)))
    return (_ANCHORS_L[rng.integers(0, 4)] + body
            + _ANCHORS_R[rng.integers(0, 4)])


def gen_corpus(rng, frags: List[bytes]) -> bytes:
    blob = bytearray(
        rng.choice(np.frombuffer(_CHARS.encode() + b" ", np.uint8),
                   size=rng.integers(0, 120)).tobytes()
    )
    for frag in frags:
        if len(blob) and rng.integers(0, 2):
            off = int(rng.integers(0, len(blob)))
            blob[off:off] = frag
    return bytes(blob)


def fuzz_round(rng, n_patterns: int = 8, n_corpora: int = 6,
               device="cuda") -> List[str]:
    """Returns a list of failure descriptions (empty = consistent)."""
    flag_pool = [0, hs.HS_FLAG_CASELESS, hs.HS_FLAG_DOTALL,
                 hs.HS_FLAG_MULTILINE,
                 hs.HS_FLAG_CASELESS | hs.HS_FLAG_MULTILINE]
    pats = []
    while len(pats) < n_patterns:
        p = gen_pattern(rng)
        fl = hs.HS_FLAG_ALLOWEMPTY | flag_pool[int(rng.integers(0, 5))]
        try:
            db = compile_on_device([p], [fl], [0])
            sdb = compile_on_device([p], [fl], [0], hs.HS_MODE_STREAM)
        except hs.CompileError:
            continue
        pats.append((p, fl, db, sdb))

    fails = []
    frags = [p.encode("latin-1", "ignore").replace(b"\\", b"")[:6]
             for (p, _fl, _db, _s) in pats]
    for _ in range(n_corpora):
        data = gen_corpus(rng, frags)
        for (p, fl, db, sdb) in pats:
            want = ast_match_ends(parse(p, fl), data)
            got = {t for (_i, _f, t) in hs.scan(db, data, device=device)}
            if got != want:
                fails.append(
                    f"pattern {p!r} corpus {data!r}: "
                    f"{sorted(got)} != {sorted(want)}"
                )
                continue
            # independent ground truth (reference: PCRE GroundTruth.cpp):
            # Python `re` shares no code with the engine or the AST oracle
            want_re = re_match_ends(p, fl, data)
            if want_re is not None and got != want_re:
                fails.append(
                    f"re-oracle: pattern {p!r} corpus {data!r}: "
                    f"{sorted(got)} != {sorted(want_re)}"
                )
                continue
            # SOM: leftmost starts must match the oracle (exercises the
            # literal-route back-scans AND the som-register engine)
            if rng.integers(0, 4) == 0 and not (p.startswith("^")):
                try:
                    somdb = compile_on_device(
                        [p], [fl | hs.HS_FLAG_SOM_LEFTMOST], [0])
                except hs.CompileError:
                    somdb = None
                if somdb is not None:
                    from hyperscan_tpu_torch.utils.oracle import \
                        ast_leftmost_som

                    want_som = {
                        (s0, e)
                        for (e, s0) in ast_leftmost_som(
                            parse(p, fl | hs.HS_FLAG_SOM_LEFTMOST), data
                        ).items()
                    }
                    got_som = {
                        (m[1], m[2])
                        for m in hs.scan(somdb, data, device=device)
                    }
                    if got_som != want_som:
                        fails.append(
                            f"SOM pattern {p!r} corpus {data!r}: "
                            f"{sorted(got_som)} != {sorted(want_som)}"
                        )
                        continue
                    # SOM starts must survive write boundaries: stream
                    # the same corpus under a random split and diff the
                    # full (from, to) set against the block result
                    if len(data) > 1:
                        try:
                            somsdb = compile_on_device(
                                [p], [fl | hs.HS_FLAG_SOM_LEFTMOST], [0],
                                hs.HS_MODE_STREAM)
                        except hs.CompileError:
                            somsdb = None
                        if somsdb is not None:
                            k = int(rng.integers(1, min(5, len(data)) + 1))
                            cuts = sorted(rng.choice(
                                len(data), size=k, replace=False).tolist())
                            st = hs.open_stream(somsdb, device=device)
                            ms = []
                            prev = 0
                            for c in cuts + [len(data)]:
                                ms.extend(hs.scan_stream(st, data[prev:c]))
                                prev = c
                            ms.extend(hs.close_stream(st))
                            got_ss = {(m[1], m[2]) for m in ms}
                            if got_ss != want_som:
                                fails.append(
                                    f"SOM-STREAM pattern {p!r} corpus "
                                    f"{data!r} cuts {cuts}: "
                                    f"{sorted(got_ss)} != "
                                    f"{sorted(want_som)}"
                                )
                                continue
            # streaming under a random write split must agree with block
            if len(data) > 1:
                k = int(rng.integers(1, min(5, len(data)) + 1))
                cuts = sorted(
                    rng.choice(len(data), size=k, replace=False).tolist()
                )
                st = hs.open_stream(sdb, device=device)
                ms = []
                prev = 0
                for c in cuts + [len(data)]:
                    ms.extend(hs.scan_stream(st, data[prev:c]))
                    prev = c
                ms.extend(hs.close_stream(st))
                got_s = {t for (_i, _f, t) in ms}
                if got_s != want:
                    fails.append(
                        f"STREAM pattern {p!r} corpus {data!r} cuts {cuts}: "
                        f"{sorted(got_s)} != {sorted(want)}"
                    )
    return fails


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device the scans run on (default: the "
                         "CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    rng = np.random.default_rng(args.seed)
    total_fails = 0
    for r in range(args.rounds):
        fails = fuzz_round(rng, device=device)
        for f in fails:
            print(f"FAIL round {r}: {f}")
        total_fails += len(fails)
    if total_fails:
        print(f"FUZZ: {total_fails} failures")
        return 1
    print(f"FUZZ: {args.rounds} rounds consistent")
    return 0


if __name__ == "__main__":
    sys.exit(main())
