"""hsdump — compiled database introspection (reference: tools/hsdump).

Prints the engine assignment and table statistics of a database compiled
from a pattern file (or deserialized from a .db file).

The port's copy of `hyperscan_tpu.tools.hsdump`, over the port's
compile side (needs no device).

Usage:
  python -m hyperscan_tpu_torch.tools.hsdump patterns.txt [--mode stream]
  python -m hyperscan_tpu_torch.tools.hsdump --db database.bin
"""

from __future__ import annotations

import argparse
import sys

import hyperscan_tpu_torch as hs

from .hscheck import MODES, parse_line


def dump(db) -> None:
    print(f"Database: mode={db.mode:#x} patterns={db.num_patterns} "
          f"size={hs.database_size(db)}B")
    print(f"Info: {hs.database_info(db)}")
    for i, p in enumerate(db.patterns):
        kind = "combination" if p.combination is not None else "pattern"
        print(f"  expr {i}: id={p.external_id} flags={p.flags:#x} {kind} "
              f"width=[{p.min_width},"
              f"{'inf' if p.max_width is None else p.max_width}]")
    if db.lit is not None:
        lit = db.lit
        M, W, _ = lit.masks.shape
        print(f"Literal engine: {lit.num_factors} factors, "
              f"{len(lit.bucket_factors)} buckets, M={M}, words={W}")
        print(f"  validators: {sorted(lit.validators)}")
        print(f"  som/min_length reverse validators: "
              f"{sorted(lit.rev_validators)}")
        if lit.anchored_refs:
            by_sfx = {}
            for (e, d, h, _pfx, svid, sw) in lit.anchored_refs:
                by_sfx.setdefault(svid, []).append(e)
            print(f"  anchored refs: {len(lit.anchored_refs)} across "
                  f"{len(lit.sfx_validators)} shared suffix automata")
            for svid, exprs in sorted(by_sfx.items()):
                states = (lit.sfx_validators[svid].trans.shape[0]
                          if svid >= 0 else 0)
                print(f"    suffix {svid} ({states} states): "
                      f"{len(set(exprs))} exprs")
        for fid, atoms in enumerate(lit.factor_atoms[:40]):
            txt = "".join(
                chr(v) if 32 <= v < 127 and m == 0xFF else f"<{v:02x}&{m:02x}>"
                for (v, m) in atoms
            )
            refs = [e for (e, *_r) in lit.factor_refs[fid]]
            print(f"  factor {fid}: {txt!r} -> exprs {refs}")
        if lit.num_factors > 40:
            print(f"  ... {lit.num_factors - 40} more factors")
    if db.lit is not None and db.lit.chains:
        for eidx, ch in sorted(db.lit.chains.items()):
            R = ch.num_roles
            def _gap(r):
                inf = getattr(ch, "infix", {}).get(r)
                if inf is not None:
                    P = len(inf.follow) - 1  # minus the virtual pre-start
                    eps = "eps," if inf.nullable else ""
                    return f"infix<{eps}{P}pos>"
                lo = ch.gap_lo[r]
                hi = "inf" if ch.gap_hi[r] is None else ch.gap_hi[r]
                return f"[{lo},{hi}]"

            gaps = ", ".join(_gap(r) for r in range(R - 1))
            extra = ""
            if ch.lead is not None:
                extra += (f" lead[{ch.lead[1]},"
                          f"{'inf' if ch.lead[2] is None else ch.lead[2]}]")
            if ch.trail is not None:
                extra += (f" trail[{ch.trail[1]},"
                          f"{'inf' if ch.trail[2] is None else ch.trail[2]}]")
            print(f"Chain expr {eidx}: {R} roles, gaps {gaps}{extra}")
    from hyperscan_tpu_torch.database import LbrEngine, NfaEngine, SomEngine

    for ei, e in enumerate(db.engines):
        depth = "unbounded" if e.max_depth is None else str(e.max_depth)
        if isinstance(e, LbrEngine):
            print(f"LBR engine {ei}: repeat[{e.lo},"
                  f"{'inf' if e.hi is None else e.hi}] expr={e.eidx}")
        elif isinstance(e, SomEngine):
            exprs = sorted(set(e.set_exprs.tolist()))
            print(f"SOM-NFA engine {ei}: positions={e.num_positions} "
                  f"depth={depth} exprs={exprs}")
        elif isinstance(e, NfaEngine):
            exprs = sorted(set(e.set_exprs.tolist()))
            print(f"bit-NFA engine {ei}: positions={e.num_positions} "
                  f"acyclic={e.acyclic} depth={depth} exprs={exprs}")
        else:
            exprs = sorted(set(e.set_exprs.tolist()))
            print(f"DFA engine {ei}: states={e.num_states} "
                  f"classes={e.trans.shape[1]} depth={depth} exprs={exprs}")


def dump_dot(expression: str, flags: int = 0) -> str:
    """Graphviz dot of one pattern's (assertion-resolved) Glushkov NFA
    (reference: DUMP_SUPPORT dot dumps, src/nfagraph/ng_dump.cpp)."""
    from hyperscan_tpu_torch.compiler.glushkov import build_nfa
    from hyperscan_tpu_torch.compiler.parser import parse

    g = build_nfa(parse(expression, flags))
    lines = ["digraph nfa {", "  rankdir=LR;",
             '  start [shape=point]; startds [shape=point];']
    for p in range(g.num_positions):
        bits = g.reach[p]
        import numpy as np

        members = np.flatnonzero(bits)
        if len(members) == 256:
            label = "."
        elif len(members) <= 4:
            label = "".join(
                chr(b) if 32 <= b < 127 else f"\\x{b:02x}"
                for b in members.tolist()
            )
        else:
            label = f"[{len(members)} bytes]"
        shape = "doublecircle" if (p in g.accept or p in g.accept_eod) \
            else "circle"
        lines.append(f'  p{p} [label="{label}", shape={shape}];')
    for p in sorted(g.anchored_first):
        lines.append(f"  start -> p{p};")
    for p in sorted(g.float_first):
        lines.append(f"  startds -> p{p};")
    for u in range(g.num_positions):
        for v in sorted(g.follow[u]):
            lines.append(f"  p{u} -> p{v};")
    lines.append("}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("patterns", nargs="?")
    ap.add_argument("--db")
    ap.add_argument("--mode", choices=sorted(MODES), default="block")
    ap.add_argument("--dot", action="store_true",
                    help="emit graphviz dot of each pattern's NFA instead")
    args = ap.parse_args(argv)

    if args.dot and args.patterns:
        with open(args.patterns, "r", errors="replace") as f:
            for line in f:
                e = parse_line(line)
                if e:
                    print(f"// id {e[0]}: {e[1]!r}")
                    print(dump_dot(e[1], e[2]))
        return 0

    if args.db:
        with open(args.db, "rb") as f:
            db = hs.deserialize_database(f.read())
    elif args.patterns:
        entries = []
        with open(args.patterns, "r", errors="replace") as f:
            for line in f:
                p = parse_line(line)
                if p:
                    entries.append(p)
        db = hs.compile_multi(
            [p for (_i, p, _f) in entries],
            flags=[f for (_i, _p, f) in entries],
            ids=[i for (i, _p, _f) in entries],
            mode=MODES[args.mode],
        )
    else:
        print("need a pattern file or --db")
        return 2
    dump(db)
    return 0


if __name__ == "__main__":
    sys.exit(main())
