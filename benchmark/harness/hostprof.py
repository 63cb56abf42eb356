"""Host seconds by layer from a `cProfile` profile.

A function of the port gives its own time to the layer that lists its
module (`spec.Layers`). Any other function (a builtin, a C call, numpy or
torch Python) gives its own time to its callers, in proportion to the
time it spent under each; a caller outside the port passes its share on
to its own callers in proportion to their cumulative time under it, so a
`np.concatenate` called from `ops/teddy.py` counts for that layer. Time
that reaches no function of the port (the harness's own loop, the
profiler) goes to "other".
"""

from __future__ import annotations

import pstats
from typing import Dict, Tuple

Func = Tuple[str, int, str]


def layer_seconds(stats: pstats.Stats, layers) -> Dict[str, float]:
    """{layer slug or "other": seconds} of a profile's own time."""
    raw = stats.stats
    share: Dict[Func, Dict[str, float]] = {}

    def layer(f: Func):
        return layers.of_file(f[0])

    def upward(f: Func, stack: frozenset) -> Dict[str, float]:
        """Where time spent in the foreign function f belongs, as
        fractions by layer, through its callers' cumulative times."""
        if f in share:
            return share[f]
        callers = raw[f][4] if f in raw else {}
        weights = {c: e[3] for c, e in callers.items()}
        total = sum(weights.values())
        if total <= 0:
            weights = {c: e[1] for c, e in callers.items()}
            total = sum(weights.values())
        out: Dict[str, float] = {}
        if total <= 0:
            out["other"] = 1.0
        for c, w in weights.items():
            if w <= 0:
                continue
            frac = w / total
            lc = layer(c)
            if lc is not None:
                out[lc] = out.get(lc, 0.0) + frac
            elif c in stack or c not in raw:
                out["other"] = out.get("other", 0.0) + frac
            else:
                for k, v in upward(c, stack | {f}).items():
                    out[k] = out.get(k, 0.0) + frac * v
        share[f] = out  # a cycle cut short above counts as "other"
        return out

    acc: Dict[str, float] = {}
    for f, (_cc, _nc, tt, _ct, callers) in raw.items():
        if tt <= 0:
            continue
        lf = layer(f)
        if lf is not None:
            acc[lf] = acc.get(lf, 0.0) + tt
            continue
        # own time by the callers' share of it
        weights = {c: e[2] for c, e in callers.items()}
        total = sum(weights.values())
        if total <= 0:
            acc["other"] = acc.get("other", 0.0) + tt
            continue
        for c, w in weights.items():
            part = tt * w / total
            lc = layer(c)
            if lc is not None:
                acc[lc] = acc.get(lc, 0.0) + part
            elif c not in raw:
                acc["other"] = acc.get("other", 0.0) + part
            else:
                for k, v in upward(c, frozenset({f})).items():
                    acc[k] = acc.get(k, 0.0) + part * v
    return acc
