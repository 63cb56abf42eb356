"""What the readers of the program's own stage spans and counters share.

The program (`hyperscan_tpu_torch/trace.py`) opens an `hs.*` span at each
stage of its scan path while a `torch.profiler` records, and meanwhile
sums each span's self time (its duration less the `hs.*` spans nested in
it on its thread), the spans opened and its stage counters in
`trace.PROFILED`. In a traced run the profiler records the first half
alone, so what `PROFILED` holds after the run is that half's. The device
trace's idle gaps are named by the innermost host event open at each
gap's middle (`devtrace._gap_names`), which is an `hs.*` span wherever
the program's own Python holds the card idle.

A program without the module (before it had spans), a run with no span
in its traced half, or a cell of the other kind reads None.
"""

from __future__ import annotations

from .readers import GIB

# the spans of each layer (slugs of `layers/*.json`)
LAYER_SPANS = {
    "api": ("hs.scan_batch", "hs.reports"),
    "assembly": ("hs.assemble", "hs.upload"),
    "literal": ("hs.dispatch", "hs.fetch", "hs.verify", "hs.windows",
                "hs.chains"),
    "stream_state": ("hs.write_start", "hs.write_finish"),
}
PREFIX = "hs."


def profiled(run, kind: str):
    """The program's `trace.PROFILED` after the traced half, or None."""
    if run.kind != kind or run.traced is None:
        return None
    try:
        from hyperscan_tpu_torch import trace
    except ImportError:
        return None
    p = trace.PROFILED
    return p if p.spans else None


def span_ms_per_gib(run, layer: str, kind: str):
    """Self milliseconds of the layer's spans per GiB handed over in the
    traced half."""
    p = profiled(run, kind)
    names = LAYER_SPANS[layer]
    if p is None or not run.traced.bytes or \
            not any(n in p.spans for n in names):
        return None
    ns = sum(p.self_ns.get(n, 0) for n in names)
    return ns * 1e-6 / (run.traced.bytes / GIB)


def chain_us_per_expr(run, kind: str):
    """Self microseconds of `hs.chains` per chain expression worked
    through (`chain_exprs`)."""
    p = profiled(run, kind)
    if p is None or not p.counts.get("chain_exprs"):
        return None
    return p.self_ns.get("hs.chains", 0) * 1e-3 / p.counts["chain_exprs"]


def redispatches_per_call(run, kind: str):
    """Capacity-overflow re-dispatches (`redispatches`) per call of the
    traced half."""
    p = profiled(run, kind)
    if p is None or "redispatches" not in p.counts or not run.traced.calls:
        return None
    return p.counts["redispatches"] / run.traced.calls


def idle_named_pct(run, kind: str):
    """Share of the card's idle time in the traced half that lies in gaps
    whose innermost open host event is an `hs.*` span."""
    t = run.trace
    if run.kind != kind or t is None:
        return None
    idle = sum(t.gaps.values())
    named = [v for k, v in t.gaps.items() if k.startswith(PREFIX)]
    if idle <= 0 or not named:
        return None
    return 100.0 * sum(named) / idle
