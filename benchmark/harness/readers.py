"""What the metric readers of `metrics/<name>.py` share. A reader takes
the run (`run.Run`) and returns a number, or None when the run holds
nothing for it to read; the harness then leaves the metric out."""

from __future__ import annotations

import numpy as np

from .peaks import HBM_BYTES_PER_S

GIB = float(1 << 30)


def gbps(run, kind: str, phase: str = "window"):
    """Bytes handed to the program in a phase (the untraced window, or the
    traced half of a traced run) over its seconds."""
    w = getattr(run, phase)
    if run.kind != kind or w is None or w.seconds <= 0:
        return None
    return w.bytes / w.seconds / 1e9


def p95_ms(run, phase: str = "window", kind=None):
    w = getattr(run, phase)
    if (kind is not None and run.kind != kind) or w is None \
            or not w.latencies:
        return None
    return float(np.percentile(np.asarray(w.latencies), 95)) * 1e3


def card_bytes_per_flow(run):
    """The fullest card's allocated peak over the streams held open."""
    if run.kind != "stream" or not run.flows or run.peak_bytes <= 0:
        return None
    return run.peak_bytes / run.flows


def idle_pct(run, kind: str):
    t = run.trace
    if run.kind != kind or t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def hbm_roofline_pct(run, kind: str):
    """The least time the card could take over its share of the bytes
    handed over in the traced half (each read once from HBM; on a mesh a
    card scans 1 / chips of the global batch), as a share of the summed
    time of its kernels (the collectives' left out)."""
    t = run.trace
    if run.kind != kind or t is None or t.kernel_s <= 0:
        return None
    card_bytes = run.traced.bytes / run.chips
    return 100.0 * (card_bytes / HBM_BYTES_PER_S) / t.kernel_s


def h2d_gbps(run, kind: str):
    t = run.trace
    if run.kind != kind or t is None or t.h2d_s <= 0:
        return None
    return t.h2d_bytes / t.h2d_s / 1e9


def host_ms_per_gib(run, layer: str, kind: str):
    """Host milliseconds of one layer per GiB handed over, in the
    cProfile half."""
    if run.kind != kind or run.host is None or not run.profiled.bytes:
        return None
    return run.host.get(layer, 0.0) * 1e3 / (run.profiled.bytes / GIB)


def collective_ms_per_call(run):
    t = run.trace
    if t is None or t.collective_s <= 0 or not run.traced.calls:
        return None
    return t.collective_s * 1e3 / run.traced.calls
