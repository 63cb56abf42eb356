"""Reduction of a `torch.profiler` trace (its Chrome trace export) to what
the device did in the traced window: busy time, kernel time by name, the
host-to-device copies, the collectives' kernels, and the device's idle
gaps named by what the host was doing across them.

The window is the host span `WINDOW` that the loop opens around the
traced half. A device event is a kernel, a copy or a memset; busy time
is the union of their intervals inside the window.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Tuple

import numpy as np

WINDOW = "bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
             "python_function")
NAME_CHARS = 96  # a kernel's name is cut to this many characters
NAMED_GAPS = 5000  # the longest gaps are named; the rest are summed


def is_collective(name: str) -> bool:
    return "nccl" in name.lower()


@dataclasses.dataclass
class DeviceTrace:
    window_s: float
    busy_s: float
    kernel_s: float  # every kernel but the collectives'
    collective_s: float
    h2d_bytes: int
    h2d_s: float
    ops: Dict[str, float]  # device seconds by kernel or copy name
    gaps: Dict[str, float]  # idle seconds by the host event across them

    def top_ops(self, n: int = 10) -> List[list]:
        return [[k, v] for k, v in sorted(self.ops.items(),
                                          key=lambda kv: -kv[1])[:n]]

    def top_gaps(self, n: int = 10) -> List[list]:
        return [[k, v] for k, v in sorted(self.gaps.items(),
                                          key=lambda kv: -kv[1])[:n]]


def _union(iv: np.ndarray) -> np.ndarray:
    """Merged, sorted intervals of an [n, 2] array."""
    if not len(iv):
        return iv
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    out = [list(iv[0])]
    for a, b in iv[1:]:
        if a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return np.asarray(out, dtype=np.float64)


def reduce(events: List[dict]) -> Optional[DeviceTrace]:
    """The window's device summary from a Chrome trace's events, or None
    when the trace holds no window or no device event in it."""
    win = [e for e in events if e.get("name") == WINDOW
           and e.get("cat") == "user_annotation" and "dur" in e]
    if not win:
        return None
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev = [e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e
           and float(e["ts"]) < w1 and float(e["ts"]) + float(e["dur"]) > w0]
    if not dev:
        return None
    ops: Dict[str, float] = {}
    kernel_us = coll_us = h2d_us = 0.0
    h2d_bytes = 0
    iv = []
    for e in dev:
        a = max(float(e["ts"]), w0)
        b = min(float(e["ts"]) + float(e["dur"]), w1)
        iv.append((a, b))
        dur = b - a
        name = str(e.get("name", "?"))[:NAME_CHARS]
        ops[name] = ops.get(name, 0.0) + dur * 1e-6
        if e["cat"] == "kernel":
            if is_collective(name):
                coll_us += dur
            else:
                kernel_us += dur
        elif e["cat"] == "gpu_memcpy" and "HtoD" in name:
            h2d_us += dur
            h2d_bytes += int((e.get("args") or {}).get("bytes", 0))
    busy = _union(np.asarray(iv, dtype=np.float64))
    busy_us = float((busy[:, 1] - busy[:, 0]).sum())
    return DeviceTrace(
        window_s=(w1 - w0) * 1e-6, busy_s=busy_us * 1e-6,
        kernel_s=kernel_us * 1e-6, collective_s=coll_us * 1e-6,
        h2d_bytes=h2d_bytes, h2d_s=h2d_us * 1e-6, ops=ops,
        gaps=_gap_names(events, busy, w0, w1))


def _gaps(busy: np.ndarray, w0: float, w1: float) -> List[Tuple[float, float]]:
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    return [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]


def _gap_names(events, busy, w0, w1) -> Dict[str, float]:
    """Idle seconds by the innermost host event open at each gap's middle
    (the longest NAMED_GAPS gaps; the others under "(shorter gaps)")."""
    host = [e for e in events if e.get("cat") in HOST_CATS and "dur" in e
            and e.get("name") != WINDOW]
    hs = np.asarray([float(e["ts"]) for e in host], dtype=np.float64)
    he = hs + np.asarray([float(e["dur"]) for e in host], dtype=np.float64)
    names = [str(e["name"])[:NAME_CHARS] for e in host]
    gaps = sorted(_gaps(busy, w0, w1), key=lambda g: g[0] - g[1])
    out: Dict[str, float] = {}
    for k, (a, b) in enumerate(gaps):
        name = "(shorter gaps)"
        if k < NAMED_GAPS:
            mid = 0.5 * (a + b)
            open_ = np.nonzero((hs <= mid) & (he >= mid))[0]
            name = (names[open_[np.argmin(he[open_] - hs[open_])]]
                    if len(open_) else "(no host event)")
        out[name] = out.get(name, 0.0) + (b - a) * 1e-6
    return out


def load(path) -> List[dict]:
    with open(path) as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data
