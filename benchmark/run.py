#!/usr/bin/env python3
"""Run one cell of the benchmark of hyperscan_tpu_torch once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

The cell (`BENCHMARK.json` `workloads`) names a configuration
(`benchmark/configs/<name>.json`: the ruleset, the mode, the reference
and the control) and a traffic mix (`benchmark/traffic/<name>.json`);
every file is found by name (`harness/spec.py`). The run loads the
configuration's database (compiled once per checkout,
`harness/dbcache.py`), makes the traffic from the seed, warms up, then
drives the program's public scan calls in a closed loop for `--seconds`
and prints, as the last line of standard output, one JSON object:
`correct`, `attempted`, `failed`, `metrics`, `device`, with `--trace 1`
`breakdown`, and last `checks`.

With `--trace 0` the metrics are the cell's end-to-end metrics; with
`--trace 1` the window is run in two halves, the first under
`torch.profiler` (device trace) and the second under `cProfile` (host
time by layer), and the metrics are the cell's per-layer ones. Every
metric is read by its own file, `benchmark/metrics/<name>.py`.

After the window a sample of the answers, drawn from the seed, is held to
the configuration's plain reference (its `reference`, under
`benchmark/reference/`): every match (id, from, to) of a sampled block,
or of a sampled flow round by round and at its close.

A cell on 4 cards runs one process per card: this process is rank 0 and
starts the other ranks (this script with `--rank`), which join one
`torch.distributed` group on a free localhost port.

The run needs as many CUDA cards as the cell asks for; without them it
exits with code 2 and prints no result.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()  # the process's start, for setup_s

import argparse  # noqa: E402
import cProfile  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import pstats  # noqa: E402
import resource  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent
CACHE = BENCH / "cache"
for p in (str(BENCH), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

# the program's caches live in the checkout, at fixed paths
os.environ["XDG_CACHE_HOME"] = str(CACHE / "xdg")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")

BANNED = ("jax", "jaxlib", "flax", "hyperscan_tpu")
WORKER_WAIT_S = 120  # how long rank 0 waits for the others to end


def log(msg: str) -> None:
    print(f"[bench +{time.perf_counter() - T0:8.3f}s] {msg}",
          file=sys.stderr, flush=True)


def banned_modules() -> list:
    """Top-level names of the loaded modules that no run may hold."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


def refuse_banned() -> None:
    """End the run, with no result, if a module that no run may hold is
    loaded."""
    found = banned_modules()
    if found:
        raise SystemExit(f"modules that no run may load are loaded: {found}")


class Run:
    """What the metric readers read: the phases, the device trace and the
    host time by layer of one run."""

    def __init__(self, kind: str, chips: int, setup_s: float,
                 flows: int = 0):
        self.kind = kind
        self.chips = chips
        self.setup_s = setup_s
        self.flows = flows  # the streams a flows loop holds open
        self.peak_bytes = 0  # the fullest card's allocated peak
        self.window = None  # loops.Phase of an untraced run
        self.traced = None  # the first half of a traced run
        self.profiled = None  # its second half
        self.trace = None  # devtrace.DeviceTrace of the first half
        self.host = None  # {layer slug: seconds} of the second half


class HostUsage:
    """The process's use of the host over a window, for the log: CPU
    seconds, involuntary context switches, minor page faults and the
    cyclic collector's collections and seconds by generation."""

    def __enter__(self):
        self.gc_s = [0.0, 0.0, 0.0]
        self.gc_n = [0, 0, 0]
        self._t = 0.0
        gc.callbacks.append(self._gc)
        self.r0 = resource.getrusage(resource.RUSAGE_SELF)
        self.w0 = time.perf_counter()
        return self

    def _gc(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        else:
            g = info["generation"]
            self.gc_n[g] += 1
            self.gc_s[g] += time.perf_counter() - self._t

    def __exit__(self, *exc):
        self.wall = time.perf_counter() - self.w0
        self.r1 = resource.getrusage(resource.RUSAGE_SELF)
        gc.callbacks.remove(self._gc)

    def __str__(self):
        r0, r1 = self.r0, self.r1
        cpu = (r1.ru_utime - r0.ru_utime) + (r1.ru_stime - r0.ru_stime)
        return (f"cpu {cpu:.3f} s of {self.wall:.3f} s (sys "
                f"{r1.ru_stime - r0.ru_stime:.3f}), involuntary switches "
                f"{r1.ru_nivcsw - r0.ru_nivcsw}, minor faults "
                f"{r1.ru_minflt - r0.ru_minflt}, gc collections "
                f"{self.gc_n} in {[round(x, 4) for x in self.gc_s]} s")


def card_power() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        return r.stdout.strip().splitlines()[0].strip()
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def traced_window(loop, agree, seconds: float, trace_path, torch, layers):
    """The window in two halves: torch.profiler over the first (its
    device summary), cProfile over the second (host seconds by layer)."""
    from harness import devtrace, hostprof
    from harness.loops import run_phase

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(devtrace.WINDOW):
            first = run_phase(loop, agree, seconds / 2)
    trace_path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(trace_path))
    summary = devtrace.reduce(devtrace.load(trace_path))
    trace_path.unlink()
    prof_host = cProfile.Profile()
    prof_host.enable()
    second = run_phase(loop, agree, seconds / 2)
    prof_host.disable()
    host = hostprof.layer_seconds(pstats.Stats(prof_host), layers)
    return first, second, summary, host


def run_cell(args, rank: int, port, device_kind: str = "cuda"):
    """One rank's run. Returns rank 0's result (its JSON object and the
    lines of its checks) and None on the other ranks."""
    import numpy as np
    import torch

    from harness import dbcache, spec
    from harness import traffic as T
    from harness.loops import Agree, BlockLoop, FlowLoop, run_phase

    cell = spec.cell(args.workload)
    cfg = spec.config(cell["config"])
    mix = spec.traffic(cell["traffic"])
    chips = cell["chips"]
    # the reference and its control load in set-up, before the window
    spec.reference(cfg).CONTROLS[cfg["control"]]
    import hyperscan_tpu_torch as ht

    device = torch.device(device_kind, rank) if device_kind == "cuda" \
        else torch.device("cpu")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    mesh, agree = None, Agree()
    if chips > 1:
        from hyperscan_tpu_torch import parallel as P

        mesh = P.make_multihost_mesh(f"127.0.0.1:{port}", chips, rank,
                                     device=device_kind)
        import torch.distributed as dist

        agree = Agree(dist.new_group(backend="gloo"))
        log(f"rank {rank}: mesh {mesh}")
    db = dbcache.load(ht, cfg, log)
    tr = T.make(mix, args.seed, cfg["ruleset"], chips)
    if mix["kind"] == "blocks":
        loop = BlockLoop(ht, db, tr, args.seed, device=device, mesh=mesh,
                         digest=mesh is not None)
    else:
        loop = FlowLoop(ht, db, tr, args.seed, device=device)
    loop.warm(agree, log)
    gc.collect()
    gc.freeze()  # the set-up's objects leave the cyclic collector's scans
    setup_s = time.perf_counter() - T0
    run = Run(loop.kind, chips, setup_s, getattr(tr, "flows", 0))
    if args.trace:
        layers = spec.Layers()
        run.traced, run.profiled, run.trace, run.host = traced_window(
            loop, agree, args.seconds, CACHE / "trace" / f"rank{rank}.json",
            torch, layers)
        phases = [run.traced, run.profiled]
        named = {layers.files[k]["layer"] if k in layers.files else k: v
                 for k, v in sorted(run.host.items())}
        log(f"host seconds by layer, second half: {named}")
    else:
        with HostUsage() as usage:
            run.window = run_phase(loop, agree, args.seconds)
        log(f"window's host use: {usage}; GB/s by 5 s: "
            f"{[round(r / 1e9, 4) for r in run.window.rates()]}")
        phases = [run.window]
    gc.unfreeze()
    refuse_banned()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    loop.close()
    attempted = sum(ph.calls for ph in phases)
    lat = np.asarray([x for ph in phases for x in ph.latencies]) * 1e3
    log(f"rank {rank}: {attempted} calls, "
        f"{sum(ph.bytes for ph in phases)} bytes in "
        f"{sum(ph.seconds for ph in phases):.3f} s; call ms min "
        f"{lat.min():.2f} p50 {np.percentile(lat, 50):.2f} p95 "
        f"{np.percentile(lat, 95):.2f} max {lat.max():.2f}")

    digests, peaks, busy = [None], [peak], [run.trace.busy_s if run.trace
                                             else None]
    if mesh is not None:
        mine = (loop.digest.hexdigest(), peak, busy[0])
        gathered = [None] * chips
        dist.all_gather_object(gathered, mine, group=agree.group)
        digests = [g[0] for g in gathered]
        peaks = [g[1] for g in gathered]
        busy = [g[2] for g in gathered]
        P.close_multihost_mesh()
        if rank != 0:
            return None
    return finish(args, cell, cfg, run, loop, attempted, digests,
                  max(peaks), busy, chips, torch, device)


def finish(args, cell, cfg, run, loop, attempted, digests, peak, busy,
           chips, torch, device):
    """Rank 0: the reference check, the metrics and the result line."""
    from harness import spec

    log(f"card: {card_power()}")
    t0 = time.perf_counter()
    run.peak_bytes = peak
    ck = loop.check(cfg)
    log(f"reference check: {ck.answers} answers, {ck.compared} matches "
        f"in {time.perf_counter() - t0:.3f} s")
    checks = {"missing": {"value": ck.missing, "limit": 0},
              "extra": {"value": ck.extra, "limit": 0}}
    if len(digests) > 1:
        checks["ranks_differing"] = {
            "value": sum(d != digests[0] for d in digests), "limit": 0}
    correct = ck.compared > 0 and all(
        c["value"] <= c["limit"] for c in checks.values())
    metrics = {}
    for m in spec.metrics_of(args.workload, bool(args.trace)):
        value = spec.metric_reader(m["name"])(run)
        if value is None:
            log(f"metric {m['name']}: nothing to read")
            continue
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": chips, "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": attempted, "failed": 0,
           "metrics": metrics, "device": dev}
    if args.trace:
        if run.trace is not None:
            dev["busy_s"] = sum(b for b in busy if b is not None) / max(
                1, sum(b is not None for b in busy))
            dev["window_s"] = run.trace.window_s
            out["breakdown"] = {"device_ops": run.trace.top_ops(),
                                "idle_gaps": run.trace.top_gaps()}
    out["checks"] = checks
    lines = [f"check {k}: {v['value']} (limit {v['limit']})"
             for k, v in checks.items()]
    lines.append(f"check answers compared: {ck.answers}, matches in the "
                 f"reference: {ck.compared} (must be above 0)")
    refuse_banned()  # what the check and the metric readers loaded too
    return out, lines


def spawn_ranks(args, chips: int, port: int) -> list:
    logs = CACHE / "logs"
    logs.mkdir(parents=True, exist_ok=True)
    procs = []
    for r in range(1, chips):
        f = open(logs / f"rank{r}.log", "w")
        cmd = [sys.executable, str(pathlib.Path(__file__).resolve()),
               "--workload", args.workload, "--seed", str(args.seed),
               "--seconds", str(args.seconds), "--trace", str(args.trace),
               "--rank", str(r), "--port", str(port)]
        procs.append((subprocess.Popen(cmd, stdout=subprocess.DEVNULL,
                                       stderr=f, cwd=str(ROOT)), f))
    return procs


def end_ranks(procs) -> bool:
    """Wait for the other ranks (ending any that outlive the wait); True
    when each exited with 0. Their logs' last lines go to stderr."""
    ok = True
    for r, (p, f) in enumerate(procs, start=1):
        try:
            rc = p.wait(timeout=WORKER_WAIT_S)
        except subprocess.TimeoutExpired:
            p.kill()
            rc = p.wait()
        f.close()
        tail = (CACHE / "logs" / f"rank{r}.log").read_text(
            errors="replace").splitlines()[-6:]
        for line in tail:
            print(f"  rank {r}| {line}", file=sys.stderr)
        if rc != 0:
            log(f"rank {r} exited with {rc}")
            ok = False
    return ok


def prepare(cell: dict) -> None:
    """Before the other ranks start: the database's cache file and the
    kernels, so that the ranks do not build them side by side."""
    import hyperscan_tpu_torch as ht
    from hyperscan_tpu_torch.ops import _build

    from harness import dbcache, spec

    dbcache.ensure(ht, spec.config(cell["config"]), log)
    took = _build.build()
    if took:
        log(f"built kernels: {sorted(took)} in {max(took.values()):.1f} s")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    from harness import spec

    cell = spec.cell(args.workload)
    chips = cell["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    if args.rank is not None:  # one of the other ranks
        run_cell(args, args.rank, args.port)
        return 0
    procs = []
    port = None
    if chips > 1:
        prepare(cell)
        port = free_port()
        procs = spawn_ranks(args, chips, port)
    try:
        out, lines = run_cell(args, 0, port)
    finally:
        ranks_ok = end_ranks(procs)
    if not ranks_ok:
        return 1
    for line in lines:
        print(line, file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
