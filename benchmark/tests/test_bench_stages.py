"""The readers of the program's stage spans and counters
(`harness/stages.py`): the named-idle share over a hand-made trace, the
arithmetic of the span and counter readers, None from a program that
has no `trace` module, and whole traced runs of the block and stream
cells on the CPU that report every span and counter metric."""

import json
import socket
import subprocess
import sys

import pytest

import hyperscan_tpu_torch as ht
from hyperscan_tpu_torch import trace as T

from harness import devtrace, spec, stages
from harness.loops import Phase
from harness.readers import GIB

BLOCK, STREAM = "snort10k_block.bulk1m", "snort10k_stream.flows16k-mss"
SEED = 2**31 + 11
NEW = [m for m in spec.benchmark()["per_layer"]
       if m["name"].split(".")[0] in ("span_ms_per_gib", "chain_us_per_expr",
                                      "redispatches_per_call",
                                      "device_idle_named_pct")]
PROGRAM = [m for m in NEW if not m["name"].startswith("device_")]


class FakeRun:
    def __init__(self, kind, trace=None, nbytes=GIB, calls=4):
        self.kind, self.chips = kind, 1
        self.traced = Phase(calls=calls, bytes=nbytes, seconds=1.0)
        self.trace = trace


def _x(name, cat, ts, dur, tid=1):
    return {"name": name, "cat": cat, "ph": "X", "ts": ts, "dur": dur,
            "pid": 1, "tid": tid}


def test_idle_named_hand_made_trace():
    """Three idle gaps: one under no host event, one whose innermost
    event is hs.chains nested in hs.scan_batch on thread 1, one whose
    innermost is hs.verify on thread 2; 600 of 700 us named."""
    ev = [_x(devtrace.WINDOW, "user_annotation", 0, 1000),
          _x("kernel_a", "kernel", 100, 100, tid=7),
          _x("Memcpy HtoD", "gpu_memcpy", 600, 100, tid=7),
          _x("kernel_b", "kernel", 900, 100, tid=7),
          _x("bench.scan_batch", "user_annotation", 150, 730),
          _x("hs.scan_batch", "user_annotation", 160, 710),
          _x("hs.chains", "user_annotation", 300, 200),
          _x("aten::slice", "cpu_op", 310, 5),
          _x("hs.verify", "user_annotation", 780, 40, tid=2)]
    t = devtrace.reduce(ev)
    assert t.gaps == pytest.approx({"(no host event)": 100e-6,
                                    "hs.chains": 400e-6,
                                    "hs.verify": 200e-6})
    assert stages.idle_named_pct(FakeRun("block", t), "block") == \
        pytest.approx(100 * 600 / 700)
    assert stages.idle_named_pct(FakeRun("block", t), "stream") is None
    bare = devtrace.reduce([e for e in ev if not e["name"].startswith("hs.")])
    assert stages.idle_named_pct(FakeRun("block", bare), "block") is None
    assert stages.idle_named_pct(FakeRun("block"), "block") is None


def test_span_and_counter_arithmetic(monkeypatch):
    p = T.Profiled(spans={"hs.scan_batch": 4, "hs.reports": 4,
                          "hs.chains": 8, "hs.write_start": 2},
                   self_ns={"hs.scan_batch": 3_000_000,
                            "hs.reports": 1_000_000,
                            "hs.chains": 6_000_000,
                            "hs.write_start": 5_000_000},
                   counts={"redispatches": 2, "chain_exprs": 30})
    monkeypatch.setattr(T, "PROFILED", p)
    run = FakeRun("block", nbytes=2 * GIB, calls=4)
    assert stages.span_ms_per_gib(run, "api", "block") == pytest.approx(2.0)
    assert stages.span_ms_per_gib(run, "literal", "block") == \
        pytest.approx(3.0)
    assert stages.span_ms_per_gib(run, "assembly", "block") is None
    assert stages.chain_us_per_expr(run, "block") == pytest.approx(200.0)
    assert stages.redispatches_per_call(run, "block") == 0.5
    assert stages.span_ms_per_gib(run, "api", "stream") is None
    monkeypatch.setattr(T, "PROFILED", T.Profiled())
    assert stages.redispatches_per_call(run, "block") is None


def test_program_without_trace_reads_none(monkeypatch):
    """Against a program with no `trace` module every new reader returns
    None and raises nothing."""
    monkeypatch.delattr(ht, "trace")
    monkeypatch.setitem(sys.modules, "hyperscan_tpu_torch.trace", None)
    with pytest.raises(ImportError):
        from hyperscan_tpu_torch import trace  # noqa: F401
    for m in NEW:
        kind = "stream" if m["name"].endswith(".stream") else "block"
        assert spec.metric_reader(m["name"])(FakeRun(kind)) is None


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("cell", [BLOCK, STREAM])
def test_traced_cpu_run_reports_stage_metrics(cell, tmp_path):
    """A traced run of the cell on the CPU at a small size reports every
    span and counter metric of the cell (the named-idle share needs a
    device trace, which the CPU has not)."""
    helper = str(spec.BENCH / "tests" / "cpu_cell.py")
    out = subprocess.run(
        [sys.executable, helper, cell, str(SEED), "1.0", str(tmp_path),
         "1", "0", str(_free_port())], capture_output=True, text=True,
        cwd=str(spec.ROOT), timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    want = {m["name"]: m["unit"] for m in PROGRAM
            if cell in m["workloads"]}
    assert len(want) == (5 if cell == BLOCK else 4)
    got = {k: v["unit"] for k, v in line["metrics"].items() if k in want}
    assert got == want
    for k in want:
        assert line["metrics"][k]["value"] >= 0
    kind = "block" if cell == BLOCK else "stream"
    assert line["metrics"][f"chain_us_per_expr.{kind}"]["value"] > 0
