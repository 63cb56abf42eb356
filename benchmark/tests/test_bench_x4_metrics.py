"""The readers of the four-card cell's per-layer metrics
(`metrics/*.x4.py`) on hand-built runs: their arithmetic on rank 0's
traced half, None off the four-card cell, None with nothing to read, and
a program without the exchange's span and counters (the parent of the
change that added them)."""

import pytest

from hyperscan_tpu_torch import trace as T

from harness import devtrace, spec
from harness.loops import Phase
from harness.readers import GIB

X4 = "snort10k_block_x4.bulk1m"
READERS = ["collective_ms_per_call.x4", "span_ms_per_gib.exchange.x4",
           "exchange_kib_per_call.x4", "span_ms_per_gib.literal.x4",
           "span_ms_per_gib.assembly.x4"]


class FakeRun:
    def __init__(self, chips=4, trace=None, nbytes=2 * GIB, calls=8):
        self.kind, self.chips = "block", chips
        self.traced = Phase(calls=calls, bytes=nbytes, seconds=1.0)
        self.trace = trace


def _trace(collective_s):
    return devtrace.DeviceTrace(window_s=1.0, busy_s=0.2, kernel_s=0.1,
                                collective_s=collective_s, h2d_bytes=0,
                                h2d_s=0.0, ops={}, gaps={})


def _profiled(exchange=True):
    spans = {"hs.scan_batch": 8, "hs.assemble": 8, "hs.upload": 8,
             "hs.dispatch": 8, "hs.fetch": 8, "hs.verify": 8,
             "hs.windows": 8, "hs.chains": 8}
    self_ns = {"hs.scan_batch": 1_000_000, "hs.assemble": 3_000_000,
               "hs.upload": 1_000_000, "hs.dispatch": 500_000,
               "hs.fetch": 500_000, "hs.verify": 2_000_000,
               "hs.windows": 1_000_000, "hs.chains": 2_000_000}
    counts = {"redispatches": 0, "chain_exprs": 40, "chain_passes": 16}
    if exchange:
        spans["hs.exchange"] = 8
        self_ns["hs.exchange"] = 4_000_000
        counts.update(exchanges=8, exchange_bytes=8 * 32768)
    return T.Profiled(spans=spans, self_ns=self_ns, counts=counts)


def _read(name, run):
    return spec.metric_reader(name)(run)


def test_listed_for_the_x4_cell_alone():
    per_layer = {m["name"]: m for m in spec.benchmark()["per_layer"]}
    for name in READERS:
        m = per_layer[name]
        assert m["workloads"] == [X4] and m["moves"] == "block_gbps"


def test_arithmetic(monkeypatch):
    """Over 2 GiB and 8 calls: 4 ms of exchange, 8 x 32 KiB handed to
    it, 6 ms of literal spans, 4 ms of assembly, 24 ms of NCCL."""
    monkeypatch.setattr(T, "PROFILED", _profiled())
    run = FakeRun(trace=_trace(0.024))
    assert _read("collective_ms_per_call.x4", run) == pytest.approx(3.0)
    assert _read("span_ms_per_gib.exchange.x4", run) == pytest.approx(2.0)
    assert _read("exchange_kib_per_call.x4", run) == pytest.approx(32.0)
    assert _read("span_ms_per_gib.literal.x4", run) == pytest.approx(3.0)
    assert _read("span_ms_per_gib.assembly.x4", run) == pytest.approx(2.0)


@pytest.mark.parametrize("name", READERS)
def test_none_off_the_x4_cell(name, monkeypatch):
    """A one-card run of the block cell: no collective, no exchange."""
    monkeypatch.setattr(T, "PROFILED", _profiled(exchange=False))
    assert _read(name, FakeRun(chips=1, trace=_trace(0.0))) is None


@pytest.mark.parametrize("name", READERS)
def test_none_with_nothing_to_read(name, monkeypatch):
    """An untraced run, and a traced half with no span and no call."""
    monkeypatch.setattr(T, "PROFILED", T.Profiled())
    run = FakeRun(trace=_trace(0.0))
    assert _read(name, run) is None
    run.traced = None
    run.trace = None
    assert _read(name, run) is None


def test_program_without_the_exchange(monkeypatch):
    """A program that has the stage spans but not `hs.exchange`,
    `exchanges` or `exchange_bytes` reads the literal and assembly
    shares and no exchange metric."""
    monkeypatch.setattr(T, "PROFILED", _profiled(exchange=False))
    run = FakeRun(trace=_trace(0.024))
    assert _read("span_ms_per_gib.exchange.x4", run) is None
    assert _read("exchange_kib_per_call.x4", run) is None
    assert _read("span_ms_per_gib.literal.x4", run) == pytest.approx(3.0)
    assert _read("collective_ms_per_call.x4", run) == pytest.approx(3.0)
