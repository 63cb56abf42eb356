"""The port's stage spans and counters (hyperscan_tpu_torch.trace) on the
CPU: the spans a profiled block call and StreamSet round export and how
they nest, a span count that does not grow with the batch, the no-op
while no profiler records, self time over nested spans on two threads,
the `redispatches`, `chain_exprs` and `chain_passes` counters, and on a
mesh of two processes (tests/torch_multihost_worker.py, mode "trace2")
the `hs.exchange` span, the `exchanges` and `exchange_bytes` counters and
host stage spans of the process's own shards alone."""

import json
import os
import sys
import threading

import pytest
import torch

import hyperscan_tpu_torch as ht
from hyperscan_tpu_torch import parallel as P
from hyperscan_tpu_torch import trace as T
from hyperscan_tpu_torch.runtime import streamset as SS
from hyperscan_tpu_torch.runtime.smallwrite import HOST_SCAN_LIMIT

sys.path.insert(0, os.path.dirname(__file__))
import torch_multihost_worker as W  # noqa: E402

CPU = "cpu"
# three chain expressions (ids 1-3) and a plain literal (id 4)
PATTERNS = W.TRACE_PATTERNS
BLOCK_SPANS = {"hs.scan_batch", "hs.reports", "hs.assemble", "hs.upload",
               "hs.dispatch", "hs.fetch", "hs.verify", "hs.windows",
               "hs.chains"}
STREAM_SPANS = {"hs.write_start", "hs.write_finish", "hs.upload",
                "hs.dispatch", "hs.fetch", "hs.verify", "hs.windows",
                "hs.chains"}


def _db(mode=ht.HS_MODE_BLOCK, host_scan_limit=None):
    db = ht.compile_multi(PATTERNS, ids=[1, 2, 3, 4], mode=mode)
    if host_scan_limit is not None:
        db.host_scan_limit = host_scan_limit
    return db


def _block(i: int, size: int) -> bytes:
    head = b"x lead1234tail y alpha%02dzzomega attack " % (i % 100)
    return (head + b"." * size)[:size]


def _profiled(fn, tmp_path):
    """fn() under torch.profiler: its result and the exported trace's
    hs.* events, in start order."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        out = fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    hs = [e for e in events if str(e.get("name", "")).startswith("hs.")
          and e.get("ph") == "X"]
    return out, sorted(hs, key=lambda e: float(e["ts"]))


def _inside(inner, outer) -> bool:
    a0, b0 = float(outer["ts"]), float(outer["ts"]) + float(outer["dur"])
    a1, b1 = float(inner["ts"]), float(inner["ts"]) + float(inner["dur"])
    return inner["tid"] == outer["tid"] and a0 <= a1 and b1 <= b0


def _one(events, name):
    got = [e for e in events if e["name"] == name]
    assert len(got) == 1, (name, len(got))
    return got[0]


def test_block_call_spans_nest(tmp_path):
    """A scan_batch past HOST_SCAN_LIMIT on the CPU exports every block
    span as a user_annotation; the stages nest under hs.scan_batch."""
    db = _db()
    blocks = [_block(i, 40 << 10) for i in range(4)]
    assert sum(map(len, blocks)) > HOST_SCAN_LIMIT
    want = ht.scan_batch(db, blocks, device=CPU)
    got, events = _profiled(lambda: ht.scan_batch(db, blocks, device=CPU),
                            tmp_path)
    assert got == want and all(got)
    assert {e["name"] for e in events} == BLOCK_SPANS
    assert all(e.get("cat") == "user_annotation" for e in events)
    root = _one(events, "hs.scan_batch")
    for e in events:
        assert _inside(e, root), e["name"]
    assert _inside(_one(events, "hs.chains"), _one(events, "hs.windows"))
    assert _inside(_one(events, "hs.upload"), root)


def test_streamset_round_spans_nest(tmp_path):
    """One StreamSet round: hs.upload and hs.dispatch under
    hs.write_start, the host stages under hs.write_finish."""
    db = _db(ht.HS_MODE_STREAM, host_scan_limit=0)
    S = 8
    ss = SS.open_streamset(db, S, device=CPU)
    chunks = [_block(i, 512) for i in range(S)]

    def round_():
        h = SS.streamset_write_start(db, ss, chunks)
        return SS.streamset_write_finish(db, ss, h)

    out, events = _profiled(round_, tmp_path)
    assert all(out)
    assert {e["name"] for e in events} == STREAM_SPANS
    start, finish = (_one(events, "hs.write_start"),
                     _one(events, "hs.write_finish"))
    for name in ("hs.upload", "hs.dispatch"):
        assert _inside(_one(events, name), start), name
    for name in ("hs.fetch", "hs.verify", "hs.windows", "hs.chains"):
        assert _inside(_one(events, name), finish), name


def _spans_of(fn):
    T.reset_profiled()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        fn()
    return dict(T.PROFILED.spans)


def test_span_count_does_not_grow_with_the_batch():
    """A call opens as many spans for 4 blocks as for 64, and a round as
    many for 16 flows as for 256."""
    db = _db(host_scan_limit=0)
    counts = []
    for n in (4, 64):
        blocks = [_block(i, 2048) for i in range(n)]
        ht.scan_batch(db, blocks, device=CPU)  # learn the capacities
        counts.append(_spans_of(
            lambda: ht.scan_batch(db, blocks, device=CPU)))
    assert counts[0] == counts[1] and set(counts[0]) == BLOCK_SPANS

    sdb = _db(ht.HS_MODE_STREAM, host_scan_limit=0)
    counts = []
    for S in (16, 256):
        ss = SS.open_streamset(sdb, S, device=CPU)
        chunks = [_block(i, 256) for i in range(S)]
        SS.scan_streamset(sdb, ss, chunks)
        counts.append(_spans_of(lambda: SS.scan_streamset(sdb, ss, chunks)))
    assert counts[0] == counts[1] and set(counts[0]) == STREAM_SPANS


def test_no_profiler_no_spans():
    """While no profiler records, span() is the shared no-op and a scan
    leaves nothing in PROFILED."""
    assert T.span("hs.scan_batch") is T.NOOP
    with T.span("hs.x") as s:
        assert s is T.NOOP
    T.reset_profiled()
    db = _db(host_scan_limit=0)
    ht.scan_batch(db, [_block(0, 4096)], device=CPU)
    assert T.PROFILED.spans == {} and T.PROFILED.self_ns == {}
    assert set(T.PROFILED.counts.values()) == {0}


def test_self_time_nested_and_threads(monkeypatch):
    """Self time is a span's duration less its children on its own
    thread: a span on another thread opened meanwhile is no child."""
    clock = [0]
    monkeypatch.setattr(T, "_clock", lambda: clock[0])

    def other():
        clock[0] = 100
        with T.span("hs.b"):
            clock[0] = 107

    T.reset_profiled()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        clock[0] = 0
        with T.span("hs.outer"):
            t = threading.Thread(target=other)
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
            clock[0] = 110
            with T.span("hs.inner"):
                clock[0] = 130
            clock[0] = 150
    assert T.PROFILED.self_ns == {"hs.outer": 130, "hs.inner": 20,
                                  "hs.b": 7}
    assert T.PROFILED.spans == {"hs.outer": 1, "hs.inner": 1, "hs.b": 1}


def test_redispatches_on_overflow_then_none_warm():
    """A round started before an earlier round taught the database a
    larger load overflows and is dispatched again; the same rounds on
    the warmed database dispatch once each."""
    db = ht.compile_multi(["aaaa", "attack"], ids=[1, 2],
                          mode=ht.HS_MODE_STREAM)
    db.host_scan_limit = 64
    S = 4
    writes = [[b"x attack y" * 10] * S, [b"a" * 3000] * S]

    def rounds():
        ss = SS.open_streamset(db, S, device=CPU)
        before = T.COUNTS["redispatches"]
        handles = [SS.streamset_write_start(db, ss, w) for w in writes]
        for h in handles:
            SS.streamset_write_finish(db, ss, h)
        return T.COUNTS["redispatches"] - before

    assert rounds() > 0
    assert rounds() == 0


def test_chain_exprs_counts_the_block_chains():
    """chain_exprs rises by the chain expressions whose final role has a
    window in the block: one, two, none."""
    db = _db(host_scan_limit=0)
    assert sorted(db.lit.chains) == [0, 1, 2]
    for block, n in ((b"x lead1234tail attack y", 1),
                     (b"lead1234tail gamma  delta alpha", 2),
                     (b"attack alpha only lead", 0)):
        before = T.COUNTS["chain_exprs"]
        ht.scan_batch(db, [block], device=CPU)
        assert T.COUNTS["chain_exprs"] - before == n, block


def test_chain_passes_do_not_grow_with_the_chains():
    """chain_passes rises by as much for 1, 8 and 50 chain matches of
    distinct rules (a forward pass over the windows, a reverse pass from
    the role matches), and not at all where no chain window and no
    carried state exist."""
    import bench

    pats, ids = bench._patterns(300)
    gates = [(p, i) for p, i in zip(pats, ids) if i % 6 == 5]
    assert len(gates) == 50
    db = ht.compile_multi([p for p, _i in gates],
                          ids=[i for _p, i in gates])
    db.host_scan_limit = 0
    assert len(db.lit.chains) == 50

    def plant(i):
        w = bench.WORDS[i % len(bench.WORDS)]
        return b"gate%dxabcd%s%dend" % (i, w.encode(), i)

    seen = []
    for n in (1, 8, 50, 0):
        block = b" ".join([b"noise"] + [plant(i) for _p, i in gates[:n]])
        before = dict(T.COUNTS)
        got = ht.scan_batch(db, [block], device=CPU)[0]
        assert len(got) == n, n
        assert T.COUNTS["chain_exprs"] - before["chain_exprs"] == n
        seen.append(T.COUNTS["chain_passes"] - before["chain_passes"])
    assert seen == [2, 2, 2, 0]


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """Two processes of two CPU shards each: one profiled scan_batch(mesh=)
    over W.trace_blocks() (two blocks a shard) on each."""
    return W.spawn("trace2", str(tmp_path_factory.mktemp("trace_mh") / "t"))


def test_exchange_span_once_an_exchange_on_a_distributed_mesh(mesh_runs):
    """On a mesh of two processes a call opens hs.exchange once, under
    hs.scan_batch, and raises `exchanges` by one and `exchange_bytes` by
    the bytes of the pairs handed to the gathers (`_gather_pairs`)."""
    for r in mesh_runs:
        assert r["equal"], r["process_id"]
        (ex,) = [e for e in r["events"] if e["name"] == "hs.exchange"]
        assert _inside(ex, _one(r["events"], "hs.scan_batch"))
        assert r["spans"]["hs.exchange"] == 1
        assert r["rise"]["exchanges"] == r["counts"]["exchanges"] == 1
        (handed,) = r["handed"]
        assert handed > 0
        assert r["rise"]["exchange_bytes"] == handed
        assert r["counts"]["exchange_bytes"] == handed


def test_no_exchange_off_a_distributed_mesh():
    """Without a mesh and on a mesh of one process no call opens
    hs.exchange or raises the exchange counters."""
    db = _db()
    blocks = W.trace_blocks()
    for kw in ({"device": CPU}, {"mesh": P.make_mesh(4, device=CPU)}):
        ht.scan_batch(db, blocks, **kw)
        before = dict(T.COUNTS)
        spans = _spans_of(lambda: ht.scan_batch(db, blocks, **kw))
        assert "hs.exchange" not in spans and "hs.verify" in spans
        assert T.COUNTS["exchanges"] == before["exchanges"]
        assert T.COUNTS["exchange_bytes"] == before["exchange_bytes"]


def test_host_stage_spans_count_own_shards(mesh_runs):
    """A process of a two-process mesh opens hs.verify, hs.windows and
    hs.chains once for each of its two shards; one process over the same
    four shards opens them four times."""
    db = _db()
    blocks = W.trace_blocks()
    mesh = P.make_mesh(4, device=CPU)
    ht.scan_batch(db, blocks, mesh=mesh)
    one = _spans_of(lambda: ht.scan_batch(db, blocks, mesh=mesh))
    for name in ("hs.verify", "hs.windows", "hs.chains"):
        assert one[name] == 4, name
        for r in mesh_runs:
            assert r["spans"][name] == 2, (name, r["process_id"])
