"""The port's bench (hyperscan_tpu_torch/tools/bench.py, tools_torch_bench.py)
and its device-host differential (tools_torch_diff_device_host.py) against
the JAX package's bench.py, tools_bench_stream.py and scans, on the CPU.

- The bench data: `benchdata.patterns(n, drop_shapes)`, `plant_region`
  and `gen_corpus` equal bench.py's `_patterns` (filtered as its
  run_config filters), `_plant_region` and `_gen_host` byte for byte;
  `stream_extents` equals tools_bench_stream's `_gen_host` (in a
  subprocess: that module sets JAX's compile cache when imported).
- The timed paths, small: each scan of `run_config` (1 MiB, 2 scans) for
  the 100-pattern configuration and its SOM_LEFTMOST form equals
  `hyperscan_tpu.scan` of the same corpus; each round of `run_streamset`
  (8 streams, 3 rounds) and of the host-path streams equals the JAX
  package's `scan_streams` of the same writes. Match lists are compared
  exactly, sorted.
- `main` prints one JSON line with the four keys in each mode; a scan
  asked for the card where there is none raises.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import bench
import hyperscan_tpu as hs
import torch_ref_native  # noqa: F401 (the reference's native build, locked)
import tools_torch_diff_device_host as diff_tool
from hyperscan_tpu.database import compile_patterns as ref_compile
from hyperscan_tpu.grey import Grey as RefGrey
from hyperscan_tpu_torch.runtime.stream import history_required
from hyperscan_tpu_torch.tools import bench as B
from hyperscan_tpu_torch.tools import benchdata as BD

CPU = "cpu"
SOM = hs.HS_FLAG_SOM_LEFTMOST
STREAM_PATTERNS = 200  # the stream databases' size in these tests
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _sorted(lists):
    return [sorted(tuple(m) for m in ms) for ms in lists]


def _ref_db(n, flags=0, drop_shapes=(), mode=hs.HS_MODE_BLOCK, grey=None):
    """The JAX package's database of the same bench patterns."""
    pats, ids = bench._patterns(n)
    keep = [j for j, i in enumerate(ids) if i % 6 not in drop_shapes]
    return ref_compile([pats[j] for j in keep], [flags] * len(keep),
                       [ids[j] for j in keep], mode, grey=grey)


# --- the bench data ----------------------------------------------------------


@pytest.mark.parametrize("n,drop", [(100, ()), (100, (5,)), (96, (5,)),
                                    (10_000, ())])
def test_patterns_equal_reference(n, drop):
    pats, ids = bench._patterns(n)
    keep = [j for j, i in enumerate(ids) if i % 6 not in drop]
    assert BD.patterns(n, drop) == ([pats[j] for j in keep],
                                    [ids[j] for j in keep])


def test_plant_region_equals_reference():
    region = BD.plant_region()
    assert np.array_equal(region, bench._plant_region())
    for off, p in BD.plant_starts():
        at = off - BD.PLANT_AT
        assert region[at:at + len(p)].tobytes() == p


@pytest.mark.parametrize("kind", ["structured", "iid"])
@pytest.mark.parametrize("salt", [0, 1, 2])
def test_gen_corpus_equals_reference(kind, salt):
    n = 1 << 20
    assert np.array_equal(BD.gen_corpus(n, salt, kind),
                          bench._gen_host(n, salt, kind))


def test_stream_extents_equal_reference(tmp_path):
    """tools_bench_stream._gen_host for rounds 0-2 (round 0 without
    history), in a subprocess."""
    S, hist = 8, 36
    out = tmp_path / "ref.npz"
    code = (
        "import sys, numpy as np; sys.path.insert(0, %r);"
        "import tools_bench_stream as t;"
        "np.savez(%r, r0=t._gen_host(%d, t.W, 0, 0),"
        " r1=t._gen_host(%d, t.W + %d, %d, 1),"
        " r2=t._gen_host(%d, t.W + %d, %d, 2), W=t.W)"
        % (ROOT, str(out), S, S, hist, hist, S, hist, hist))
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert r.returncode == 0, r.stderr[-2000:]
    ref = np.load(out)
    assert int(ref["W"]) == B.WRITE
    for r_, key in enumerate(("r0", "r1", "r2")):
        got = BD.stream_extents(S, B.WRITE, hist if r_ else 0, r_)
        assert np.array_equal(got, ref[key]), key


def test_stream_extent_fits_som_history():
    """The SOM stream database's history plus a write fits the plant
    period (stream_extents raises past it)."""
    db = B.bench_db(96, SOM, (5,), hs.HS_MODE_STREAM, B.HOST_LIMIT)
    assert history_required(db) + B.WRITE <= BD.STREAM_PERIOD


# --- the timed paths against the JAX package ------------------------------


@pytest.mark.parametrize("flags,drop", [(0, ()), (SOM, (5,))],
                         ids=["plain", "som"])
def test_run_config_equals_reference_scan(flags, drop):
    out = []
    gbps, total, _c = B.run_config(100, CPU, flags, corpus_mb=1, iters=2,
                                   drop_shapes=drop, out=out)
    assert gbps > 0 and total == sum(map(len, out)) and len(out) == 2
    ref = _ref_db(100, flags, drop)
    for salt, got in zip((1, 2), out):
        corpus = BD.gen_corpus(1 << 20, salt, "structured")
        want = hs.scan(ref, corpus.tobytes())
        assert _sorted([got]) == _sorted([want]), salt
        if flags:
            assert any(m[1] > 0 for m in got)  # leftmost starts reported


def _ref_streams(db, rounds_writes):
    """The JAX package's scan_streams of each round's writes, then the
    streams' close."""
    streams = [hs.open_stream(db) for _ in rounds_writes[0]]
    out = [hs.scan_streams(db, streams, w) for w in rounds_writes]
    out.append([hs.close_stream(st) for st in streams])
    return out


@pytest.mark.parametrize("flags,drop,n", [(0, (), STREAM_PATTERNS),
                                          (SOM, (5,), 96)],
                         ids=["plain", "som"])
def test_run_streamset_equals_reference(flags, drop, n):
    S, rounds = 8, 3
    db = B.bench_db(n, flags, drop, hs.HS_MODE_STREAM)
    out = []
    gbps, nm = B.run_streamset(db, S, rounds, CPU, out=out)
    assert gbps > 0 and len(out) == rounds + 2
    assert nm == sum(len(m) for rnd in out[2:] for m in rnd)
    hreq = history_required(db)
    writes = []
    for r in range(rounds + 2):
        ext = BD.stream_extents(S, B.WRITE, hreq if r else 0, r)
        h, el = (hreq if r else 0), (hreq if r else 0) + B.WRITE
        writes.append([ext[i * el + h:(i + 1) * el].tobytes()
                       for i in range(S)])
    want = _ref_streams(_ref_db(n, flags, drop, hs.HS_MODE_STREAM), writes)
    assert not any(want[-1])  # no end-of-data reports in these rulesets
    assert [_sorted(r) for r in out] == [_sorted(r) for r in want[:-1]]
    assert sum(len(m) for rnd in out for m in rnd) >= S  # the plants


@pytest.mark.parametrize("which", ["som", "config"])
def test_host_streams_equal_reference(which):
    rounds = 3
    out = []
    if which == "som":
        gbps, nm = B.run_stream_som(CPU, rounds=rounds, out=out)
        ref = _ref_db(96, SOM, (5,), hs.HS_MODE_STREAM,
                      RefGrey(host_scan_limit=1 << 21))
        writes = BD.host_stream_writes(3, 4, rounds)
    else:
        db = B.bench_db(STREAM_PATTERNS, mode=hs.HS_MODE_STREAM,
                        grey=B.HOST_LIMIT)
        gbps, nm = B.run_stream_config(db, CPU, rounds=rounds, out=out)
        ref = _ref_db(STREAM_PATTERNS, mode=hs.HS_MODE_STREAM,
                      grey=RefGrey(host_scan_limit=1 << 21))
        writes = BD.host_stream_writes(7, 5, rounds)
    assert gbps > 0 and nm == sum(len(m) for rnd in out[1:-1] for m in rnd)
    want = _ref_streams(ref, writes)
    assert [_sorted(r) for r in out] == [_sorted(r) for r in want]
    assert nm > 0


def test_host_streams_count_equals_reference_bench():
    """At the bench's own depth, the timed rounds' match counts equal
    those of the JAX package's bench.py functions, which make their
    writes themselves."""
    ref_db = _ref_db(STREAM_PATTERNS, mode=hs.HS_MODE_STREAM,
                     grey=RefGrey(host_scan_limit=1 << 21))
    db = B.bench_db(STREAM_PATTERNS, mode=hs.HS_MODE_STREAM,
                    grey=B.HOST_LIMIT)
    assert B.run_stream_config(db, CPU)[1] == \
        bench.run_stream_config(hs, ref_db)[1]
    assert B.run_stream_som(CPU)[1] == bench.run_stream_som(hs)[1]


# --- the entry points ---------------------------------------------------------


SMALL = ["--device", "cpu", "--mb", "1", "--iters", "2", "--patterns",
         str(STREAM_PATTERNS)]


@pytest.mark.parametrize("mode", ["all", "stream", "som-only"])
def test_main_prints_one_json_line(mode, capsys):
    extra = {"all": ["--svals", "8", "--som-streams", "8"],
             "stream": ["--stream", "8"], "som-only": ["--som-only"]}[mode]
    assert B.main(SMALL + extra) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    if mode == "som-only":
        assert len(lines) == 1 and lines[0].startswith("SOM 1 MB:")
        return
    res = json.loads(lines[-1])
    if mode == "stream":
        assert list(res) == ["8"] and lines[0].startswith("S=    8:")
        return
    assert len(lines) == 1
    assert set(res) == {"metric", "value", "unit", "vs_baseline"}
    assert res["unit"] == "GB/s" and res["value"] > 0
    # both numbers are rounded to 4 places from the same rate
    assert abs(res["vs_baseline"] - res["value"] / B.BASELINE_GBPS) < 1e-4
    assert "one device: cpu" in res["metric"]


def test_card_asked_for_without_one_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        B.run_config(100, "cuda", corpus_mb=1, iters=1)
    with pytest.raises(RuntimeError, match="cuda"):
        B.main(["--mb", "1"])
    with pytest.raises(RuntimeError, match="cuda"):
        diff_tool.main(["--mb", "1", "--n", "10"])


def test_diff_device_host(capsys):
    assert diff_tool.main(["--mb", "2", "--n", "300", "--device", CPU]) == 0
    out = capsys.readouterr().out
    for kind in ("structured", "iid"):
        assert f"{kind} 2 MiB [cpu]:" in out
    assert out.count("missing=0 extra=0") == 2
