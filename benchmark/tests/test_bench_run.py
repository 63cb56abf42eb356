"""Whole runs of cells on the CPU at a small size (cpu_cell.py): the last
line's shape, the faults that `correct` must catch, the controls, the
import check; and the card-only run."""

import json
import os
import shutil
import socket
import subprocess
import sys

import pytest

from harness import control, spec
from harness import traffic as T
from harness.loops import BlockLoop, FlowLoop

import cpu_cell

BENCH = spec.BENCH
HELPER = str(BENCH / "tests" / "cpu_cell.py")
BLOCK, STREAM, IMIX, X4 = ("snort10k_block.bulk1m",
                           "snort10k_stream.flows16k-mss",
                           "snort10k_block.imix4k",
                           "snort10k_block_x4.bulk1m")
SEED = 2**31 + 7
CARD_ONLY = {"card_bytes_per_flow"}  # the card's memory, read on a card


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _cpu_run(cell, cache, fault="", trace=0, seconds=1.0):
    """A run in processes of its own (faults patch the program); rank 0's
    result line."""
    ranks = cpu_cell.cell(cell)["chips"]
    port = str(_free_port())
    args = [cell, str(SEED), str(seconds), str(cache), str(trace)]
    procs = [subprocess.Popen(
        [sys.executable, HELPER, *args, str(r), port, fault],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=str(spec.ROOT)) for r in range(ranks)]
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (_o, e) in zip(procs, outs):
        assert p.returncode == 0, e[-3000:]
    return json.loads(outs[0][0].strip().splitlines()[-1])


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    return tmp_path_factory.mktemp("dbcache")


@pytest.mark.parametrize("cell", [BLOCK, STREAM, IMIX])
@pytest.mark.parametrize("trace", [0, 1])
def test_last_line(cell, trace, cache):
    out = _cpu_run(cell, cache, trace=trace)
    assert list(out)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(out)
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] > 0
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    want = {m["name"]: m["unit"] for m in spec.metrics_of(cell, trace)}
    got = {k: v["unit"] for k, v in out["metrics"].items()}
    assert set(got) <= set(want) and all(want[k] == u for k, u in got.items())
    if not trace:  # the device metrics read nothing on the CPU, nor
        # the card's memory
        assert set(got) == set(want) - CARD_ONLY
    for c in out["checks"].values():
        assert c["value"] == 0 and c["limit"] == 0


def test_phase_readers():
    """The rate and tail of the untraced window and of a traced run's
    traced half, and the card's bytes a flow, each read from its own
    phase; nothing where the run has none."""
    from harness.loops import Phase

    run = cpu_cell.load_run().Run("stream", 1, 1.0, flows=4)
    read = spec.metric_reader
    assert read("card_bytes_per_flow")(run) is None  # no card peak
    run.peak_bytes = 1000
    assert read("card_bytes_per_flow")(run) == 250
    assert read("traced_gbps.stream")(run) is None
    run.traced = Phase(calls=20, bytes=4 * 10**9, seconds=2.0,
                       latencies=[i / 1000 for i in range(1, 21)])
    assert read("traced_gbps.stream")(run) == pytest.approx(2.0)
    assert read("traced_p95_ms.stream")(run) == pytest.approx(19.05)
    assert read("traced_p95_ms.block")(run) is None  # another kind
    assert read("call_p95_ms")(run) is None  # no untraced window
    run.window = Phase(calls=1, bytes=10**9, seconds=1.0, latencies=[0.5])
    assert read("call_p95_ms")(run) == pytest.approx(500.0)


@pytest.mark.parametrize("cell,fault", [
    (BLOCK, "half_batch"), (BLOCK, "first_4k"), (BLOCK, "swapped"),
    (BLOCK, "altered"), (IMIX, "altered"),
    (STREAM, "altered"), (STREAM, "state_unchanged"),
    (STREAM, "chains_reset"),
    (X4, "no_exchange"), (X4, "altered")])
def test_fault_caught(cell, fault, cache):
    """The timed path broken underneath the harness: `correct` false."""
    out = _cpu_run(cell, cache, fault=fault)
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


def test_x4_sound(cache):
    out = _cpu_run(X4, cache)
    assert out["correct"] is True and out["device"]["count"] == 4
    assert out["checks"]["ranks_differing"]["value"] == 0


@pytest.mark.parametrize("cell", [BLOCK, IMIX, STREAM, X4])
def test_control_fails(cell):
    """The configuration's control fails the comparison that the
    reference itself passes, over the sample a run draws."""
    w = cpu_cell.cell(cell)
    cfg = spec.config(w["config"])
    mix = cpu_cell.small_traffic(spec.traffic(w["traffic"]))
    tr = T.make(mix, SEED, dict(cfg["ruleset"], patterns=cpu_cell.PATTERNS),
                w["chips"])
    R = spec.reference(cfg)
    if mix["kind"] == "flows":
        loop = FlowLoop(None, None, tr, SEED)
        loop.r = 40
        same = R.stream_matches
    else:
        loop = BlockLoop(None, None, tr, SEED)
        for _ in range(7):
            loop.record(None)
        same = R.block_matches
    ck = control.check(loop, cfg)
    assert ck.compared > 0 and ck.missing + ck.extra > 0
    ref = loop.check(cfg, answer=same)
    assert ref.missing == ref.extra == 0 and ref.compared == ck.compared


def _modules(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        capture_output=True, text=True, cwd=str(spec.ROOT), timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_import_check(tmp_path):
    """In a fresh process: a cell's set-up and window load neither jax
    nor the JAX package."""
    setup = _modules(
        f"import sys; sys.path.insert(0, {str(BENCH / 'tests')!r})\n"
        "import cpu_cell\n"
        f"cpu_cell.run({BLOCK!r}, 3, 0.5, {str(tmp_path)!r})\n")
    assert "hyperscan_tpu_torch" in setup
    assert not setup & {"jax", "jaxlib", "flax", "hyperscan_tpu"}


TOY = BENCH / "tests" / "toy"
CONFIGS = ([(BENCH, p.stem) for p in sorted(BENCH.glob("configs/*.json"))]
           + [(TOY, p.stem) for p in sorted(TOY.glob("configs/*.json"))])


@pytest.mark.parametrize("where,name", CONFIGS, ids=lambda x: str(x)[-24:])
def test_reference_imports(where, name):
    """In a fresh process: each configuration's ruleset module, plain
    reference and control, loaded by name and run over a block, load
    neither jax, the JAX package, the program nor torch."""
    ref = _modules(
        f"import sys; sys.path.insert(0, {str(BENCH)!r})\n"
        "from harness import spec\n"
        f"spec.DIRS.insert(0, spec.pathlib.Path({str(where)!r}))\n"
        "from formulas import benchdata as BD\n"
        f"cfg = spec.config({name!r}); rs = cfg['ruleset']\n"
        "assert spec.ruleset(rs).rules(rs)[0]\n"
        "R = spec.reference(cfg)\n"
        "data = BD.gen_corpus(1 << 14, 1, 'iid').tobytes()\n"
        "R.block_matches(data, rs)\n"
        "R.stream_matches(data, rs, 1460)\n"
        "stream = cfg['mode'] == 'stream'\n"
        "R.CONTROLS[cfg['control']](data, rs, *([1460] if stream else []))\n")
    assert not ref & {"jax", "jaxlib", "flax", "hyperscan_tpu",
                      "hyperscan_tpu_torch", "torch"}


def test_needs_the_port(tmp_path):
    """In a directory of BENCHMARK.json and the benchmark alone: an exit
    code other than 0 and no result."""
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("cache", "__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", BLOCK, "--seed",
         "1", "--seconds", "1", "--trace", "0"], capture_output=True,
        text=True, cwd=str(tmp_path), env=env, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_without_a_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is here")
    out = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload", BLOCK,
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=str(spec.ROOT), timeout=300)
    assert out.returncode == 2 and out.stdout.strip() == ""


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [BLOCK, STREAM])
def test_card_run(cell):
    """A short run of the cell on the card, as the benchmark runs it."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload", cell,
         "--seed", str(SEED), "--seconds", "2", "--trace", "0"],
        capture_output=True, text=True, cwd=str(spec.ROOT), timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
