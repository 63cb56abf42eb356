"""A configuration with a ruleset, reference, control and mixes of its own
runs through the harness with no edit to it: the toy configuration of
`tests/toy/` (five general regexes in hscollider's rule form, per-rule
flags, one rule anchored at the end of data, a brute-force reference, a
control of its own), copied to a directory of the test's own that the
harness looks in by name. And no code of the harness names the bench
ruleset."""

import json
import re
import shutil
import sys

import pytest

from harness import dbcache, spec

import control
import cpu_cell

TOY = spec.BENCH / "tests" / "toy"
CELLS = ("toy_block.toy_blocks", "toy_stream.toy_flows")
SEED = 2**33 + 17
HARNESS = sorted(spec.BENCH.glob("harness/*.py")) + [
    spec.BENCH / "run.py", spec.BENCH / "control.py"]


@pytest.fixture
def toy(tmp_path, monkeypatch):
    """The toy's files in a directory of their own, first among the
    directories where the harness finds files by name."""
    data = tmp_path / "toy"
    shutil.copytree(TOY, data)
    monkeypatch.setattr(spec, "DIRS", [data] + spec.DIRS)
    monkeypatch.setattr(spec, "cell", cpu_cell.cell)
    monkeypatch.setattr(dbcache, "CACHE", tmp_path / "db")
    for var in ("XDG_CACHE_HOME", "TRITON_CACHE_DIR", "TORCH_EXTENSIONS_DIR"):
        monkeypatch.delenv(var, raising=False)  # run.py sets them
    return data


@pytest.mark.parametrize("cell", CELLS)
def test_toy_cell(cell, toy, capsys):
    """The toy cell through `run.run_cell` on the CPU reads `correct`;
    the program and the control read over one sample by `control.py`:
    the program matches the reference, the control misses the
    end-of-data matches, which the flows' close delivers."""
    run = cpu_cell.load_run()
    out, lines = run.run_cell(cpu_cell.Args(cell, SEED, 0.5), 0, None,
                              device_kind="cpu")
    assert out["correct"] is True, lines
    assert all(c["value"] == 0 for c in out["checks"].values())
    assert set(out["metrics"]) == {
        m["name"] for m in spec.benchmark()["end_to_end"]
        if "workloads" not in m}

    assert control.main(["--workload", cell, "--seeds", "5", "--seconds",
                         "0.5", "--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    prog, ctl = line["program"], line["control"]
    assert prog["compared"] > 0 and prog["missing"] == prog["extra"] == 0
    assert ctl["compared"] == prog["compared"]
    assert ctl["missing"] > 0 and ctl["extra"] == 0


@pytest.mark.parametrize("where", ["import", "check"])
def test_banned_in_reference(where, toy):
    """A reference that loads a module that no run may hold (here a
    stand-in named flax), when it is loaded or only in the check after
    the window: the run ends with no result."""
    ref = toy / "reference" / "toy_rules.py"
    src = ref.read_text()
    plant = "sys.modules.setdefault('flax', types.ModuleType('flax'))"
    if where == "import":
        src += f"\nimport sys, types\n{plant}\n"
    else:
        src = src.replace('    n = len(data)\n',
                          f'    import sys, types\n    {plant}\n'
                          '    n = len(data)\n', 1)
    ref.write_text(src)
    run = cpu_cell.load_run()
    try:
        with pytest.raises(SystemExit, match="flax"):
            run.run_cell(cpu_cell.Args(CELLS[0], SEED, 0.5), 0, None,
                         device_kind="cpu")
    finally:
        sys.modules.pop("flax", None)


def test_toy_reference_and_plants(toy):
    """Each plant is a match of its rule where it ends the data, and the
    reference's stream form splits a block's matches into rounds and the
    close."""
    import numpy as np

    cfg = spec.config("toy_stream")
    rs = cfg["ruleset"]
    rules, ref = spec.ruleset(rs), spec.reference(cfg)
    pats, ids, flags = rules.rules(rs)
    assert len(pats) == rules.shapes(rs) == 5 and len(set(flags)) > 1
    assert any(p.endswith("$") for p in pats)
    rng = np.random.default_rng(3)
    for shape in range(rules.shapes(rs)):
        for _ in range(20):
            p = rules.plant(rng, rs, shape, {})
            got = ref.block_matches(b"  " + p, rs)
            assert (ids[shape], 0, 2 + len(p)) in got
    data = b"xx 123-4567 yy aAbbaAC kzzq 1.22.3.4"
    rounds, close = ref.stream_matches(data, rs, 8)
    assert close == [(105, 0, len(data))]
    assert sorted(m for ms in rounds.values() for m in ms) + close == \
        sorted(ref.block_matches(data, rs), key=lambda m: (m[0] == 105, m))
    assert ref.CONTROLS[cfg["control"]](data, rs, 8) == (rounds, [])
    assert dbcache.ruleset(dict(cfg, ruleset=dict(rs, patterns=3)))[1] == \
        [101, 102, 103]


def test_harness_names_no_ruleset():
    """The harness, run.py and control.py find the ruleset, reference and
    control by the configuration's names alone."""
    for path in HARNESS:
        src = path.read_text()
        for word in ("snort_rules", "rule_plant"):
            assert word not in src, (path.name, word)
        assert not re.search(r"""["']bench["']""", src), path.name
