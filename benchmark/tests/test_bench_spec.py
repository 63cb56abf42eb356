"""Every file that BENCHMARK.json names is found by name and holds what
the harness reads; the database cache's key moves with what it keys."""

import json
import re
import shutil

import pytest

from harness import dbcache, spec

B = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_shape():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert B["paths"] == ["benchmark"]
    assert 1 <= B["run_seconds"] <= 51
    assert len((spec.ROOT / "BENCHMARK.json").read_bytes()) <= 64 << 10
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in B[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in B["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert "setup_s" in {m["name"] for m in B["end_to_end"]}


@pytest.mark.parametrize("c", B["configs"], ids=lambda c: c["name"])
def test_config_by_name(c):
    cfg = spec.config(c["name"])
    assert cfg["name"] == c["name"]
    assert c["file"] == f"benchmark/configs/{c['name']}.json"
    assert cfg["mode"] in ("block", "stream")
    assert dbcache.ruleset(cfg)[0]
    assert (spec.BENCH / cfg["reference"]).exists()
    assert cfg["control"] in spec.reference(cfg).CONTROLS
    assert any(w["config"] == c["name"] for w in B["workloads"])


@pytest.mark.parametrize("w", B["workloads"], ids=lambda w: w["name"])
def test_cell_by_name(w):
    assert spec.cell(w["name"]) == w
    assert w["chips"] in (1, 4)
    mix = spec.traffic(w["traffic"])
    assert mix["kind"] in ("blocks", "flows")
    e2e = {m["name"] for m in spec.metrics_of(w["name"], False)}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert spec.metrics_of(w["name"], True)


@pytest.mark.parametrize("m", B["end_to_end"] + B["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_reader_by_name(m):
    read = spec.metric_reader(m["name"])
    assert callable(read)
    for w in m.get("workloads", []):
        spec.cell(w)


def test_layers_by_name():
    layers = spec.Layers()
    named = {f["layer"] for f in layers.files.values()}
    for m in B["per_layer"]:
        assert m["layer"] in named, m["name"]
        assert m["moves"] in {e["name"] for e in B["end_to_end"]}
        for w in m["workloads"]:
            assert m["moves"] in {x["name"]
                                  for x in spec.metrics_of(w, False)}
    port = spec.PORT
    assert layers.of_file(str(port / "ops" / "teddy.py")) == "assembly"
    assert layers.of_file(str(port / "ops" / "teddy_gate.py")) == "literal"
    assert layers.of_file(str(port / "runtime" / "streamset.py")) == \
        "stream_state"
    assert layers.of_file(str(port / "database.py")) == "other"
    assert layers.of_file("/usr/lib/python3/json/__init__.py") is None


def test_cache_key(tmp_path):
    """A change to the ruleset, the mode, the flags or any source of the
    port gives a new key."""
    port = tmp_path / "port"
    shutil.copytree(spec.PORT, port,
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    cfg = json.loads(json.dumps(spec.config("snort10k_block")))
    base = dbcache.key(cfg, port)
    assert dbcache.key(cfg, port) == base
    for field, value in (("patterns", 9999), ("flags", 8)):
        c = json.loads(json.dumps(cfg))
        c["ruleset"][field] = value
        assert dbcache.key(c, port) != base
    c = dict(cfg, mode="stream")
    assert dbcache.key(c, port) != base
    for rel in ("runtime/scan.py", "csrc/teddy_gate.cu",
                "csrc/teddy_filter.cuh", "native/scan.cpp"):
        f = port / rel
        old = f.read_bytes()
        f.write_bytes(old + b"\n")
        assert dbcache.key(cfg, port) != base, rel
        f.write_bytes(old)
    assert dbcache.key(cfg, port) == base
    (port / "build").mkdir()
    (port / "build" / "x.so").write_bytes(b"built")
    assert dbcache.key(cfg, port) == base


def test_kept_files_load():
    """The data files kept for later cells (configurations, mixes and
    readers that BENCHMARK.json does not name yet) load by name too, and
    each configuration's ruleset module and reference with them."""
    for p in sorted((spec.BENCH / "configs").glob("*.json")):
        cfg = spec.config(p.stem)
        assert cfg["name"] == p.stem and dbcache.ruleset(cfg)[0]
        rules = spec.ruleset(cfg["ruleset"])
        assert rules.shapes(cfg["ruleset"]) >= 1 and callable(rules.plant)
        ref = spec.reference(cfg)
        assert callable(ref.block_matches) and callable(ref.stream_matches)
        assert cfg["control"] in ref.CONTROLS
    for p in sorted((spec.BENCH / "traffic").glob("*.json")):
        assert spec.traffic(p.stem)["kind"] in ("blocks", "flows")
    for p in sorted((spec.BENCH / "metrics").glob("*.py")):
        assert callable(spec.metric_reader(p.stem))
