"""The benchmark's data, found by name: the cells of `BENCHMARK.json`, and
under `benchmark/` one file for each configuration (`configs/<name>.json`),
ruleset (`rulesets/<formula>.py`, named by the configuration's
`ruleset.formula`), plain reference with its controls (the path that the
configuration's `reference` gives), traffic mix (`traffic/<name>.json`),
per-layer metric reader (`metrics/<name>.py`) and layer
(`layers/<slug>.json`). A configuration, ruleset, reference, cell, mix or
metric is added by adding files and entries; no code here names one.

A ruleset module has `rules(rs) -> (patterns, ids, flags)`, one flag a
rule (where `rs` has `patterns`, that many leading rules are kept),
`shapes(rs)`, the number of kinds of rule plant, and `plant(rng, rs,
shape, plants) -> bytes`, a string that a rule of that shape matches,
its free parts drawn from `rng` (`plants` is the mix's `plants`). A
reference module has `block_matches(data, rs)`, every match (id, from,
to) of a block; `stream_matches(data, rs, write)`, a stream's matches by
the round whose write holds their last byte and those that its close
delivers, as `({round: matches}, close_matches)`; and `CONTROLS`, a
control's name to a function of the same form as one of those two.

Named files are looked for in each directory of `DIRS` in turn."""

from __future__ import annotations

import fnmatch
import importlib.util
import json
import pathlib
import re
from typing import Dict, List, Optional

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
PORT = ROOT / "hyperscan_tpu_torch"
DIRS = [BENCH]
_MODULES: Dict[pathlib.Path, object] = {}


def _json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return _json(ROOT / "BENCHMARK.json")


def cell(name: str) -> dict:
    for w in benchmark()["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def find(rel: str) -> pathlib.Path:
    """The file at `rel` under the first directory of DIRS that has it."""
    for d in DIRS:
        if (d / rel).is_file():
            return d / rel
    raise FileNotFoundError(f"no {rel} under {[str(d) for d in DIRS]}")


def _module(rel: str):
    """The Python file at `rel`, loaded once by its path."""
    path = find(rel).resolve()
    if path not in _MODULES:
        s = importlib.util.spec_from_file_location(
            "bench_" + re.sub(r"\W", "_", rel[:-3]), path)
        mod = importlib.util.module_from_spec(s)
        s.loader.exec_module(mod)
        _MODULES[path] = mod
    return _MODULES[path]


def config(name: str) -> dict:
    return _json(find(f"configs/{name}.json"))


def traffic(name: str) -> dict:
    return _json(find(f"traffic/{name}.json"))


def ruleset(rs: dict):
    """The module of a configuration's ruleset (`cfg["ruleset"]`)."""
    return _module(f"rulesets/{rs['formula']}.py")


def reference(cfg: dict):
    """The module of a configuration's plain reference."""
    return _module(cfg["reference"])


def metrics_of(cell_name: str, trace: bool) -> List[dict]:
    """The metrics a run of the cell reports: the end-to-end ones, or with
    `trace` the per-layer ones, each where its `workloads` (if any) name
    the cell."""
    spec = benchmark()
    return [m for m in spec["per_layer" if trace else "end_to_end"]
            if cell_name in m.get("workloads", [cell_name])]


def metric_reader(name: str):
    """The `read(run)` function of `metrics/<name>.py`."""
    return _module(f"metrics/{name}.py").read


class Layers:
    """The host layers of `layers/*.json`: each file gives a layer's name
    (`layer`, as BENCHMARK.json spells it) and the port's modules in it, as
    paths under `hyperscan_tpu_torch/` that may hold wildcards. A layer's
    slug is its file's name."""

    def __init__(self, files: Optional[Dict[str, dict]] = None):
        if files is None:
            files = {p.stem: _json(p)
                     for p in sorted((BENCH / "layers").glob("*.json"))}
        self.files = files
        self._memo: Dict[str, Optional[str]] = {}

    def of_file(self, filename: str) -> Optional[str]:
        """The slug of the layer that lists a source file, "other" for a
        file of the port that no layer lists, None outside the port."""
        if filename not in self._memo:
            self._memo[filename] = self._find(filename)
        return self._memo[filename]

    def _find(self, filename: str) -> Optional[str]:
        try:
            rel = pathlib.Path(filename).resolve().relative_to(PORT)
        except (ValueError, OSError):
            return None
        rel_s = rel.as_posix()
        for slug, f in self.files.items():
            if any(fnmatch.fnmatchcase(rel_s, pat) for pat in f["modules"]):
                return slug
        return "other"
