"""The benchmark's data, found by name: the cells of `BENCHMARK.json`, and
under `benchmark/` one file for each configuration (`configs/<name>.json`),
traffic mix (`traffic/<name>.json`), per-layer metric reader
(`metrics/<name>.py`) and layer (`layers/<slug>.json`). A cell, mix or
metric is added by adding files and entries; no code here names one."""

from __future__ import annotations

import fnmatch
import importlib.util
import json
import pathlib
from typing import Dict, List, Optional

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
PORT = ROOT / "hyperscan_tpu_torch"


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


def config(name: str) -> dict:
    return _json(BENCH / "configs" / f"{name}.json")


def traffic(name: str) -> dict:
    return _json(BENCH / "traffic" / f"{name}.json")


def metrics_of(cell_name: str, trace: bool) -> List[dict]:
    """The metrics a run of the cell reports: the end-to-end ones, or with
    `trace` the per-layer ones, each where its `workloads` (if any) name
    the cell."""
    spec = benchmark()
    return [m for m in spec["per_layer" if trace else "end_to_end"]
            if cell_name in m.get("workloads", [cell_name])]


def metric_reader(name: str):
    """The `read(run)` function of `metrics/<name>.py`."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


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
