"""The benchmark's own tests: `python -m pytest benchmark/tests`."""

import pathlib
import sys

BENCH = pathlib.Path(__file__).resolve().parents[1]
for _p in (str(BENCH.parent), str(BENCH), str(BENCH / "tests")):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips where there is none")
