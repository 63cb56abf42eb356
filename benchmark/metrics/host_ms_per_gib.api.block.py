"""Host ms per GiB in the API and reports (api.py, runtime/scan.py),
cProfile half."""

from harness import readers


def read(run):
    return readers.host_ms_per_gib(run, "api", "block")
