"""Host ms per GiB in batch assembly and upload (ops/teddy.py), cProfile
half."""

from harness import readers


def read(run):
    return readers.host_ms_per_gib(run, "assembly", "block")
