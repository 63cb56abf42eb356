"""Host ms per GiB in the literal dispatch and host stages, cProfile half."""

from harness import readers


def read(run):
    return readers.host_ms_per_gib(run, "literal", "block")
