"""Self ms of the hs.exchange span (the group's gather of the shards'
matches, with the wait for the slowest process) per GiB of the global
batch, on rank 0 of a mesh of several cards, traced half. A program
without the span reads None."""

from harness import stages
from harness.readers import GIB


def read(run):
    p = stages.profiled(run, "block")
    if run.chips < 2 or p is None or "hs.exchange" not in p.spans \
            or not run.traced.bytes:
        return None
    return p.self_ns["hs.exchange"] * 1e-6 / (run.traced.bytes / GIB)
