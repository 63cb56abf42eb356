"""Self ms per GiB of the hs.assemble and hs.upload spans, traced half."""

from harness import stages


def read(run):
    return stages.span_ms_per_gib(run, "assembly", "block")
