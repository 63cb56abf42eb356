"""Self ms of the hs.assemble and hs.upload spans per GiB of the global
batch, on rank 0 of a mesh of several cards, traced half."""

from harness import stages


def read(run):
    if run.chips < 2:
        return None
    return stages.span_ms_per_gib(run, "assembly", "block")
