"""Self ms of the literal spans (hs.dispatch, hs.fetch, hs.verify,
hs.windows, hs.chains) per GiB of the global batch, on rank 0 of a mesh
of several cards, traced half."""

from harness import stages


def read(run):
    if run.chips < 2:
        return None
    return stages.span_ms_per_gib(run, "literal", "block")
