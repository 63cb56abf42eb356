"""Self ms per GiB of the literal spans (hs.dispatch, hs.fetch,
hs.verify, hs.windows, hs.chains), traced half."""

from harness import stages


def read(run):
    return stages.span_ms_per_gib(run, "literal", "block")
