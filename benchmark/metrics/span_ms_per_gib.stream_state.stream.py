"""Self ms per GiB of new bytes of the hs.write_start and
hs.write_finish spans, traced half."""

from harness import stages


def read(run):
    return stages.span_ms_per_gib(run, "stream_state", "stream")
