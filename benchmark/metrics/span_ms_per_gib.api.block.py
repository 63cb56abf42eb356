"""Self ms per GiB of the hs.scan_batch and hs.reports spans, traced half."""

from harness import stages


def read(run):
    return stages.span_ms_per_gib(run, "api", "block")
