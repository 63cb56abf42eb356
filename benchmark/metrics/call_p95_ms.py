"""95th percentile of every call's latency in the window, in ms."""

from harness import readers


def read(run):
    return readers.p95_ms(run)
