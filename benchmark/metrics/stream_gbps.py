"""GB/s of new bytes written to the flows in the window."""

from harness import readers


def read(run):
    return readers.gbps(run, "stream")
