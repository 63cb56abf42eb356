"""GB/s of blocks handed to scan_batch in the window (the global batch's
bytes, once, on a mesh)."""

from harness import readers


def read(run):
    return readers.gbps(run, "block")
