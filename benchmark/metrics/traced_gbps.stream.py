"""GB/s of new bytes written to the flows in the traced half of a traced
run (torch.profiler on): stream_gbps's rate, read per layer."""

from harness import readers


def read(run):
    return readers.gbps(run, "stream", phase="traced")
