"""95th percentile of the scan_batch calls' latency in the traced half of
a traced run (torch.profiler on), in ms."""

from harness import readers


def read(run):
    return readers.p95_ms(run, phase="traced", kind="block")
