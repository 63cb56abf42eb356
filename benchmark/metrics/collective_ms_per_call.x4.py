"""Device ms of the collectives' (NCCL) kernels per call, traced half."""

from harness import readers


def read(run):
    return readers.collective_ms_per_call(run)
