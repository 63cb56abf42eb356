"""Bytes of the traced host-to-device copies over their device time."""

from harness import readers


def read(run):
    return readers.h2d_gbps(run, "stream")
