"""Bytes handed over at the card's HBM rate, as a share of the kernels'
summed time."""

from harness import readers


def read(run):
    return readers.hbm_roofline_pct(run, "stream")
