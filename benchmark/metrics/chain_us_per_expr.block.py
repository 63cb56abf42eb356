"""Self us of hs.chains per chain expression worked through, traced half."""

from harness import stages


def read(run):
    return stages.chain_us_per_expr(run, "block")
