"""Capacity-overflow re-dispatches per scan_batch call, traced half."""

from harness import stages


def read(run):
    return stages.redispatches_per_call(run, "block")
