"""Capacity-overflow re-dispatches per write round, traced half."""

from harness import stages


def read(run):
    return stages.redispatches_per_call(run, "stream")
