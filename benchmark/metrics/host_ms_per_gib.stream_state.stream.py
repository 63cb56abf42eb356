"""Host ms per GiB of new bytes in the stream state (runtime/streamset.py,
runtime/stream.py), cProfile half."""

from harness import readers


def read(run):
    return readers.host_ms_per_gib(run, "stream_state", "stream")
