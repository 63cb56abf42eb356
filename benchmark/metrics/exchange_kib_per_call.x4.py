"""KiB that rank 0 hands to the group's exchanges (`exchange_bytes`) per
scan_batch call on a mesh of several cards, traced half. A program
without the counter, or a half with no exchange, reads None."""

from harness import stages


def read(run):
    p = stages.profiled(run, "block")
    if run.chips < 2 or p is None or not p.counts.get("exchanges") \
            or not run.traced.calls:
        return None
    return p.counts["exchange_bytes"] / 1024 / run.traced.calls
