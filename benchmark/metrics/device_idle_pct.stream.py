"""Share of the traced half in which the card ran no kernel and no copy."""

from harness import readers


def read(run):
    return readers.idle_pct(run, "stream")
