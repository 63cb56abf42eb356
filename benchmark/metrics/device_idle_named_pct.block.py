"""Share of the card's idle time in gaps under an hs.* span."""

from harness import stages


def read(run):
    return stages.idle_named_pct(run, "block")
