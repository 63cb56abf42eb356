"""Bytes of card memory a stream costs: the card's allocated peak over
the run (the StreamSet's state, a round's buffers, the database) over
the flows the StreamSet holds open. How many concurrent flows a card can
track. Nothing to read on the CPU."""

from harness import readers


def read(run):
    return readers.card_bytes_per_flow(run)
