"""Published peaks of the card (NVIDIA H100 SXM5 80 GB data sheet, at its
700 W limit)."""

HBM_BYTES_PER_S = 3.35e12  # HBM3 bandwidth
