"""Stage probe of the PyTorch/CUDA port's kernel 4 (kconfirm) on a card.

Runs hyperscan_tpu_torch.tools.kconf_probe: times kernel A's plane mode,
kernel 4's stage modes 0-3, stage 3 with kconf_combine, and the kconfirm
family end to end over a 512 MiB iid corpus with the 10k bench ruleset,
after printing the fill of kernel 4's bucket rows (`--fills`: only that,
on any machine).

Usage, from the root of the repository on a machine with a CUDA card:

    python3 tools_torch_probe_kconfirm.py [--mb 512] [--reps 10] [--fills]
"""

import sys

from hyperscan_tpu_torch.tools.kconf_probe import main

if __name__ == "__main__":
    sys.exit(main())
