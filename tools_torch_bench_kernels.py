"""Per-kernel benches of the PyTorch/CUDA port on a card:
hyperscan_tpu_torch.tools.kernel_bench, every hand-written kernel of the
kernel table (PERF.md) at the shapes of the main paths. The engine
kernels as the JAX package's tools_bench_kernels.py benches them (the
bounded DFA chunk kernel, the speculative DFA, the cyclic bit-NFA's
lazy-DFA core, the layered bit-NFA), kernel C's row mode over 16,384 x
16 KiB, and the literal kernels (kernels A and B, the plane mode and the
extraction, kernel 4, the gate, the survivor rescan, kernel 7) with the
10k bench ruleset over 512 MiB, structured and iid.

Each kernel is first held against its plain PyTorch version on the very
input it is timed on (a difference exits non-zero), then timed alone
(CUDA events) and printed beside its bound, its plain version's time and
the card's name and power limit.

Usage, from the root of the repository on a machine with a CUDA card:

    python3 tools_torch_bench_kernels.py [--mb N ...] [--reps 10]
        [--bench bounded_dfa ... dfa_rows compact confirm plane kconfirm
         gate rescan words]

`--mb` replaces every chosen bench's own sizes. `--device cpu` runs the
same through the plain versions.
"""

import sys

from hyperscan_tpu_torch.tools.kernel_bench import main

if __name__ == "__main__":
    sys.exit(main())
