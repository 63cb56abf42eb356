"""Per-kernel benches of the PyTorch/CUDA port's engine kernels on a card:
hyperscan_tpu_torch.tools.kernel_bench, the counterpart of the JAX
package's tools_bench_kernels.py (the bounded DFA chunk kernel, the
speculative DFA, the cyclic bit-NFA's lazy-DFA core, the layered bit-NFA).

Over one block of each --mb size, each kernel is first held against its
plain PyTorch version, then timed alone (CUDA events) and printed beside
its bound and the card's name and power limit.

Usage, from the root of the repository on a machine with a CUDA card:

    python3 tools_torch_bench_kernels.py [--mb 32 64] [--reps 10]
        [--bench bounded_dfa unbounded_dfa cyclic_nfa acyclic_nfa]

`--device cpu` runs the same through the plain versions.
"""

import sys

from hyperscan_tpu_torch.tools.kernel_bench import main

if __name__ == "__main__":
    sys.exit(main())
