"""The port's throughput bench on a card: hyperscan_tpu_torch.tools.bench,
the counterpart of the JAX package's bench.py (one JSON line on stdout:
metric, value, unit, vs_baseline), tools_bench_stream.py and
tools_probe_som512.py.

Usage, from the root of the repository on a machine with a CUDA card:

    python3 tools_torch_bench.py [--mb 512] [--iters 6]
        [--svals 1024 4096 16384] [--som-streams 4096] [--patterns 10000]
    python3 tools_torch_bench.py --stream [S ...]   (default 16 256 1024 4096)
    python3 tools_torch_bench.py --som-only [--mb 512]

`--device cpu` runs the same on the CPU (the kernels' plain versions).
"""

import sys

from hyperscan_tpu_torch.tools.bench import main

if __name__ == "__main__":
    sys.exit(main())
