"""The in-kernel confirm against the separate confirm on a card:
hyperscan_tpu_torch.tools.kconf_bench, the counterpart of the JAX
package's tools_bench_kconfirm.py. The kconfirm and compact families,
each forced, over the 10k bench ruleset and iid corpora; seconds a scan
and GB/s of each, and their verified pairs equal as sets.

Usage, from the root of the repository on a machine with a CUDA card:

    python3 tools_torch_bench_kconfirm.py [--mb 512] [--iters 3]
        [--n 10000] [--kind iid] [--separate]

`--separate` runs the separate confirm (compact) alone; `--device cpu`
runs both through the kernels' plain versions.
"""

import sys

from hyperscan_tpu_torch.tools.kconf_bench import main

if __name__ == "__main__":
    sys.exit(main())
