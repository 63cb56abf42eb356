"""simplegrep — block-mode single-pattern scan of a file, on the
PyTorch/CUDA port (hyperscan_tpu_torch).

Counterpart of examples/simplegrep.py (reference: examples/simplegrep.c
:172-199). The scan runs on the CUDA card unless --device names another
torch device; --device cpu runs the kernels' plain PyTorch versions.

Usage: python examples/torch/simplegrep.py <pattern> <file> [--device D]
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

import hyperscan_tpu_torch as ht  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("pattern")
    ap.add_argument("file")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    db = ht.compile(args.pattern)
    with open(args.file, "rb") as f:
        data = f.read()

    def on_match(pat_id, frm, to, flags):
        print(f"Match for pattern {args.pattern!r} at offset {to}")
        return 0

    ht.scan(db, data, callback=on_match, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
