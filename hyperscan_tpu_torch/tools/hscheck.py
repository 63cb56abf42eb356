"""hscheck — bulk compile checker (reference: tools/hscheck, 727 LoC).

Reads a pattern file (one expression per line, `id:/pattern/flags` or bare
pattern), attempts compilation of each, reports per-pattern errors.

Usage: python -m hyperscan_tpu_torch.tools.hscheck patterns.txt [--mode stream]
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Tuple

import hyperscan_tpu_torch as hs

FLAG_CHARS = {
    "i": hs.HS_FLAG_CASELESS,
    "s": hs.HS_FLAG_DOTALL,
    "m": hs.HS_FLAG_MULTILINE,
    "H": hs.HS_FLAG_SINGLEMATCH,
    "V": hs.HS_FLAG_ALLOWEMPTY,
    "8": hs.HS_FLAG_UTF8,
    "W": hs.HS_FLAG_UCP,
    "P": hs.HS_FLAG_PREFILTER,
    "L": hs.HS_FLAG_SOM_LEFTMOST,
    "C": hs.HS_FLAG_COMBINATION,
    "Q": hs.HS_FLAG_QUIET,
}

MODES = {
    "block": hs.HS_MODE_BLOCK,
    "stream": hs.HS_MODE_STREAM,
    "vectored": hs.HS_MODE_VECTORED,
}


def parse_line(line: str) -> Optional[Tuple[int, str, int]]:
    """Parse `id:/pattern/flags` (hsbench/hscollider signature format,
    reference: tools/hscollider test_cases/signatures) or a bare pattern."""
    line = line.strip()
    if not line or line.startswith("#"):
        return None
    pid = 0
    body = line
    if ":" in line and line.split(":", 1)[0].isdigit():
        sid, body = line.split(":", 1)
        pid = int(sid)
    flags = 0
    if len(body) >= 2 and body[0] == "/":
        end = body.rfind("/")
        if end > 0:
            for ch in body[end + 1 :]:
                if ch in FLAG_CHARS:
                    flags |= FLAG_CHARS[ch]
            body = body[1:end]
    return pid, body, flags


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("patterns")
    ap.add_argument("--mode", choices=sorted(MODES), default="block")
    args = ap.parse_args(argv)

    good = bad = 0
    with open(args.patterns, "r", errors="replace") as f:
        for lineno, line in enumerate(f, 1):
            parsed = parse_line(line)
            if parsed is None:
                continue
            pid, pat, flags = parsed
            try:
                hs.compile_multi([pat], flags=[flags], ids=[pid],
                                 mode=MODES[args.mode])
                good += 1
            except hs.HyperscanError as exc:
                bad += 1
                print(f"FAIL line {lineno} id {pid}: {exc}")
    print(f"OK: {good} compiled, {bad} failed")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
