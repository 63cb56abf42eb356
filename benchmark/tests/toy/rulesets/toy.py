"""A toy ruleset read from a rule file in hscollider's form
(`id:/pattern/flags`, `rs["file"]` under the benchmark's directory that
holds this module), and plants of each of its rules: shape k is the k-th
rule kept."""

from __future__ import annotations

import pathlib
import re

FLAGS = {"i": 1, "s": 2}  # HS_FLAG_CASELESS, HS_FLAG_DOTALL
LINE = re.compile(r"^(\d+):/(.*)/([a-zA-Z]*)$")
DIGITS = "0123456789"
PRINTABLE = "".join(map(chr, range(32, 127)))


def read(rs: dict):
    """[(id, pattern, flag letters)] of the rule file, as far as
    `rs["patterns"]` keeps."""
    path = pathlib.Path(__file__).resolve().parents[1] / rs["file"]
    out = []
    for line in path.read_text().splitlines():
        if line.strip() and not line.startswith("#"):
            i, pat, letters = LINE.match(line).groups()
            out.append((int(i), pat, letters))
    return out[:rs.get("patterns", len(out))]


def rules(rs: dict):
    kept = read(rs)
    flags = [sum(FLAGS[c] for c in letters) for _i, _p, letters in kept]
    return [p for _i, p, _l in kept], [i for i, _p, _l in kept], flags


def shapes(rs: dict) -> int:
    return len(read(rs))


def _pick(rng, chars: str, n: int) -> str:
    return "".join(chars[j] for j in rng.integers(0, len(chars), n))


def plant(rng, rs: dict, shape: int, plants: dict) -> bytes:
    """A string that the rule of `shape` matches (the anchored rule only
    where it ends the data)."""
    if shape == 0:
        s = f"{_pick(rng, DIGITS, 3)}-{_pick(rng, DIGITS, 4)}"
    elif shape == 1:
        s = ".".join(_pick(rng, DIGITS, int(rng.integers(1, 4)))
                     for _ in range(4))
    elif shape == 2:
        pairs = "".join(("aa", "bb")[j]
                        for j in rng.integers(0, 2, rng.integers(3, 6)))
        s = "".join(c.upper() if u else c for c, u in
                    zip(pairs + "c", rng.integers(0, 2, len(pairs) + 1)))
    elif shape == 3:
        s = f"k{_pick(rng, PRINTABLE, 2)}q"
    else:
        s = _pick(rng, PRINTABLE, 4)
    return s.encode()
