"""The synthetic bench ruleset (`"formula": "bench"`): the first
`patterns` rules of `formulas/benchdata.py` `patterns`, every rule with
the configuration's one `flags`, in six shapes by id % 6:

    0  w{i}                           the literal
    1  w{i}[0-9]{2,4}z
    2  x{i}(GET|POST|PUT) /[a-z]{1,20}
    3  q{i}h[a-f0-9]{8}
    4  v{i}\\.(exe|dll|bat)
    5  gate{i}x(ab|cd)*w{i}end

A plant of a shape matches one rule of that shape, its id and free parts
(digits, verb, path letters, hex, extension, the number of `ab`/`cd`
pairs of a gate chain, bounded by the mix's `plants["gate_pairs"]`)
drawn from the seed's generator.
"""

from __future__ import annotations

from formulas import benchdata as BD

SHAPES = 6
VERBS = ("GET", "POST", "PUT")
EXTS = ("exe", "dll", "bat")
LOWER = "abcdefghijklmnopqrstuvwxyz"
HEX = "0123456789abcdef"


def rules(rs: dict):
    """(patterns, ids, flags) of the first `rs["patterns"]` rules."""
    pats, ids = BD.patterns(rs["patterns"])
    return pats, ids, [rs["flags"]] * len(pats)


def shapes(rs: dict) -> int:
    return SHAPES


def _pick(rng, chars: str, n: int) -> str:
    return "".join(chars[j] for j in rng.integers(0, len(chars), n))


def plant(rng, rs: dict, shape: int, plants: dict) -> bytes:
    """A string that matches a rule of `shape` among the first
    `rs["patterns"]`, the rule and the free parts drawn from `rng`."""
    n_patterns = rs["patterns"]
    i = shape + SHAPES * int(rng.integers(0, (n_patterns - 1 - shape)
                                          // SHAPES + 1))
    w = BD.WORDS[i % len(BD.WORDS)]
    if shape == 0:
        s = f"{w}{i}"
    elif shape == 1:
        s = f"{w}{i}{_pick(rng, '0123456789', int(rng.integers(2, 5)))}z"
    elif shape == 2:
        s = (f"x{i}{VERBS[int(rng.integers(0, 3))]} /"
             f"{_pick(rng, LOWER, int(rng.integers(1, 21)))}")
    elif shape == 3:
        s = f"q{i}h{_pick(rng, HEX, 8)}"
    elif shape == 4:
        s = f"v{i}.{EXTS[int(rng.integers(0, 3))]}"
    else:
        lo, hi = plants["gate_pairs"]
        pairs = int(rng.integers(lo, hi + 1))
        chain = "".join(("ab", "cd")[j] for j in rng.integers(0, 2, pairs))
        s = f"gate{i}x{chain}{w}{i}end"
    return s.encode()
