"""Plain reference for the bench ruleset (`rulesets/bench.py`): every
match (id, 0, to) of the first `rs["patterns"]` patterns of
`formulas.benchdata.patterns` in a byte string, by
Hyperscan's semantics without SOM_LEFTMOST: each pattern reports every
end offset at which some match of it ends, once, with `from` 0 and `to`
one past the match's last byte.

It reads the ruleset's six shapes from the formula, not from any compiled
table. A match of any pattern begins with a head (the pattern's word, or
`x`, `q`, `v`, `gate`) followed by the pattern's id in decimal; so the
matcher finds every head followed by digits, reads each id that a prefix
of those digits spells, and checks the rest of that id's pattern by hand:

    0  w{i}                           the literal
    1  w{i}[0-9]{2,4}z
    2  x{i}(GET|POST|PUT) /[a-z]{1,20}   one end per letter of the run
    3  q{i}h[a-f0-9]{8}
    4  v{i}\\.(exe|dll|bat)
    5  gate{i}x(ab|cd)*w{i}end

Plain Python and the standard `re` module (used only to find heads); it
imports nothing of the program.
"""

from __future__ import annotations

import re
from typing import List, Tuple

from formulas.benchdata import WORDS

_HEADS = sorted(set(WORDS) | {"x", "q", "v", "gate"}, key=len, reverse=True)
_ANCHOR = re.compile(
    b"(?=(" + b"|".join(h.encode() for h in _HEADS) + b")([0-9]+))")
_VERBS = (b"GET", b"POST", b"PUT")
_HEX = frozenset(b"0123456789abcdef")
_LOWER = frozenset(b"abcdefghijklmnopqrstuvwxyz")
_EXTS = (b"exe", b"dll", b"bat")
_SHAPE_HEAD = {2: b"x", 3: b"q", 4: b"v", 5: b"gate"}

Match = Tuple[int, int, int]


def _head_of(i: int) -> bytes:
    k = i % 6
    return WORDS[i % len(WORDS)].encode() if k < 2 else _SHAPE_HEAD[k]


def _tail_ends(data: bytes, i: int, q: int, run_end: int) -> List[int]:
    """End offsets of pattern i's matches whose id digits end at q (the
    digit run they are cut from ends at run_end)."""
    k = i % 6
    if k == 0:
        return [q]
    if k == 1:
        m = run_end - q  # the digits after the id
        if 2 <= m <= 4 and data[run_end:run_end + 1] == b"z":
            return [run_end + 1]
        return []
    if q != run_end:  # the other shapes continue with a non-digit
        return []
    if k == 2:
        for verb in _VERBS:
            r = q + len(verb) + 2
            if data.startswith(verb, q) and data[r - 2:r] == b" /":
                c = 0
                while c < 20 and r + c < len(data) and data[r + c] in _LOWER:
                    c += 1
                return [r + j for j in range(1, c + 1)]
        return []
    if k == 3:
        if data[q:q + 1] == b"h" and len(data) >= q + 9 and all(
                b in _HEX for b in data[q + 1:q + 9]):
            return [q + 9]
        return []
    if k == 4:
        if data[q:q + 1] == b"." and data[q + 1:q + 4] in _EXTS:
            return [q + 4]
        return []
    if data[q:q + 1] != b"x":
        return []
    lit = (WORDS[i % len(WORDS)] + str(i) + "end").encode()
    ends, r = [], q + 1
    while True:
        if data.startswith(lit, r):
            ends.append(r + len(lit))
        if data[r:r + 2] in (b"ab", b"cd"):
            r += 2
        else:
            return ends


def block_matches(data: bytes, rs: dict) -> List[Match]:
    """Every match of the first rs["patterns"] patterns in `data`, sorted
    by (to, id)."""
    n_patterns = rs["patterns"]
    out = set()
    for m in _ANCHOR.finditer(data):
        head, digits = m.group(1), m.group(2)
        p = m.start()
        base = p + len(head)
        run_end = base + len(digits)
        for n_dig in range(1, min(len(digits), len(str(n_patterns - 1))) + 1):
            if n_dig > 1 and digits[0] == 0x30:
                break  # an id has no leading zero
            i = int(digits[:n_dig])
            if i >= n_patterns or _head_of(i) != head:
                continue
            for to in _tail_ends(data, i, base + n_dig, run_end):
                out.add((to, i))
    return [(i, 0, to) for to, i in sorted(out)]


def stream_matches(data: bytes, rs: dict, write: int):
    """The matches of a stream whose bytes are `data`, written `write`
    bytes a round: ({round: sorted matches}, the close's matches), a
    match belonging to the round whose write holds its last byte (the
    same semantics as scanning the whole stream as one block, which holds
    for this ruleset: no pattern is anchored or asserts at the end of
    data, so the close delivers none)."""
    out = {}
    for m in block_matches(data, rs):
        out.setdefault((m[2] - 1) // write, []).append(m)
    return out, []


def single_match(data: bytes, rs: dict) -> List[Match]:
    """The block control: the block's matches under a broken guarantee,
    each pattern reported once, at its first end (as HS_FLAG_SINGLEMATCH
    would; the configuration states that every end is reported)."""
    seen, out = set(), []
    for m in block_matches(data, rs):
        if m[0] not in seen:
            seen.add(m[0])
            out.append(m)
    return out


def write_alone(data: bytes, rs: dict, write: int):
    """The stream control: each round's matches with its write scanned by
    itself, no history and no carried state (the configuration states
    that matches across write boundaries are found); the close's none."""
    out = {}
    for base in range(0, len(data), write):
        ms = [(i, f, base + to) for (i, f, to)
              in block_matches(data[base:base + write], rs)]
        if ms:
            out[base // write] = ms
    return out, []


CONTROLS = {"single_match": single_match, "write_alone": write_alone}
