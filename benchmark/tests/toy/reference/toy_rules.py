"""Plain reference for the toy ruleset, by brute force: a rule matches
with its end at e where some window of at most WINDOW bytes that ends at
e is, as a whole, a match of the rule (Python `re`, the rule's flags:
one search of the WINDOW bytes before e for the rule followed by `\\Z`,
with the string cut at e); a rule anchored with `$` only where e is the
end of the data (or the byte before a final newline). Every match is
(id, 0, e), each (id, e) once. It reads the rule file itself and imports
nothing of the program.
"""

from __future__ import annotations

import functools
import pathlib
import re

WINDOW = 16  # no match of a toy rule is longer
LINE = re.compile(r"^(\d+):/(.*)/([a-zA-Z]*)$")
FLAGS = {"i": re.IGNORECASE, "s": re.DOTALL}


@functools.lru_cache(maxsize=None)
def _rules(file: str, keep):
    """[(id, compiled rule, anchored at the end)] of the kept rules."""
    path = pathlib.Path(__file__).resolve().parents[1] / file
    out = []
    for line in path.read_text().splitlines():
        if line.strip() and not line.startswith("#"):
            i, pat, letters = LINE.match(line).groups()
            eod = pat.endswith("$")
            flags = 0
            for c in letters:
                flags |= FLAGS[c]
            body = (pat[:-1] if eod else pat).encode()
            out.append((int(i), re.compile(b"(?:" + body + rb")\Z", flags),
                        eod))
    return out[:keep]


def rules(rs: dict):
    return _rules(rs["file"], rs.get("patterns"))


def block_matches(data: bytes, rs: dict):
    """Every match of the kept rules in `data`, sorted by (to, id)."""
    n = len(data)
    last = {n, n - 1} if data.endswith(b"\n") else {n}
    out = []
    for e in range(1, n + 1):
        for i, rx, eod in rules(rs):
            if eod and e not in last:
                continue
            if rx.search(data, max(0, e - WINDOW), e):
                out.append((i, 0, e))
    return out


def stream_matches(data: bytes, rs: dict, write: int):
    """({round: matches}, the close's matches) of a stream written `write`
    bytes a round: an anchored rule's matches come at the close, every
    other match in the round whose write holds its last byte."""
    eod = {i for i, _rx, anchored in rules(rs) if anchored}
    rounds: dict = {}
    close = []
    for m in block_matches(data, rs):
        if m[0] in eod:
            close.append(m)
        else:
            rounds.setdefault((m[2] - 1) // write, []).append(m)
    return rounds, close


def eod_dropped(data: bytes, rs: dict, write: int = 0):
    """The control: every match of an anchored rule left out (the
    configuration states that they are delivered, at a block's end or at
    a stream's close). With `write`, in the form of `stream_matches`."""
    if write:
        return stream_matches(data, rs, write)[0], []
    eod = {i for i, _rx, anchored in rules(rs) if anchored}
    return [m for m in block_matches(data, rs) if m[0] not in eod]


CONTROLS = {"eod_dropped": eod_dropped}
