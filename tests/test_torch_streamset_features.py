"""The stream cases of the feature tests (tests/test_combination.py,
tests/test_edges.py, tests/test_anchored.py, tests/test_fuzzy.py,
tests/test_bitnfa.py, tests/test_utf8.py) through a StreamSet: each
case's streams, with their writes split in several ways, are the streams
of one StreamSet, written round by round and closed together. Run as a
body of torch_parity.parity (the reference's StreamSet on its host
route, and the port's on both of its routes on the CPU: its host route
and the device branch forced); in each package every stream of the set
also equals the same writes through open_stream / scan_stream /
close_stream, and the port's equal the reference's exactly."""

import numpy as np
import pytest

import torch_ref_native  # noqa: F401 (the reference's native build, locked)
from torch_parity import parity

from test_anchored import FAMILY

_rng = np.random.default_rng(9)
_NFA_DATA = bytes(_rng.choice(np.frombuffer(b"aabxy", np.uint8), size=2500))
_ANCH = b"xx attack734z yy payload12399z zz evilstring55z gadget12z"
_UTF8 = "hällo gräy hxllo h€llo gray".encode()


def _splits(data: bytes, cuts):
    out, prev = [], 0
    for c in list(cuts) + [len(data)]:
        out.append(data[prev:c])
        prev = c
    return out


# name -> (patterns, flags (names of HS_FLAG_* or-ed), ids, ext, streams:
# each a list of writes)
CASES = {
    "combination_and": (
        [r"abc", r"def", r"xyz", "101&102"], [[], [], [], ["COMBINATION"]],
        [101, 102, 103, 900], None,
        [[b"abc...", b"def"], [b"ab", b"c de", b"f"], [b"xyz"],
         [b"def", b"", b"abc"]]),
    "combination_negative_eod": (
        [r"abc", r"def", r"xyz", "!103"], [[], [], [], ["COMBINATION"]],
        [101, 102, 103, 900], None,
        [[b"abcdef"], [b"xy", b"z"], [b""], [b"ab", b"xyz", b"q"]]),
    "combination_quiet": (
        [r"abc", r"def", r"xyz", "(101|102)&!103"],
        [["QUIET"], ["QUIET"], ["QUIET"], ["COMBINATION"]],
        [101, 102, 103, 900], None,
        [[b"abc then", b" def"], [b"xyz abc"], [b"de", b"f"]]),
    "trailing_boundary": (
        [r"\bword\b"], [[]], [0], None,
        [[b"word", b"!x"], [b"word"], [b"word", b"s"],
         [b"wo", b"rd", b" "]]),
    "no_duplicate": (
        [r"word"], [[]], [0], None,
        [[b"xword", b" more"], [b"wor", b"dword"], [b"word", b"word"]]),
    "anchored_family": (
        FAMILY, [[]] * 4, [1, 2, 3, 4], None,
        [_splits(_ANCH, c) for c in ([11], [3, 20, 40], [len(_ANCH) - 2],
                                     range(5, len(_ANCH), 7))]),
    "fuzzy": (
        [r"attack"], [["ALLOWEMPTY"]], [1], [dict(edit_distance=1)],
        [[b"zz att", b"ck zz"], [b"atack", b"k"], [b"a", b"ttxck"]]),
    "bitnfa": (
        [r".*a.{18}b"], [[]], [0], None,
        [_splits(_NFA_DATA, c) for c in ([100, 500, 1400], [1, 2, 20, 21],
                                         [2499])]),
    "utf8": (
        [r"h.llo", r"gr[äa]y"], [["UTF8"], ["UTF8"]], [1, 2], None,
        [_splits(_UTF8, c) for c in ([2], [8, 13], [1, 3, 5, 7, 9, 11])]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_streamset_case(name):
    pats, flag_names, ids, ext, streams = CASES[name]
    n_rounds = max(len(w) for w in streams)

    def body(pkg):
        flags = [sum(getattr(pkg, "HS_FLAG_" + f) for f in fl)
                 for fl in flag_names]
        db = pkg.compile_ext_multi(
            pats, flags=flags, ids=ids, mode=pkg.HS_MODE_STREAM,
            ext=ext and [pkg.ExprExt(**e) for e in ext])
        ss = pkg.open_streamset(db, len(streams))
        rounds = [pkg.scan_streamset(db, ss, [
            w[r] if r < len(w) else b"" for w in streams])
            for r in range(n_rounds)]
        rounds.append(pkg.close_streamset(db, ss))
        for i, writes in enumerate(streams):
            st = pkg.open_stream(db)
            one = [pkg.scan_stream(st, w) for w in writes]
            one += [[]] * (n_rounds - len(writes)) + [pkg.close_stream(st)]
            assert [sum(one, [])] == [sum((r[i] for r in rounds), [])], i
        return rounds

    # a bit-NFA engine carries its stream state byte-serially on the host
    # in both packages (runtime/stream.py _engine_pass): no device branch
    parity(body, scans=name != "bitnfa")
