"""The exact re-verification of confirmed literal pairs.

`runtime.lit_runtime.verify_pairs` compares every pair in one gather and
compare for each width class of factor length present; the reference's
`verify_pairs` loops over the distinct factor ids. Both are handed the
same hand-built factor tables (factors of every width class, the longest
past 64 B, which no compiled database holds) and the same pairs, and
must return the same arrays in the same order. The host route's
long-tail confirm (`confirm_candidates` without the native library)
shares the compare and is held to the reference's the same way.
`trace.COUNTS["verify_passes"]` shows that the compares do not grow
with the number of distinct factors.
"""

import types

import numpy as np
import pytest

from hyperscan_tpu.runtime.lit_runtime import confirm_candidates as ref_cc
from hyperscan_tpu.runtime.lit_runtime import verify_pairs as ref_verify
from hyperscan_tpu_torch import trace as T
from hyperscan_tpu_torch.runtime.lit_runtime import (confirm_candidates,
                                                     verify_pairs)

WIDTHS = (1, 5, 8, 9, 14, 16, 17, 31, 32, 33, 63, 64, 65, 100, 128, 129,
          200)


def _exact(b: bytes):
    return tuple((c, 0xFF) for c in b)


def _caseless(b: bytes):
    return tuple((c & 0xDF, 0xDF) if chr(c).isalpha() else (c, 0xFF)
                 for c in b)


def _lits(factors):
    """One literal table for each package, so that neither reads the
    other's cached tables."""
    return (types.SimpleNamespace(factor_atoms=list(factors)),
            types.SimpleNamespace(factor_atoms=list(factors)))


def _text(rng, n: int) -> bytes:
    return bytes(rng.integers(0x61, 0x7B, n, dtype=np.uint8))


class _Build:
    """A corpus of printable noise, factors planted in it, and the pairs
    a device confirm could hand over."""

    def __init__(self, seed: int, n: int = 1 << 14):
        self.rng = np.random.default_rng(seed)
        self.corpus = bytearray(self.rng.integers(0x20, 0x7F, n,
                                                  dtype=np.uint8))
        self.factors = []
        self.fid = []
        self.pos = []

    def factor(self, atoms) -> int:
        self.factors.append(atoms)
        return len(self.factors) - 1

    def plant(self, fid: int, end: int, data: bytes = None) -> int:
        atoms = self.factors[fid]
        if data is None:
            data = bytes(v for (v, _m) in atoms)
        self.corpus[end - len(data) + 1:end + 1] = data
        self.pair(fid, end)
        return end

    def pair(self, fid: int, end: int):
        self.fid.append(fid)
        self.pos.append(end)

    def done(self, block_starts=(0,), shuffle=True):
        fid = np.asarray(self.fid, np.int64)
        pos = np.asarray(self.pos, np.int64)
        if shuffle:
            o = self.rng.permutation(len(fid))
            fid, pos = fid[o], pos[o]
        return (self.factors, np.frombuffer(bytes(self.corpus), np.uint8),
                np.asarray(block_starts, np.int64), fid, pos)


def _widths():
    """Every width class, each factor planted twice, a pair with one byte
    off, and a pair at a random place."""
    b = _Build(1)
    for i, w in enumerate(WIDTHS):
        f = b.factor(_exact(_text(b.rng, w)))
        b.plant(f, 300 + 600 * i)
        b.plant(f, 9000 + 400 * i)
        bad = bytearray(v for (v, _m) in b.factors[f])
        bad[0] ^= 0x01
        b.plant(f, 600 + 600 * i, bytes(bad))
        b.pair(f, int(b.rng.integers(w, 16000)))
    return b.done()


def _block_cross():
    """Factors whose bytes match but that start before their block's
    start drop; the same factors inside a block stay."""
    b = _Build(2)
    starts = (0, 1000, 2500, 4000, 9000)
    for i, w in enumerate((4, 12, 16, 40, 90)):
        f = b.factor(_exact(_text(b.rng, w)))
        s = starts[1 + i % 4]
        b.plant(f, s + w // 2)  # crosses the block start
        b.plant(f, s + w - 1)  # starts exactly at it
        b.plant(f, s - 1)  # ends just before it
    return b.done(starts)


def _offset0():
    """Pairs ending near offset 0: a factor starting at byte 0 stays, one
    that would start before it drops."""
    b = _Build(3)
    for w in (1, 3, 16, 20, 70):
        f = b.factor(_exact(_text(b.rng, w)))
        b.plant(f, w - 1)
        for end in range(0, w - 1, max(1, w // 4)):
            b.pair(f, end)
    return b.done((0, 5000))


def _caseless_case():
    """Caseless atoms match either case; a differing non-letter drops."""
    b = _Build(4)
    for i, w in enumerate((6, 15, 30, 66)):
        word = bytes(b.rng.choice(np.frombuffer(b"ab-cd.ef:gh", np.uint8),
                                  w))
        f = b.factor(_caseless(word))
        for k in range(4):
            flip = b.rng.integers(0, 2, w).astype(bool)
            data = bytes(c ^ 0x20 if fl and chr(c).isalpha() else c
                         for c, fl in zip(word, flip))
            b.plant(f, 400 + 2000 * i + 300 * k, data)
        bad = bytearray(word)
        bad[word.index(b"-") if b"-" in word else 0] ^= 0x02
        b.plant(f, 1500 + 2000 * i, bytes(bad))
    return b.done()


def _duplicates():
    """The kconfirm family can hand a pair over more than once; every
    copy is kept or dropped as the first."""
    b = _Build(5)
    for w in (7, 16, 24, 80):
        f = b.factor(_exact(_text(b.rng, w)))
        end = int(b.rng.integers(w, 15000))
        b.plant(f, end)
        b.pair(f, end)
        b.pair(f, end)
        b.pair(f, end + 1)
        b.pair(f, end + 1)
    return b.done()


def _collisions():
    """Factors that share their last eight bytes (one device hash class)
    but differ before them: the pair of the factor that is not there
    drops."""
    b = _Build(6)
    for i, w in enumerate((12, 16, 33, 70)):
        tail = _text(b.rng, 8)
        fa = b.factor(_exact(_text(b.rng, w - 8) + tail))
        fb = b.factor(_exact(_text(b.rng, w - 8) + tail))
        end = b.plant(fa, 500 + 3000 * i)
        b.pair(fb, end)
        end = b.plant(fb, 2000 + 3000 * i)
        b.pair(fa, end)
    return b.done()


def _empty():
    b = _Build(7)
    b.factor(_exact(b"abc"))
    return b.done()


def _mixed():
    """Many factors of random widths and case, planted in a corpus of
    several blocks, beside random pairs and other factors' pairs at the
    plants' ends."""
    b = _Build(8, 1 << 16)
    for _ in range(300):
        w = int(b.rng.choice([int(b.rng.integers(1, 17)),
                              int(b.rng.integers(17, 140))]))
        word = _text(b.rng, w)
        b.factor(_caseless(word) if b.rng.random() < 0.3 else _exact(word))
    F = len(b.factors)
    for _ in range(1500):
        f = int(b.rng.integers(F))
        end = int(b.rng.integers(200, 65000))
        b.plant(f, end)
        b.pair(int(b.rng.integers(F)), end)
    for _ in range(1500):
        b.pair(int(b.rng.integers(F)), int(b.rng.integers(0, 1 << 16)))
    return b.done(np.arange(0, 1 << 16, 4096))


CASES = {"widths": _widths, "block_cross": _block_cross,
         "offset0": _offset0, "caseless": _caseless_case,
         "duplicates": _duplicates, "collisions": _collisions,
         "empty": _empty, "mixed": _mixed}


@pytest.mark.parametrize("case", list(CASES))
def test_verify_pairs_equals_reference(case):
    factors, corpus, starts, fid, pos = CASES[case]()
    ref_lit, lit = _lits(factors)
    want_f, want_p = ref_verify(ref_lit, corpus, starts, fid, pos)
    got_f, got_p = verify_pairs(lit, corpus, starts, fid, pos)
    assert got_f.dtype == want_f.dtype and got_p.dtype == want_p.dtype
    assert np.array_equal(got_f, want_f)
    assert np.array_equal(got_p, want_p)
    if case == "empty":
        assert got_f.size == 0
    else:
        # some pairs stay and some drop, so both sides were exercised
        assert 0 < got_f.size < fid.size


@pytest.mark.parametrize("lengths,passes", [((1, 17), 1), ((1, 129), 4)])
def test_verify_passes_do_not_grow_with_the_factors(lengths, passes):
    """500 distinct factors in one call: one compare for each width class
    present (16, 32, 64, 128 bytes), not one for each factor."""
    b = _Build(9, 1 << 17)
    for i in range(500):
        w = lengths[0] + i % (lengths[1] - lengths[0])
        b.plant(b.factor(_exact(_text(b.rng, w))), 200 + 260 * i)
    factors, corpus, starts, fid, pos = b.done()
    ref_lit, lit = _lits(factors)
    before = dict(T.COUNTS)
    got = verify_pairs(lit, corpus, starts, fid, pos)
    assert T.COUNTS["verify_passes"] - before["verify_passes"] == passes
    assert T.COUNTS["verify_pairs"] - before["verify_pairs"] == 500
    want = ref_verify(ref_lit, corpus, starts, fid, pos)
    assert np.array_equal(got[0], want[0]) and got[0].size == 500
    assert np.array_equal(got[1], want[1])


@pytest.mark.parametrize("case", ["widths", "collisions", "caseless"])
def test_long_tail_confirm_equals_reference(case, monkeypatch):
    """The host route's confirm checks a factor longer than its 8-byte
    tail with the same compare; every corpus position is a candidate."""
    factors, corpus, starts, _fid, _pos = CASES[case]()
    ref_lit, lit = _lits(factors)
    monkeypatch.setenv("HSTPU_NO_NATIVE", "1")
    pos = np.arange(corpus.shape[0], dtype=np.int64)
    words = np.zeros((1, pos.shape[0]), np.int32)
    want_f, want_p = ref_cc(ref_lit, corpus, starts, pos, words)
    got_f, got_p = confirm_candidates(lit, corpus, starts, pos, words)
    assert np.array_equal(got_f, want_f)
    assert np.array_equal(got_p, want_p)
    long = np.asarray([len(factors[f]) > 8 for f in got_f.tolist()])
    assert long.any()
    assert (~long).any() or case != "widths"
