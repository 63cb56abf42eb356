"""Determinization, minimization and the DFA engine's device routes
through the port against the JAX package: every test of
tests/test_dfa.py. The port's determinize + dfa_scan_reference is held
to the reference test's NFA oracle and to the reference's DFA; each
pattern set is then compiled and scanned as a body of
torch_parity.parity (the reference's host route, and both of the port's
routes on the CPU: its host route and the device branch forced), equal
to the reference's exactly. The speculative cases drive the port's
speculative chunk scan (kernel C's plain version on the CPU) and its
host rescans."""

from unittest import mock

import numpy as np
import pytest

import torch_ref_native  # noqa: F401 (the reference's native build, locked)
from hyperscan_tpu.compiler import dfa as ref_dfa
from hyperscan_tpu.compiler import glushkov as ref_glushkov
from hyperscan_tpu.compiler import parser as ref_parser
from hyperscan_tpu.utils.oracle import nfa_match_ends
from hyperscan_tpu_torch.compiler.dfa import determinize, dfa_scan_reference
from hyperscan_tpu_torch.compiler.glushkov import build_nfa
from hyperscan_tpu_torch.compiler.parser import parse
from hyperscan_tpu_torch.flags import (HS_FLAG_CASELESS, HS_FLAG_DOTALL,
                                       HS_FLAG_MULTILINE)
from hyperscan_tpu_torch.ops.dfa_kernel import (
    SPEC_CS, dfa_scan_corpus_device_speculative)
from hyperscan_tpu_torch.runtime import smallwrite
from hyperscan_tpu_torch.utils.oracle import ast_match_ends
from torch_parity import DEVICE, REF, parity

from test_frontend import ANCHOR_PATTERNS, CORPORA, RE_PATTERNS

ALL_PATTERNS = RE_PATTERNS + ANCHOR_PATTERNS


def _ref_nfa(p, f):
    return ref_glushkov.build_nfa(ref_parser.parse(p, f))


def _ends(ms):
    return {t for (_i, _f, t) in ms}


def _scan_parity(patset):
    """Compile `patset` with ALLOWEMPTY and scan every corpus, on each
    route; the match sets also equal the NFA oracle's."""
    wants = [{(i, e) for i, (p, f) in enumerate(patset)
              for e in nfa_match_ends(_ref_nfa(p, f), data)}
             for data in CORPORA]

    def body(pkg):
        db = pkg.compile_multi(
            [p for p, _ in patset],
            flags=[f | pkg.HS_FLAG_ALLOWEMPTY for _, f in patset],
            ids=list(range(len(patset))))
        out = [pkg.scan(db, data) for data in CORPORA]
        for data, ms, want in zip(CORPORA, out, wants):
            assert {(i, t) for (i, _f, t) in ms} == want, data
        return out

    parity(body)


@pytest.mark.parametrize("pattern,flags", ALL_PATTERNS)
def test_dfa_single_pattern(pattern, flags):
    g = build_nfa(parse(pattern, flags))
    d = determinize([g], [7])
    rd = ref_dfa.determinize([_ref_nfa(pattern, flags)], [7])
    assert (d.num_states, d.num_classes) == (rd.num_states, rd.num_classes)
    for data in CORPORA:
        want = {(7, e) for e in nfa_match_ends(_ref_nfa(pattern, flags),
                                               data)}
        assert dfa_scan_reference(d, data) == want, (pattern, flags, data)
    _scan_parity([(pattern, flags)])


MULTI_SETS = [
    [(r"abc", 0), (r"a.c", HS_FLAG_DOTALL), (r"[a-c]+", 0)],
    [(r"^line\d", HS_FLAG_MULTILINE), (r"\bfoo\b", 0), (r"end$", 0)],
    [(r"quick|lazy", HS_FLAG_CASELESS), (r"\w{5,}", 0), (r"\s[a-z]", 0)],
    [(r"a", 0), (r"aa", 0), (r"aaa", 0), (r"a{4}", 0)],
]


@pytest.mark.parametrize("patset", MULTI_SETS)
def test_dfa_multi_pattern(patset):
    d = determinize([build_nfa(parse(p, f)) for (p, f) in patset],
                    list(range(len(patset))))
    rd = ref_dfa.determinize([_ref_nfa(p, f) for (p, f) in patset],
                             list(range(len(patset))))
    assert d.num_states == rd.num_states
    for data in CORPORA:
        want = {(i, e) for i, (p, f) in enumerate(patset)
                for e in nfa_match_ends(_ref_nfa(p, f), data)}
        assert dfa_scan_reference(d, data) == want, (patset, data)
    _scan_parity(patset)


def test_minimization_shrinks():
    d = determinize([build_nfa(parse(r"ab|ab|a[b]"))], [0])
    d2 = determinize([build_nfa(parse(r"ab"))], [0])
    assert d.num_states == d2.num_states == ref_dfa.determinize(
        [_ref_nfa(r"ab|ab|a[b]", 0)], [0]).num_states
    _scan_parity([(r"ab|ab|a[b]", 0), (r"ab", 0)])


def test_alphabet_remap_small():
    d = determinize([build_nfa(parse(r"abc"))], [0])
    assert d.num_classes == 4
    assert d.byte_to_class.tolist() == ref_dfa.determinize(
        [_ref_nfa(r"abc", 0)], [0]).byte_to_class.tolist()
    _scan_parity([(r"abc", 0)])


def test_speculative_unbounded_device_scan():
    pat = r"\d+[a-z]{3,}\d+"
    rng = np.random.default_rng(7)
    d = bytearray(rng.integers(32, 127, 40000, dtype=np.uint8).tobytes())
    d[1000:1012] = b"12abcdef3456"
    d[30000:30010] = b"9zzzzzzzz8"
    d = bytes(d)
    want = ast_match_ends(parse(pat, HS_FLAG_DOTALL), d)
    pat2 = r"q[a-y]*z"
    d2 = b"q" + b"m" * (SPEC_CS * 20) + b"z" + b"qmz"
    want2 = ast_match_ends(parse(pat2, HS_FLAG_DOTALL), d2)

    def body(pkg):
        db = pkg.compile(pat, flags=pkg.HS_FLAG_DOTALL)
        (eng,) = db.engines
        assert eng.max_depth is None
        got = pkg.scan(db, d)
        assert _ends(got) == want
        got2 = pkg.scan(pkg.compile(pat2, flags=pkg.HS_FLAG_DOTALL), d2)
        assert _ends(got2) == want2
        return got, got2

    parity(body)

    # direct-call parity with the host engine scan across several blocks
    db2 = DEVICE.compile(pat2, flags=DEVICE.HS_FLAG_DOTALL)
    (eng2,) = db2.engines
    blocks = [d2[:7000], d2[7000:], b"", b"qaz"]
    recs, finals = dfa_scan_corpus_device_speculative(
        eng2, blocks, np.ones(len(blocks), dtype=bool), device="cpu")
    for bi, blk in enumerate(blocks):
        row = np.frombuffer(blk, np.uint8)[None, :] if blk else \
            np.zeros((1, 0), np.uint8)
        hits, fin_h = smallwrite.dfa_scan_host(
            eng2, row, np.asarray([len(blk)], np.int64),
            np.asarray([eng2.start_state], np.int32))
        sel = recs[0] == bi
        assert sorted(zip(recs[1][sel].tolist(), recs[2][sel].tolist())) == \
            sorted(zip(hits[0][0].tolist(), hits[0][1].tolist())), bi
        assert int(finals[bi]) == int(fin_h[0]), bi


def test_speculative_dfa_adversarial_full_miss_exact():
    """Nearly every 512-byte chunk boundary sits mid-match: the
    speculation misses, the host pass rescans the missed chunks, and the
    result stays exact, equal to the reference's host route."""
    pat = r"\d+[a-z]{3,}\d+"
    unit = b"123456789" * 40 + b"abcdefgh" * 40 + b"55"
    data = (unit * (300_000 // len(unit)))[:260_000]
    want = REF.scan(REF.compile_patterns([pat], [REF.HS_FLAG_DOTALL],
                                         allow_teddy=False), data)
    assert len(want) > 100
    db = DEVICE.compile_patterns([pat], [DEVICE.HS_FLAG_DOTALL],
                                 allow_teddy=False)
    assert db.engines[0].max_depth is None
    real = smallwrite.dfa_scan_host
    calls = {"n": 0}

    def counting(*a, **k):
        calls["n"] += 1
        return real(*a, **k)

    with mock.patch.object(smallwrite, "dfa_scan_host", side_effect=counting):
        got = DEVICE.scan(db, data)
    assert calls["n"] >= 100, calls
    assert got == want
