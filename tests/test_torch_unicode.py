"""UTF-8 mode and UCP through the port against the JAX package: every
test of tests/test_utf8.py and two of tests/test_ucp.py (the others are
in tests/test_torch_ucp.py, which splits the UCP compiles of several
seconds each between two files), as a body run by
torch_parity.parity on the reference's host route and on both of the
port's routes (its host route, and the device branch forced) on the CPU.
Each body keeps the reference test's own checks (Python `re` over the
decoded text, the SOM oracle) and returns what it saw; the port's must
equal the reference's exactly.

The UCP databases here are large DFAs (`\\w+x` under UTF8|UCP compiles
to one DfaEngine of thousands of states), which the reference scans in
Pallas interpret mode far too slowly to serve as a reference above its
host limit; torch_parity holds the port to its host route."""

import re as pyre

import pytest

import torch_ref_native  # noqa: F401 (the reference's native build, locked)
from hyperscan_tpu.compiler.parser import parse
from hyperscan_tpu.utils.oracle import ast_leftmost_som
from torch_parity import parity, raises

import test_utf8


def _ends(ms):
    return {t for (_i, _f, t) in ms}


# --- tests/test_utf8.py ------------------------------------------------------


@pytest.mark.parametrize("pat,data", test_utf8.CASES)
def test_utf8_vs_python_re(pat, data):
    want = test_utf8._oracle_ends(pat, data)

    def body(pkg):
        got = pkg.scan(pkg.compile(pat, flags=pkg.HS_FLAG_UTF8), data)
        assert _ends(got) == want, pat
        return got

    parity(body)


def test_utf8_caseless_ascii_fold():
    def body(pkg):
        got = pkg.scan(pkg.compile(
            r"WÖrd", flags=pkg.HS_FLAG_UTF8 | pkg.HS_FLAG_CASELESS),
            "wÖrd WÖRD wörd".encode())
        assert _ends(got) == {5, 11}
        return got

    parity(body)


def test_utf8_emoji_literal():
    def body(pkg):
        got = pkg.scan(pkg.compile(r"\x{1F600}!", flags=pkg.HS_FLAG_UTF8),
                       "hi 😀! 😀x".encode())
        assert _ends(got) == {8}
        return got

    parity(body)


def test_invalid_utf8_pattern_rejected():
    def body(pkg):
        err = raises(pkg, pkg.compile, b"\xff\xfe", flags=pkg.HS_FLAG_UTF8)
        assert err == "CompileError"
        return err

    parity(body, scans=False)


@pytest.mark.parametrize("pat,data", test_utf8.UCP_WB_CASES)
def test_ucp_utf8_word_boundary(pat, data):
    want = test_utf8._oracle_ends(pat, data, pyre.UNICODE)

    def body(pkg):
        got = pkg.scan(pkg.compile(
            pat, flags=pkg.HS_FLAG_UTF8 | pkg.HS_FLAG_UCP), data)
        assert _ends(got) == want, pat
        return got

    parity(body)


def test_ucp_word_boundary_latin1():
    def body(pkg):
        got = pkg.scan(pkg.compile(r"\bfoo\b", flags=pkg.HS_FLAG_UCP),
                       b"foo \xe9foo foo\xe9 .foo.")
        assert _ends(got) == {3, 18}
        return got

    parity(body)


def test_ucp_utf8_som_word_boundary():
    pats = [r"\bλfoo", r"\bword", r"λx\b", r"\Bend"]
    corpora = [
        "λfoo ωλfoo .λfoo word éword λx€ λxω end bend".encode(),
        "𝛌word λfoo".encode(),
        b"",
    ]

    def body(pkg):
        F = pkg.HS_FLAG_UTF8 | pkg.HS_FLAG_UCP | pkg.HS_FLAG_SOM_LEFTMOST
        out = []
        for pat in pats:
            db = pkg.compile(pat, flags=F)
            for data in corpora:
                want = {(frm, to) for (to, frm)
                        in ast_leftmost_som(parse(pat, F), data).items()}
                got = pkg.scan(db, data)
                assert {(f, t) for (_i, f, t) in got} == want, (pat, data)
                out.append(got)
        return out

    parity(body)


def test_non_utf8_rejects_wide_codepoint():
    def body(pkg):
        err = raises(pkg, pkg.compile, r"\x{20AC}")
        assert err == "CompileError"
        return err

    parity(body, scans=False)


# --- tests/test_ucp.py: the property cases (the rest are in
# tests/test_torch_ucp.py) ---------------------------------------------------


def test_ucp_category_casing():
    def body(pkg):
        got = pkg.scan(pkg.compile(
            r"\p{Lu}\p{Ll}+q", flags=pkg.HS_FLAG_UTF8 | pkg.HS_FLAG_UCP),
            "Wordq Σοφq σοφq".encode())
        assert _ends(got) == {5, 13}
        return got

    parity(body)


def test_prop_brace_negation():
    d = "aBc δΔ 9".encode("utf-8")
    pairs = [(r"\p{^Lu}+", r"\P{Lu}+"), (r"\P{^Lu}+", r"\p{Lu}+"),
             (r"[\p{^Nd}]x", r"[\P{Nd}]x")]

    def body(pkg):
        fl = [pkg.HS_FLAG_UTF8 | pkg.HS_FLAG_UCP]
        out = []
        for a, b in pairs:
            got = pkg.scan(pkg.compile_multi([a], ids=[1], flags=fl), d)
            assert got == pkg.scan(pkg.compile_multi([b], ids=[1], flags=fl),
                                   d), (a, b)
            out.append(got)
        return out

    parity(body)
