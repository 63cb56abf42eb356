"""The port's copy of the compile front end (parser, Glushkov NFA, the
oracles) against the JAX package's: every test of tests/test_frontend.py.

The parser and oracle cases hold the port's parse, build_nfa,
ast_match_ends and nfa_match_ends to Python `re`, to each other and to
the reference's; each pattern is then compiled and its corpora scanned
as a body of torch_parity.parity (the reference's host route, and both
of the port's routes on the CPU: its host route and the device branch
forced), equal to the reference's exactly. Parse errors carry the same
message and expression index in both packages."""

import numpy as np
import pytest

import torch_ref_native  # noqa: F401 (the reference's native build, locked)
from hyperscan_tpu.compiler import glushkov as ref_glushkov
from hyperscan_tpu.compiler import parser as ref_parser
from hyperscan_tpu.errors import CompileError as RefCompileError
from hyperscan_tpu.utils import oracle as ref_oracle
from hyperscan_tpu_torch.compiler.glushkov import build_nfa
from hyperscan_tpu_torch.compiler.parser import parse
from hyperscan_tpu_torch.errors import CompileError
from hyperscan_tpu_torch.flags import HS_FLAG_DOTALL, HS_FLAG_UTF8
from hyperscan_tpu_torch.utils.oracle import ast_match_ends, nfa_match_ends
from torch_parity import parity

from test_frontend import ANCHOR_PATTERNS, CORPORA, RE_PATTERNS, re_ends


def _ends(ms):
    return {t for (_i, _f, t) in ms}


def _batch_parity(pattern, flags):
    """scan_batch of every corpus through the compiled pattern, on each
    route, equal to the reference's and to the AST oracle."""
    wants = [ast_match_ends(parse(pattern, flags), d) for d in CORPORA]

    def body(pkg):
        db = pkg.compile(pattern, flags | pkg.HS_FLAG_ALLOWEMPTY)
        out = pkg.scan_batch(db, CORPORA)
        assert [_ends(ms) for ms in out] == wants, pattern
        return out

    parity(body)


@pytest.mark.parametrize("pattern,flags", RE_PATTERNS)
def test_ast_oracle_vs_re(pattern, flags):
    ast = parse(pattern, flags)
    for data in CORPORA:
        assert ast_match_ends(ast, data) == re_ends(pattern, flags, data), \
            (pattern, flags, data)
    _batch_parity(pattern, flags)


@pytest.mark.parametrize("pattern,flags", RE_PATTERNS + ANCHOR_PATTERNS)
def test_nfa_vs_ast_oracle(pattern, flags):
    ast = parse(pattern, flags)
    g = build_nfa(ast)
    rg = ref_glushkov.build_nfa(ref_parser.parse(pattern, flags))
    assert g.num_positions == rg.num_positions
    for data in CORPORA:
        want = ast_match_ends(ast, data)
        assert nfa_match_ends(g, data) == want, (pattern, flags, data)
        assert ref_oracle.nfa_match_ends(rg, data) == want
    _batch_parity(pattern, flags)


PARSE_ERRORS = [
    r"a(b", r")", r"a**", r"*a", r"a{2,1}",
    r"(?=x)y", r"(?<=x)y", r"(?<!x)y", r"x(?!y)", r"(?>ab)",
    r"(a)\1", "a" + chr(92), r"[a", r"a{100000}", r"a*+",
]


def _error(parse_fn, err_cls, *args):
    with pytest.raises(err_cls) as e:
        parse_fn(*args)
    return str(e.value)


def test_parse_errors():
    for bad in PARSE_ERRORS:
        assert _error(parse, CompileError, bad) == \
            _error(ref_parser.parse, RefCompileError, bad), bad

    def body(pkg):
        out = []
        for k, bad in enumerate(PARSE_ERRORS):
            pats = ["ok1", "ok2"]
            pats.insert(k % 3, bad)
            try:
                pkg.compile_multi(pats)
            except pkg.CompileError as e:
                assert e.expression == k % 3, (bad, e.expression)
                out.append((e.message, e.expression))
            else:
                raise AssertionError(f"{bad!r} compiled")
        return out

    parity(body, scans=False)


def test_parse_literal_braces():
    assert ast_match_ends(parse(r"a{,2}"), b"xa{,2}") == {6}
    assert ast_match_ends(parse(r"a{b}"), b"a{b}") == {4}

    def body(pkg):
        out = [pkg.scan(pkg.compile(r"a{,2}"), b"xa{,2}"),
               pkg.scan(pkg.compile(r"a{b}"), b"a{b}")]
        assert [_ends(ms) for ms in out] == [{6}, {4}]
        return out

    parity(body)


def test_anchored_empty_cases():
    assert ast_match_ends(parse(r"^"), b"abc") == {0}
    assert ast_match_ends(parse(r"^"), b"") == {0}
    assert ast_match_ends(parse(r"$"), b"abc") == {3}
    assert ast_match_ends(parse(r"$"), b"abc\n") == {3, 4}
    assert nfa_match_ends(build_nfa(parse(r"$")), b"abc\n") == {3, 4}

    def body(pkg):
        out = []
        for pat, data, want in ((r"^", b"abc", {0}), (r"^", b"", {0}),
                                (r"$", b"abc", {3}),
                                (r"$", b"abc\n", {3, 4})):
            out.append(pkg.scan(pkg.compile(pat, pkg.HS_FLAG_ALLOWEMPTY),
                                data))
            assert _ends(out[-1]) == want, (pat, data)
        return out

    parity(body)


def test_word_boundary_trailing():
    g = build_nfa(parse(r"foo\b"))
    cases = [(b"foo,", {3}), (b"foo", {3}), (b"foobar", set())]
    for data, want in cases:
        assert nfa_match_ends(g, data) == want

    def body(pkg):
        db = pkg.compile(r"foo\b")
        out = [pkg.scan(db, data) for data, _w in cases]
        assert [_ends(ms) for ms in out] == [w for _d, w in cases]
        return out

    parity(body)


def test_eos_chain():
    ast = parse(r"a$\z")
    g = build_nfa(ast)
    for data in [b"a", b"a\n", b"ab"]:
        assert nfa_match_ends(g, data) == ast_match_ends(ast, data), data
    assert nfa_match_ends(g, b"a") == {1}
    assert nfa_match_ends(g, b"a\n") == set()

    def body(pkg):
        db = pkg.compile(r"a$\z")
        out = [pkg.scan(db, d) for d in (b"a", b"a\n", b"ab")]
        assert [_ends(ms) for ms in out] == [{1}, set(), set()]
        return out

    parity(body)


def test_component_splitting_routes_branches():
    pat = r"attackword|foo.*bar|[0-9]{40,}"
    node = parse(pat, 0)
    rng = np.random.default_rng(3)
    datas = []
    for _ in range(25):
        d = b""
        for plant in [b"attackword", b"foo", b"bar", b"5" * 45]:
            if rng.integers(0, 2):
                d += plant
            d += bytes(rng.choice(np.frombuffer(b"atfobr5 w", np.uint8),
                                  size=int(rng.integers(0, 20))))
        datas.append(d)
    wants = [ast_match_ends(node, d) for d in datas]

    def body(pkg):
        db = pkg.compile_multi([r"attackword|foo.*bar|[0-9]{500,}"])
        assert db.lit is not None and 0 in db.lit.chains
        assert any(isinstance(e, pkg.database.LbrEngine) for e in db.engines)
        db2 = pkg.compile_multi([pat])
        out = [pkg.scan(db2, d) for d in datas]
        assert [_ends(ms) for ms in out] == wants
        return out

    parity(body)


def test_assertion_chain_at_start():
    cases = [
        (r"^\b", 0, b"aaa", {0}),
        (r"^\b", 0, b" aa", set()),
        (r"\A\b", 0, b"aaa", {0}),
        (r"\A\B", 0, b"", {0}),
        (r"\A\B", 0, b"aaa", set()),
        (r"^\B", 0, b"", {0}),
        (r"^\B$", 0, b"", {0}),
        (r"\b\bfoo", 0, b"foobar foo bar", {3, 10}),
        (r"^\b\bfoo", 0, b"foobar foo bar", {3}),
        (r"(a|\A\b)", 0, b"aaa", {0, 1, 2, 3}),
        (r"\b(.*)\b", HS_FLAG_DOTALL, b"aaa", {0, 3}),
        (r"\b.*\b", HS_FLAG_DOTALL, b"aaa", {0, 3}),
    ]
    for pat, fl, data, want in cases:
        assert ast_match_ends(parse(pat, fl), data) == want, (pat, data)

    def body(pkg):
        out = []
        for pat, fl, data, want in cases:
            out.append(pkg.scan(pkg.compile(
                pat, flags=fl | pkg.HS_FLAG_ALLOWEMPTY), data))
            assert _ends(out[-1]) == want, (pat, data)
        return out

    parity(body)


def test_malformed_hex_escape_is_compile_error():
    for pat in (r"[\x{31g}]", r"[\x{foo}-~]", r"[\x00-\x{31g}]", r"[\x{31]"):
        assert _error(parse, CompileError, pat) == \
            _error(ref_parser.parse, RefCompileError, pat), pat


def test_quantified_assertions_reduce():
    cases = [
        (r"(^)?foo", b"xfoo foo", {4, 8}),
        (r"(^)*foo", b"xfoo", {4}),
        (r"(^)+foo", b"foo xfoo", {3}),
        (r"foo(\z)?", b"foofoo", {3, 6}),
        (r"((\b){2,})+", b"ab cd", {0, 2, 3, 5}),
        (r"(\b[a-f]\b)+", b"a b xx c", {1, 3, 8}),
        (r"((\b|a){2,})+", b"aaa b", {0, 1, 2, 3, 4, 5}),
        (r"l(\B.)*", b"hello", {3, 4, 5}),
    ]
    for pat, data, want in cases:
        assert ast_match_ends(parse(pat, 0), data) == want, pat

    def body(pkg):
        out = []
        for pat, data, want in cases:
            out.append(pkg.scan(pkg.compile(pat, flags=pkg.HS_FLAG_ALLOWEMPTY),
                                data))
            assert _ends(out[-1]) == want, pat
        return out

    parity(body)


def test_class_quoting_and_property_escapes():
    cases = [
        (r"[\Q^\Ea]", b"x^a", {2, 3}),
        (r"[\Qa]\E]", b"a]b", {1, 2}),
        (r"[\E]]", b"]x", {1}),
        (r"[ab-\Q\E]", b"ab-x", {1, 2, 3}),
        (r"[a-\Qe\Ex]", b"cx!", {1, 2}),
        (r"[\81]", b"819", {1, 2}),
        (r"[\W\p{Any}]", b"a!", {1, 2}),
        (r"\p{L}", b"a1", {1}),
        (r"\C", b"\xffz", {1, 2}),
    ]
    assert _error(parse, CompileError, r"\C", HS_FLAG_UTF8) == \
        _error(ref_parser.parse, RefCompileError, r"\C", HS_FLAG_UTF8)
    assert _error(parse, CompileError, r"\X") == \
        _error(ref_parser.parse, RefCompileError, r"\X")

    def body(pkg):
        out = []
        for pat, data, want in cases:
            out.append(pkg.scan(pkg.compile(pat), data))
            assert _ends(out[-1]) == want, pat
        return out

    parity(body)


def test_prefilter_conditionals_and_named_groups():
    assert _error(parse, CompileError, r"(?(1)yes|no)") == \
        _error(ref_parser.parse, RefCompileError, r"(?(1)yes|no)")

    def body(pkg):
        named = pkg.scan(pkg.compile(r"(?'name'foo)bar"), b"foobar")
        assert named == [(0, 0, 6)]
        cond = pkg.scan(pkg.compile(
            r"((?'animal'hamster)|guinea pig) (?('animal')party|nothing)",
            flags=pkg.HS_FLAG_PREFILTER), b"hamster party")
        assert (0, 0, 13) in cond
        return named, cond

    parity(body)


def test_control_verbs_and_braced_octal():
    for bad in (r"(*CRLF)foo", r"(*BOGUS)foo", r"\o{9}", r"\o{110000}"):
        assert _error(parse, CompileError, bad) == \
            _error(ref_parser.parse, RefCompileError, bad), bad

    def body(pkg):
        out = [pkg.scan(pkg.compile(r"(*UTF8)\x{7a7a}"), "空".encode()),
               pkg.scan(pkg.compile(r"(*UCP)(*UTF)\w"), "δ".encode()),
               pkg.scan(pkg.compile(r"\o{101}"), b"A")]
        assert out == [[(0, 0, 3)], [(0, 0, 2)], [(0, 0, 1)]]
        return out

    parity(body)
