"""The public API and its edge cases through the port against the JAX
package: every test of tests/test_api.py and tests/test_edges.py, as a
body run by torch_parity.parity on the reference's host route and on
both of the port's routes (its host route, and the device branch forced)
on the CPU. Each body keeps the reference test's own checks (the NFA
oracle, its asserts) and returns the match lists, error classes and
values it saw; the port's must equal the reference's exactly."""

import numpy as np
import pytest

import torch_ref_native  # noqa: F401 (the reference's native build, locked)
from hyperscan_tpu.compiler.glushkov import build_nfa
from hyperscan_tpu.compiler.parser import parse
from hyperscan_tpu.utils.oracle import nfa_match_ends
from torch_parity import parity, raises

from test_frontend import ANCHOR_PATTERNS, CORPORA, RE_PATTERNS

ALL_PATTERNS = RE_PATTERNS + ANCHOR_PATTERNS


def oracle_matches(patterns, data):
    want = set()
    for (pid, (p, f)) in enumerate(patterns):
        g = build_nfa(parse(p, f))
        want |= {(pid, 0, e) for e in nfa_match_ends(g, data)}
    return want


# --- tests/test_api.py -------------------------------------------------------


@pytest.mark.parametrize("pattern,flags", ALL_PATTERNS[::3])
def test_scan_single(pattern, flags):
    wants = [oracle_matches([(pattern, flags)], data) for data in CORPORA]

    def body(pkg):
        db = pkg.compile(pattern, flags | pkg.HS_FLAG_ALLOWEMPTY)
        out = []
        for data, want in zip(CORPORA, wants):
            got = pkg.scan(db, data)
            assert set(got) == want, f"{pkg}: {pattern!r} on {data!r}"
            out.append(got)
        return out

    parity(body)


def test_scan_multi_ids():
    pats = [r"abc", r"a.c", r"[abc]{3}", r"\bfox\b"]
    ids = [10, 20, 30, 40]
    data = b"The quick brown fox jumps abcabc"
    want = set()
    for i, p in enumerate(pats):
        want |= {(ids[i], 0, e) for e in nfa_match_ends(
            build_nfa(parse(p, 0)), data)}

    def body(pkg):
        got = pkg.scan(pkg.compile_multi(pats, ids=ids), data)
        assert set(got) == want
        return got

    parity(body)


def test_scan_order_and_callback():
    def body(pkg):
        db = pkg.compile_multi([r"a", r"ab"], ids=[1, 2])
        seen = []

        def cb(mid, frm, to, cbflags):
            seen.append((mid, frm, to))
            return 0

        matches = pkg.scan(db, b"abab", cb)
        assert matches == seen
        tos = [t for (_, _, t) in seen]
        assert tos == sorted(tos)
        stop = []

        def cb2(mid, frm, to, cbflags):
            stop.append((mid, to))
            return 1

        stopped = pkg.scan(db, b"abab", cb2)
        assert len(stop) == 1
        return matches, stop, stopped

    parity(body)


def test_singlematch_flag():
    def body(pkg):
        got = pkg.scan(pkg.compile(r"a", pkg.HS_FLAG_SINGLEMATCH), b"aaa")
        assert got == [(0, 0, 1)]
        return got

    parity(body)


def test_quiet_flag():
    def body(pkg):
        got = pkg.scan(pkg.compile(r"a", pkg.HS_FLAG_QUIET), b"aaa")
        assert got == []
        return got

    parity(body)


def test_ext_params_offsets():
    def body(pkg):
        db = pkg.compile_ext_multi(
            [r"a"], ext=[pkg.ExprExt(min_offset=3, max_offset=5)])
        got = pkg.scan(db, b"aaaaaaaa")
        assert got == [(0, 0, 3), (0, 0, 4), (0, 0, 5)]
        return got

    parity(body)


def test_allowempty_required():
    def body(pkg):
        err = raises(pkg, pkg.compile, r"a*")
        assert err == "CompileError"
        db = pkg.compile(r"a*", pkg.HS_FLAG_ALLOWEMPTY)
        got = pkg.scan(db, b"xa")
        assert {t for (_, _, t) in got} == {0, 1, 2}
        return err, got

    parity(body)


def test_literal_api():
    def body(pkg):
        db = pkg.compile_lit_multi([b"a.c", b"xyz"], ids=[5, 6])
        got = pkg.scan(db, b"a.c abc xyz")
        assert set(got) == {(5, 0, 3), (6, 0, 11)}
        db2 = pkg.compile_lit(b"AbC", pkg.HS_FLAG_CASELESS)
        got2 = pkg.scan(db2, b"xxabc")
        assert got2 == [(0, 0, 5)]
        return got, got2

    parity(body)


def test_serialize_roundtrip():
    def body(pkg):
        db = pkg.compile_multi([r"foo\d+", r"^bar", r"baz$"], ids=[1, 2, 3])
        blob = pkg.serialize_database(db)
        db2 = pkg.deserialize_database(blob)
        data = b"foo123 bar\nbaz"
        got = pkg.scan(db2, data)
        assert pkg.scan(db, data) == got
        assert pkg.database_info(db2) == pkg.database_info(db)
        garbage = raises(pkg, pkg.deserialize_database, b"garbage" * 10)
        bad = bytearray(blob)
        bad[25] ^= 0xFF
        corrupt = raises(pkg, pkg.deserialize_database, bytes(bad))
        assert garbage == corrupt == "DbVersionError"
        return got, garbage, corrupt

    parity(body)


def test_scan_batch():
    blocks = [b"abbb", b"", b"cc", b"xaby"]
    wants = [{(eid + 1, 0, t) for (eid, _f, t) in
              oracle_matches([(r"ab+", 0), (r"c", 0)], blk)}
             for blk in blocks]

    def body(pkg):
        res = pkg.scan_batch(pkg.compile_multi([r"ab+", r"c"], ids=[1, 2]),
                             blocks)
        assert len(res) == 4
        for matches, want in zip(res, wants):
            assert set(matches) == want
        return res

    parity(body)


def test_mode_errors():
    def body(pkg):
        db = pkg.compile(r"a", mode=pkg.HS_MODE_STREAM)
        err = raises(pkg, pkg.scan, db, b"a")
        assert err == "DbModeError"
        return err

    parity(body, scans=False)


def test_expression_info():
    def body(pkg):
        out = [pkg.expression_info(p) for p in (r"ab{2,4}c", r"a+",
                                                r"abc$")]
        assert out[0]["min_width"] == 4 and out[0]["max_width"] == 6
        assert out[1]["min_width"] == 1 and out[1]["max_width"] == 0xFFFFFFFF
        assert out[2]["matches_at_eod"]
        return out

    parity(body, scans=False)


def test_scratch_guard():
    def body(pkg):
        db = pkg.compile(r"a")
        s = pkg.alloc_scratch(db)
        s.in_use = True
        err = raises(pkg, pkg.scan, db, b"a", scratch=s)
        assert err == "ScratchInUseError"
        s.in_use = False
        s2 = pkg.clone_scratch(s)
        assert s2.capacity == s.capacity
        return err, s2.capacity, pkg.scan(db, b"aa", scratch=s2)

    parity(body)


def test_capacity_overflow_rescan():
    def body(pkg):
        db = pkg.compile(r"a")
        s = pkg.alloc_scratch(db, capacity=2)
        matches = pkg.scan(db, b"a" * 100, scratch=s)
        assert len(matches) == 100
        return matches

    parity(body)


def test_big_random_differential():
    rng = np.random.default_rng(42)
    data = bytes(rng.integers(97, 101, size=2000, dtype=np.uint8))
    pats = [(r"ab", 0), (r"a[bc]d", 0), (r"(ab|cd)e", 0), (r"ad{2,3}", 0)]
    want = oracle_matches(pats, data)

    def body(pkg):
        db = pkg.compile_multi([p for p, _ in pats], ids=list(range(4)))
        got = pkg.scan(db, data)
        assert set(got) == want
        return got

    parity(body)


def test_scan_batch_threads_match_single():
    rng = np.random.default_rng(4)
    blocks = []
    for k in range(9):
        b = bytearray((32 + rng.integers(0, 95, 4000)).astype(np.uint8)
                      .tobytes())
        b[100:108] = b"attack42"
        if k % 2:
            b[2000:2006] = b"foobar"
        blocks.append(bytes(b))

    def body(pkg):
        db = pkg.compile_multi([r"attack[0-9]+", r"foo(bar|baz)", r"abc.*"],
                               ids=[1, 2, 3])
        single = pkg.scan_batch(db, blocks)
        assert pkg.scan_batch(db, blocks, threads=3) == single
        return single

    parity(body)


def test_scan_streams_threads_match_single():
    rng = np.random.default_rng(5)
    writes = []
    for r in range(4):
        row = []
        for s in range(6):
            b = bytearray((32 + rng.integers(0, 95, 1500)).astype(np.uint8)
                          .tobytes())
            if (r + s) % 3 == 0:
                b[10:18] = b"attack77"
            row.append(bytes(b))
        writes.append(row)

    def body(pkg):
        db1 = pkg.compile_multi([r"attack[0-9]+", r"head[a-z]*tail"],
                                ids=[1, 2], mode=pkg.HS_MODE_STREAM)

        def run(threads):
            sts = [pkg.open_stream(db1) for _ in range(6)]
            out = [pkg.scan_streams(db1, sts, row, threads=threads)
                   for row in writes]
            return out + [[pkg.close_stream(st)] for st in sts]

        one = run(1)
        assert run(3) == one
        return one

    parity(body)


def test_scan_ranges_and_count_dense():
    """The range-record API over a 1 MiB run of one byte: the ranges
    cover every offset once, a scan_count counts them, and expanded
    they give the scan's matches."""
    data = b"ab" + b"x" * (1 << 20) + b"needle" + b"y" * 100
    small = b"zz" + b"x" * 50 + b"q"

    def body(pkg):
        db = pkg.compile_multi([r"x*", "needle"], ids=[1, 2],
                               flags=[pkg.HS_FLAG_ALLOWEMPTY, 0])
        ms, ranges = pkg.scan_block_ranges(db, data)
        n = pkg.scan_count(db, data)
        assert n == (len(data) + 1) + 1
        assert (2, 0, 2 + (1 << 20) + 6) in ms
        assert sum(hi - lo + 1 for (_e, lo, hi) in ranges) == len(data) + 1
        assert all(e == 1 for (e, _lo, _hi) in ranges)
        ms2, rg2 = pkg.scan_block_ranges(db, small)
        expanded = set(ms2) | {
            (e, 0, t) for (e, lo, hi) in rg2 for t in range(lo, hi + 1)}
        assert expanded == set(pkg.scan(db, small))
        db3 = pkg.compile_multi([r"x*"], ids=[9], flags=[
            pkg.HS_FLAG_ALLOWEMPTY | pkg.HS_FLAG_SINGLEMATCH])
        single = pkg.scan_block_ranges(db3, b"xxxx")
        assert single == ([(9, 0, 0)], [])
        return ms, ranges, n, ms2, rg2, single

    parity(body)


def test_scan_batch_threads_ordering_and_mesh_exclusive():
    rng = np.random.default_rng(8)
    blocks = []
    for _ in range(9):
        blob = bytearray((32 + rng.integers(0, 95, 300)).astype(np.uint8)
                         .tobytes())
        blob[10:15] = b"alpha"
        blob[50:54] = b"beta"
        blob[90:94] = b"g77x"
        blocks.append(bytes(blob))

    def body(pkg):
        db = pkg.compile_multi(["alpha", "beta", r"g[0-9]{2}x"],
                               ids=[1, 2, 3])
        ref = pkg.scan_batch(db, blocks)
        assert pkg.scan_batch(db, blocks, threads=3) == ref
        err = raises(pkg, pkg.scan_batch, db, blocks, threads=2,
                     mesh=pkg.make_mesh(2))
        assert err == "InvalidError"
        return ref, err

    parity(body)


def test_lifecycle_compat_entry_points():
    def body(pkg):
        db = pkg.compile_multi(["liftok1", "liftok2"], ids=[1, 2])
        blob = pkg.serialize_database(db)
        assert pkg.hs_serialized_database_size(blob) == len(blob)
        db2 = pkg.hs_deserialize_database_at(blob)
        got = pkg.scan(db2, b"xx liftok1")
        assert got == [(1, 0, 10)]
        pkg.hs_free_database(db2)
        pkg.hs_free_scratch(pkg.alloc_scratch(db))
        pkg.hs_free_compile_error(None)
        sdb = pkg.compile_multi(["szprobe"], ids=[9], mode=pkg.HS_MODE_STREAM)
        sz = pkg.hs_stream_size(sdb)
        assert isinstance(sz, int) and sz > 0
        return got, sz

    parity(body)


def test_reset_and_copy_stream():
    def body(pkg):
        sdb = pkg.compile_multi([r"split\d+end", r"eodtail$"], ids=[1, 2],
                                mode=pkg.HS_MODE_STREAM)
        src = pkg.open_stream(sdb)
        assert pkg.scan_stream(src, b"xx split12") == []
        to = pkg.open_stream(sdb)
        first = pkg.scan_stream(to, b"zz eodtail")
        eod = []
        ms = pkg.hs_reset_and_copy_stream(
            to, src, callback=lambda i, f, t, fl: eod.append((i, t)))
        assert (2, 10) in set(eod) or (2, 10) in {(i, t) for (i, _f, t)
                                                  in ms}
        out = pkg.scan_stream(to, b"34end yy")
        assert any(i == 1 for (i, _f, _t) in out), out
        out_src = pkg.scan_stream(src, b"99end")
        assert any(i == 1 for (i, _f, _t) in out_src), out_src
        other = pkg.compile_multi(["zz"], ids=[3], mode=pkg.HS_MODE_STREAM)
        err = raises(pkg, pkg.hs_reset_and_copy_stream,
                     pkg.open_stream(other), src)
        assert err == "InvalidError"
        return first, eod, ms, out, out_src, err

    parity(body)


# --- tests/test_edges.py -----------------------------------------------------


def test_empty_expression_set_rejected():
    def body(pkg):
        err = raises(pkg, pkg.compile_multi, [])
        assert err == "InvalidError"
        return err

    parity(body, scans=False)


def test_length_mismatch_rejected():
    def body(pkg):
        err = raises(pkg, pkg.compile_multi, [r"a", r"b"], flags=[0],
                     ids=[1, 2])
        assert err == "InvalidError"
        return err

    parity(body, scans=False)


def test_vacuous_requires_allowempty():
    def body(pkg):
        err = raises(pkg, pkg.compile, r"a*")
        assert err == "CompileError"
        ms = pkg.scan(pkg.compile(r"a*", flags=pkg.HS_FLAG_ALLOWEMPTY), b"ba")
        assert (0, 0, 0) in ms and (0, 0, 2) in ms
        return err, ms

    parity(body)


def test_scratch_reentrancy_guard():
    def body(pkg):
        db = pkg.compile(r"abc")
        sc = pkg.alloc_scratch(db)
        inner = []

        def cb(pid, f, t, fl):
            inner.append(raises(pkg, pkg.scan, db, b"abc", scratch=sc))
            return 0

        ms = pkg.scan(db, b"abc", callback=cb, scratch=sc)
        assert inner == ["ScratchInUseError"]
        return ms, inner

    parity(body)


def test_callback_termination_mid_scan():
    def body(pkg):
        seen = []

        def cb(pid, f, t, fl):
            seen.append(t)
            return 1

        ms = pkg.scan(pkg.compile_multi([r"a"], ids=[1]), b"aaa",
                      callback=cb)
        assert seen == [1] and ms == [(1, 0, 1)]
        return seen, ms

    parity(body)


def test_stream_serialize_roundtrip_stream_mode():
    def body(pkg):
        sdb = pkg.compile_multi([r"attack", r"admin[0-9]{1,3}"], ids=[1, 2],
                                mode=pkg.HS_MODE_STREAM)
        sdb2 = pkg.deserialize_database(pkg.serialize_database(sdb))
        st = pkg.open_stream(sdb2)
        ms = pkg.scan_stream(st, b"atta")
        ms += pkg.scan_stream(st, b"ck admin42")
        ms += pkg.close_stream(st)
        assert (1, 0, 6) in ms and (2, 0, 13) in ms and (2, 0, 14) in ms
        return ms

    parity(body)


def test_compress_mid_factor():
    def body(pkg):
        sdb = pkg.compile(r"attack", mode=pkg.HS_MODE_STREAM)
        st = pkg.open_stream(sdb)
        pkg.scan_stream(st, b"xx atta")
        buf = pkg.compress_stream(st)
        st2 = pkg.expand_stream(sdb, buf)
        ms = pkg.scan_stream(st2, b"ck") + pkg.close_stream(st2)
        assert ms == [(0, 0, 9)]
        return ms, buf

    parity(body)


def test_trailing_boundary_across_writes():
    def body(pkg):
        sdb = pkg.compile(r"\bword\b", mode=pkg.HS_MODE_STREAM)
        st = pkg.open_stream(sdb)
        out = [pkg.scan_stream(st, b"word"), pkg.scan_stream(st, b"!x"),
               pkg.close_stream(st)]
        assert out[:2] == [[], [(0, 0, 4)]]
        st = pkg.open_stream(sdb)
        out += [pkg.scan_stream(st, b"word"), pkg.close_stream(st)]
        assert out[3:] == [[], [(0, 0, 4)]]
        st = pkg.open_stream(sdb)
        out += [pkg.scan_stream(st, b"word"), pkg.scan_stream(st, b"s"),
                pkg.close_stream(st)]
        assert out[5:] == [[], [], []]
        return out

    parity(body)


def test_no_duplicate_report_at_write_boundary():
    def body(pkg):
        st = pkg.open_stream(pkg.compile(r"word", mode=pkg.HS_MODE_STREAM))
        out = [pkg.scan_stream(st, b"xword"), pkg.scan_stream(st, b" more"),
               pkg.close_stream(st)]
        assert out[:2] == [[(0, 0, 5)], []]
        return out

    parity(body)


def test_binary_patterns_and_data():
    def body(pkg):
        db = pkg.compile_multi([rb"\x00\x01\x02", rb"\xff+z"], ids=[1, 2])
        ms = pkg.scan(db, b"\x00\x01\x02 \xff\xff\xffz")
        got = {(m, t) for (m, _f, t) in ms}
        assert (1, 3) in got and (2, 8) in got
        return ms

    parity(body)


def test_huge_bounded_repeat_rejected():
    def body(pkg):
        err = raises(pkg, pkg.compile, r"a{40000}")
        assert err == "CompileError"
        return err

    parity(body, scans=False)


def test_deep_nesting():
    def body(pkg):
        got = pkg.scan(pkg.compile("(((((((((a)))))))))b"), b"zab")
        assert got == [(0, 0, 3)]
        return got

    parity(body)


def test_expression_info_surface():
    def body(pkg):
        info = pkg.expression_info(r"abc[0-9]{2}")
        assert info["min_width"] == 5 and info["max_width"] == 5
        info2 = pkg.expression_info(r"foo$")
        assert info2["matches_at_eod"]
        return info, info2

    parity(body, scans=False)


def test_bad_patterns_error_parity():
    """tests/test_edges.py's compile-must-fail battery (the reference's
    unit/hyperscan/bad_patterns error classes) and its good siblings:
    each raises the same error class in both packages, or compiles in
    both."""

    def body(pkg):
        P = pkg.HS_FLAG_PREFILTER
        bad = [
            ("\\c\u7a7a", 0, None), (r"\cÀ", 0, None), (r"[\cÀ]", 0, None),
            (r"\b+", 0, None), (r"\B?", 0, None), (r"\b{0,6}", 0, None),
            (r"foo(?m)?bar", 0, None),
            (r"[.ch.]", 0, None), (r"[=ch=]", 0, None),
            (r"[:digit:]", 0, None), (r"[[.ch.]]", 0, None),
            (r"[[:bogus:]]", 0, None), (r"[A-[:digit:]]", 0, None),
            (r"^\B\Bfoo", 0, None), (r"[^\x00-\xff]", 0, None),
            (r"\b\Bfoo", 0, None),
            (r"(?P<dup>a)(?P<dup>b)", 0, None), (r"(?<1x>a)", 0, None),
            (r"(abc)\2", P, None), (r"abc(?(1)d|e)", P, None),
            (r"abc((d)?(?(R)b))+", P, None),
            (r"^foo", 0, dict(min_offset=5)),
            (r"foobar", 0, dict(min_length=20)),
            (r"foobar", 0, dict(max_offset=3)),
            (r"foo", 0, dict(min_offset=10, max_offset=9)),
            (r"\Bd\B", pkg.HS_FLAG_CASELESS,
             dict(min_length=2, min_offset=4, max_offset=54)),
            (r"\B", pkg.HS_FLAG_DOTALL | pkg.HS_FLAG_ALLOWEMPTY,
             dict(min_length=1)),
            (r"(f|d|(\b)|i|a\Z)",
             pkg.HS_FLAG_MULTILINE | pkg.HS_FLAG_ALLOWEMPTY,
             dict(min_length=2, min_offset=9, max_offset=14)),
            (r"(f|e|d{19,}|h\Z|^j|\Aa)",
             pkg.HS_FLAG_DOTALL | pkg.HS_FLAG_MULTILINE
             | pkg.HS_FLAG_CASELESS,
             dict(min_length=7, min_offset=8, max_offset=18)),
            (r"(i{13,}|i\Z)", pkg.HS_FLAG_DOTALL,
             dict(min_length=3, max_offset=5)),
            (r"abc\b", 0, dict(edit_distance=1)),
            (r"abc", pkg.HS_FLAG_UTF8, dict(edit_distance=1)),
            (r"(*UTF8)abc", 0, dict(edit_distance=1)),
            (r"\p{greek}", pkg.HS_FLAG_UTF8, None),
        ]
        good = [
            (r"(\b)+", pkg.HS_FLAG_ALLOWEMPTY, None),
            (r"[[:alpha:]]", 0, None), (r"[a.b]", 0, None),
            (r"[:a]", 0, None), (r"(abc)\1", P, None),
            (r"(?'g'a)(?('g')b|c)", P, None),
            (r"^abcq", 0, dict(edit_distance=1)),
            (r"\p{Greek}", pkg.HS_FLAG_UTF8, None),
            (r"(i{13,}|i\Z)", pkg.HS_FLAG_DOTALL,
             dict(min_length=3, max_offset=20)),
            (r"\Bd\B", 0, dict(max_offset=2)),
            (r"foo.*bar", 0, dict(min_length=100)),
        ]

        def build(pat, fl, ext):
            if ext:
                return pkg.compile_ext_multi([pat], flags=[fl], ids=[0],
                                             ext=[pkg.ExprExt(**ext)])
            return pkg.compile(pat, flags=fl)

        errs = [raises(pkg, build, *case) for case in bad]
        assert "ok" not in errs, [c for c, e in zip(bad, errs) if e == "ok"]
        invalid = raises(pkg, pkg.compile, b"\xff\xfe",
                         flags=pkg.HS_FLAG_UTF8)
        assert invalid != "ok"
        goods = [raises(pkg, build, *case) for case in good]
        assert set(goods) == {"ok"}, goods
        db = pkg.compile_ext_multi([r"\Bd\B"], flags=[0], ids=[7],
                                   ext=[pkg.ExprExt(max_offset=2)])
        ada, adda = pkg.scan(db, b"ada"), pkg.scan(db, b"adda")
        assert ada == [(7, 0, 2)] and adda == [(7, 0, 2)]
        return errs, invalid, goods, ada, adda

    parity(body)
