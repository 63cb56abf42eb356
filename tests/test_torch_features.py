"""Logical combinations, extended parameters, approximate matching, the
anchored families and the small-write threshold through the port
against the JAX package: every test of tests/test_combination.py,
tests/test_fuzzy.py, tests/test_anchored.py and tests/test_smallwrite.py,
as a body run by torch_parity.parity on the reference's host route and
on both of the port's routes (its host route, and the device branch
forced) on the CPU; plus the serialized databases of these features
carried across the two packages both ways. Each body keeps the reference
test's own checks (Python `re`, the AST oracle, the edit and Hamming
oracles) and returns what it saw; the port's must equal the reference's
exactly."""

import re

import numpy as np
import pytest

import hyperscan_tpu as hs
import hyperscan_tpu_torch as ht
import torch_ref_native  # noqa: F401 (the reference's native build, locked)
from hyperscan_tpu.compiler.parser import parse
from hyperscan_tpu.utils.oracle import ast_match_ends
from hyperscan_tpu_torch.runtime import smallwrite
from torch_parity import DEVICE, HOST, REF, Uploads, parity, raises

from test_anchored import FAMILY
from test_fuzzy import CORPORA as FUZZY_CORPORA
from test_fuzzy import _edit_oracle, _hamming_oracle

# --- tests/test_combination.py -----------------------------------------------


def _combo_db(pkg, combo, mode=None, sub_flags=0):
    return pkg.compile_multi(
        [r"abc", r"def", r"xyz", combo],
        flags=[sub_flags, sub_flags, sub_flags, pkg.HS_FLAG_COMBINATION],
        ids=[101, 102, 103, 900], mode=mode)


def _fired(ms) -> bool:
    return any(m[0] == 900 for m in ms)


def test_and_combination():
    def body(pkg):
        db = _combo_db(pkg, "101&102")
        only = pkg.scan(db, b"abc only")
        assert not _fired(only)
        ms = pkg.scan(db, b"abc then def")
        assert (900, 0, 12) in ms and (900, 0, 3) not in ms
        return only, ms

    parity(body)


def test_or_combination():
    def body(pkg):
        ms = pkg.scan(_combo_db(pkg, "101|103"), b"xyz at start, abc later")
        assert (900, 0, 3) in ms and (900, 0, 17) in ms
        return ms

    parity(body)


def test_not_combination():
    def body(pkg):
        db = _combo_db(pkg, "101&!102")
        ms = pkg.scan(db, b"abc and xyz")
        assert (900, 0, 3) in ms
        ms2 = pkg.scan(db, b"def abc")
        assert not _fired(ms2)
        return ms, ms2

    parity(body)


def test_same_offset_negation():
    def body(pkg):
        db = pkg.compile_multi([r"abc", r"babc", r"101&!102"],
                               flags=[0, 0, pkg.HS_FLAG_COMBINATION],
                               ids=[101, 102, 900])
        ms = pkg.scan(db, b"zbabc")
        assert not _fired(ms)
        ms2 = pkg.scan(db, b"aabc")
        assert _fired(ms2)
        return ms, ms2

    parity(body)


def test_purely_negative_reports_at_eod():
    def body(pkg):
        db = _combo_db(pkg, "!101")
        ms = pkg.scan(db, b"nothing here")
        assert (900, 0, 12) in ms
        ms2 = pkg.scan(db, b"abc here")
        assert not _fired(ms2)
        return ms, ms2

    parity(body)


def test_quiet_subexpressions():
    def body(pkg):
        ms = pkg.scan(_combo_db(pkg, "101&102", sub_flags=pkg.HS_FLAG_QUIET),
                      b"abc then def")
        assert ms == [(900, 0, 12)]
        return ms

    parity(body)


def test_combination_streaming():
    def body(pkg):
        db = _combo_db(pkg, "101&102", mode=pkg.HS_MODE_STREAM)
        st = pkg.open_stream(db)
        ms = pkg.scan_stream(st, b"abc...")
        assert not _fired(ms)
        ms2 = pkg.scan_stream(st, b"def")
        assert _fired(ms2)
        return ms, ms2, pkg.close_stream(st)

    parity(body)


def test_purely_negative_streaming_eod():
    def body(pkg):
        st = pkg.open_stream(_combo_db(pkg, "!103", mode=pkg.HS_MODE_STREAM))
        ms = pkg.scan_stream(st, b"abcdef")
        assert not _fired(ms)
        end = pkg.close_stream(st)
        assert (900, 0, 6) in end
        return ms, end

    parity(body)


def test_unknown_subexpression_rejected():
    def body(pkg):
        err = raises(pkg, _combo_db, pkg, "101&777")
        assert err == "CompileError"
        return err

    parity(body, scans=False)


@pytest.mark.parametrize("bad", ["", "101&", "(101", "101 102", "&101",
                                 "101!102"])
def test_bad_syntax_rejected(bad):
    def body(pkg):
        err = raises(pkg, _combo_db, pkg, bad)
        assert err == "CompileError"
        return err

    parity(body, scans=False)


def test_combination_serialization_roundtrip():
    def body(pkg):
        db = _combo_db(pkg, "(101|102)&!103")
        db2 = pkg.deserialize_database(pkg.serialize_database(db))
        got = pkg.scan(db2, b"abc stuff")
        assert got == pkg.scan(db, b"abc stuff")
        return got

    parity(body)


# --- tests/test_fuzzy.py -----------------------------------------------------


def _ends(ms):
    return {t for (_i, _f, t) in ms}


@pytest.mark.parametrize("k", [1, 2])
def test_edit_distance_literal(k):
    wants = [_edit_oracle([b"attack"], data, k) for data in FUZZY_CORPORA]

    def body(pkg):
        db = pkg.compile_ext_multi(
            [r"attack"], ids=[1], ext=[pkg.ExprExt(edit_distance=k)],
            flags=[pkg.HS_FLAG_ALLOWEMPTY])
        out = []
        for data, want in zip(FUZZY_CORPORA, wants):
            out.append(pkg.scan(db, data))
            assert _ends(out[-1]) == want, (k, data)
        return out

    parity(body)


@pytest.mark.parametrize("k", [1, 2])
def test_hamming_distance_literal(k):
    wants = [_hamming_oracle([b"abcd"], data, k) for data in FUZZY_CORPORA]

    def body(pkg):
        db = pkg.compile_ext_multi(
            [r"abcd"], ids=[1], ext=[pkg.ExprExt(hamming_distance=k)])
        out = []
        for data, want in zip(FUZZY_CORPORA, wants):
            out.append(pkg.scan(db, data))
            assert _ends(out[-1]) == want, (k, data)
        return out

    parity(body)


def test_edit_distance_alternation():
    words = [b"foox", b"barby"]
    corpora = [b"fox barb yfooxy", b"baarby foo"]
    wants = [_edit_oracle(words, data, 1) for data in corpora]

    def body(pkg):
        db = pkg.compile_ext_multi([r"foox|barby"], ids=[7],
                                   ext=[pkg.ExprExt(edit_distance=1)])
        out = [pkg.scan(db, data) for data in corpora]
        assert [_ends(ms) for ms in out] == wants
        return out

    parity(body)


def test_edit_distance_anchored():
    def body(pkg):
        db = pkg.compile_ext_multi([r"^abcq"], ids=[3],
                                   ext=[pkg.ExprExt(edit_distance=1)])
        got, got2 = pkg.scan(db, b"xabcq"), pkg.scan(db, b"zzabcq")
        assert 5 in _ends(got) and not got2
        return got, got2

    parity(body)


def test_fuzzy_class_pattern():
    words = [bytes([97, 98, d, 100]) for d in range(48, 58)]
    data = b"ab5d abxd abc5d a5d"
    want = _edit_oracle(words, data, 1)

    def body(pkg):
        got = pkg.scan(pkg.compile_ext_multi(
            [r"ab[0-9]d"], ids=[4], ext=[pkg.ExprExt(edit_distance=1)]), data)
        assert _ends(got) == want
        return got

    parity(body)


def test_both_distances_rejected():
    def body(pkg):
        err = raises(pkg, pkg.compile_ext_multi, [r"abc"], ids=[1], ext=[
            pkg.ExprExt(edit_distance=1, hamming_distance=1)])
        assert err == "CompileError"
        return err

    parity(body, scans=False)


def test_fuzzy_streaming():
    want = _edit_oracle([b"attack"], b"zz attck zz", 1)

    def body(pkg):
        db = pkg.compile_ext_multi(
            [r"attack"], ids=[1], ext=[pkg.ExprExt(edit_distance=1)],
            mode=pkg.HS_MODE_STREAM, flags=[pkg.HS_FLAG_ALLOWEMPTY])
        st = pkg.open_stream(db)
        ms = pkg.scan_stream(st, b"zz att")
        ms += pkg.scan_stream(st, b"ck zz")
        ms += pkg.close_stream(st)
        assert _ends(ms) == want
        return ms

    parity(body)


def test_min_length_filters_short_matches():
    def body(pkg):
        got = pkg.scan(pkg.compile_ext_multi(
            [r"admin[0-9]{1,3}"], ids=[1], ext=[pkg.ExprExt(min_length=8)]),
            b"admin1 admin22 admin333")
        assert _ends(got) == {23}
        return got

    parity(body)


def test_min_length_noop_when_covered():
    def body(pkg):
        got = pkg.scan(pkg.compile_ext_multi(
            [r"attack"], ids=[1], ext=[pkg.ExprExt(min_length=3)]), b"attack")
        assert [t for (_i, _f, t) in got] == [6]
        return got

    parity(body)


def test_prefilter_superset():
    def body(pkg):
        got = pkg.scan(pkg.compile(r"foo(?=bar)", flags=pkg.HS_FLAG_PREFILTER),
                       b"foobar fooqqq")
        assert _ends(got) == {3, 10}
        return got

    parity(body)


# --- tests/test_anchored.py --------------------------------------------------


def _truth(pats, ids, data: bytes):
    out = set()
    for p, i in zip(pats, ids):
        out |= {(i, e) for e in ast_match_ends(parse(p), data)}
    return out


def _got(ms):
    return {(i, to) for (i, _f, to) in ms}


def _lit_shape(db):
    lit = db.lit
    return (len(lit.anchored_refs), len(lit.sfx_validators),
            len(lit.validators))


def test_family_shares_one_suffix_validator():
    data = (b"xx attack734z yy payload12399z zz evilstring55z "
            b"attack7z gadget123456z gadget12345z oo attack71234z")
    want = _truth(FAMILY, [1, 2, 3, 4], data)

    def body(pkg):
        db = pkg.compile_multi(FAMILY, ids=[1, 2, 3, 4])
        assert _lit_shape(db) == (len(FAMILY), 1, 0)
        ms = pkg.scan(db, data)
        assert _got(ms) == want
        return _lit_shape(db), ms

    parity(body)


def test_anchored_matches_overlap_and_bounds():
    pats = [r"abend[0-9]{1,3}x", r"bend[0-9]{2}xy"]
    data = b"abend12x abend123xy bend12xy zabend1x abend1234x bend12xz"
    want = _truth(pats, [7, 8], data)

    def body(pkg):
        db = pkg.compile_multi(pats, ids=[7, 8])
        assert len(db.lit.anchored_refs) >= 1
        ms = pkg.scan(db, data)
        assert _got(ms) == want
        return _lit_shape(db), ms

    parity(body)


def test_anchored_caseless_head():
    data = b"admin1q ADMIN22q AdMin333q admin4q"
    want = {(3, m.end()) for m in re.finditer(rb"admin[0-9]{1,2}q", data,
                                              re.I)}

    def body(pkg):
        ms = pkg.scan(pkg.compile_multi([r"AdMiN[0-9]{1,2}q"], ids=[3],
                                        flags=[pkg.HS_FLAG_CASELESS]), data)
        assert _got(ms) == want
        return ms

    parity(body)


def test_anchored_assertion_suffix_falls_back():
    data = b"word! word words"
    want = _truth([r"word\b[!]?"], [1], data)

    def body(pkg):
        db = pkg.compile_multi([r"word\b[!]?"], ids=[1], flags=[0])
        assert len(db.lit.anchored_refs) == 0
        ms = pkg.scan(db, data)
        assert _got(ms) == want
        return _lit_shape(db), ms

    parity(body)


def test_anchored_serialization_roundtrip():
    data = b"attack788z payload1234z evilstring00z gadget99z"
    want = _truth(FAMILY, [1, 2, 3, 4], data)

    def body(pkg):
        db = pkg.compile_multi(FAMILY, ids=[1, 2, 3, 4])
        db2 = pkg.deserialize_database(pkg.serialize_database(db))
        assert _lit_shape(db2)[:2] == (len(FAMILY), 1)
        ms = pkg.scan(db2, data)
        assert ms == pkg.scan(db, data) and _got(ms) == want
        return _lit_shape(db2), ms

    parity(body)


def test_anchored_streaming_across_writes():
    data = b"xx attack734z yy payload12399z zz evilstring55z gadget12z"
    want = _truth(FAMILY, [1, 2, 3, 4], data)

    def body(pkg):
        db = pkg.compile_multi(FAMILY, ids=[1, 2, 3, 4],
                               mode=pkg.HS_MODE_STREAM)
        out = []
        for cut in range(1, len(data), 3):
            st = pkg.open_stream(db)
            seen = []
            cb = lambda i, f, t, fl: seen.append((i, f, t))  # noqa: E731
            pkg.scan_stream(st, data[:cut], cb)
            pkg.scan_stream(st, data[cut:], cb)
            pkg.close_stream(st, cb)
            assert _got(seen) == want, f"cut={cut}"
            out.append(seen)
        return out

    parity(body)


def test_anchored_stream_state_roundtrip():
    data = b"qq payload123456z attack799z"
    want = _truth(FAMILY, [1, 2, 3, 4], data)

    def body(pkg):
        db = pkg.compile_multi(FAMILY, ids=[1, 2, 3, 4],
                               mode=pkg.HS_MODE_STREAM)
        st = pkg.open_stream(db)
        seen = []
        cb = lambda i, f, t, fl: seen.append((i, f, t))  # noqa: E731
        pkg.scan_stream(st, data[:11], cb)
        blob = pkg.compress_stream(st)
        st2 = pkg.expand_stream(db, blob)
        pkg.scan_stream(st2, data[11:], cb)
        pkg.close_stream(st2, cb)
        assert _got(seen) == want
        return seen, blob

    parity(body)


def test_anchored_singlematch_and_quiet():
    def body(pkg):
        ms = pkg.scan(pkg.compile_multi([r"hit[0-9]{1,2}e"], ids=[5],
                                        flags=[pkg.HS_FLAG_SINGLEMATCH]),
                      b"hit1e hit22e hit3e")
        assert len(ms) == 1 and ms[0][0] == 5
        return ms

    parity(body)


def test_anchored_pure_head_empty_suffix():
    pats = [r"foo[ab]barbaz[01]"]
    data = b"fooabarbaz0 foobbarbaz1 foocbarbaz0 fooabarbaz2"
    want = _truth(pats, [9], data)

    def body(pkg):
        ms = pkg.scan(pkg.compile_multi(pats, ids=[9]), data)
        assert _got(ms) == want
        return ms

    parity(body)


def test_head_alt_expansion_routes_anchored():
    pats = [r"x12(GET|POST|PUT) /[a-z]{1,20}", r"v4\.(exe|dll|bat)"]
    data = (b"x12GET /abc x12POST /longerpath x12PUT / x12HEAD /zz "
            b"v4.exe v4.dll v4.bat v4.txt x12GET /" + b"q" * 30)
    want = _truth(pats, [1, 2], data)

    def body(pkg):
        db = pkg.compile_multi(pats, ids=[1, 2])
        assert _lit_shape(db) == (3, 1, 0)
        ms = pkg.scan(db, data)
        assert _got(ms) == want
        return ms

    parity(body)


def test_head_alt_expansion_mixed_failure_falls_back():
    pats = [r"yy12(GET|P[ao]ST) /[a-z]{1,3}"]
    data = b"yy12GET /ab yy12PaST /xyz yy12PoST /q yy12PeST /q"
    want = _truth(pats, [4], data)

    def body(pkg):
        ms = pkg.scan(pkg.compile_multi(pats, ids=[4]), data)
        assert _got(ms) == want
        return ms

    parity(body)


def _vocabulary():
    rng = np.random.default_rng(7)
    sfx = [r"[0-9]{2,4}z", r"[a-f]{3}q", r"=[0-9a-f]{2}", r"[xy]{1,2}k"]
    pats, ids = [], []
    for i in range(200):
        word = "".join(chr(ord("a") + int(c))
                       for c in rng.integers(0, 26, size=9))
        pats.append(word + sfx[i % 4])
        ids.append(i + 1)
    probe = bytearray((97 + rng.integers(0, 26, size=4096)).astype(np.uint8))
    plant = []
    for k in (3, 77, 141):
        s = pats[k].replace(r"[0-9]{2,4}z", "73z") \
            .replace(r"[a-f]{3}q", "abcq") \
            .replace(r"=[0-9a-f]{2}", "=0f") \
            .replace(r"[xy]{1,2}k", "xk").encode()
        off = 200 + 300 * k % 3000
        probe[off:off + len(s)] = s
        plant.append((ids[k], off + len(s)))
    return pats, ids, bytes(probe), plant


def test_vocabulary_scale_validator_reduction():
    pats, ids, data, plant = _vocabulary()
    want = _truth(pats, ids, data)

    def body(pkg):
        db = pkg.compile_multi(pats, ids=ids)
        shape = _lit_shape(db)
        assert shape[0] == 200 and shape[1] <= 4 and shape[2] == 0
        ms = pkg.scan(db, data)
        assert set(plant) <= _got(ms) and _got(ms) == want
        return shape, ms

    parity(body)


def test_bounded_repeat_tail_rejects_nondigit_run():
    def body(pkg):
        db = pkg.compile_multi([r"payload1[0-9]{2,4}z"], ids=[1])
        out = [pkg.scan(db, b"xx payload16y99z! yy"),
               pkg.scan(db, b"xx payload1699z! yy"),
               pkg.scan(db, b"payload16999z")]
        assert out[0] == [] and _got(out[1]) == {(1, 15)} \
            and _got(out[2]) == {(1, 13)}
        db2 = pkg.compile_multi([r"[ab]ayload1[0-9]{2,4}z"], ids=[3])
        assert len(getattr(db2.lit, "anchored_refs", [])) == 0
        out += [pkg.scan(db2, b"xx aayload16y99z! yy"),
                pkg.scan(db2, b"xx bayload1699z! yy")]
        assert out[3] == [] and _got(out[4]) == {(3, 15)}
        return out

    parity(body)


# --- tests/test_smallwrite.py ------------------------------------------------
#
# The port's module constant `runtime.smallwrite.HOST_SCAN_LIMIT` is the
# limit a database takes where none is given; a compiled database keeps
# its own (`host_scan_limit`), which decides its route. So the host-route
# database here is compiled after the constant is raised, from it.

SW_PATS = [r"attack[0-9]{2}", r"foo[a-z]+bar", r"shellz"]


def _sw_corpus(n):
    rng = np.random.default_rng(3)
    data = rng.integers(97, 123, size=n, dtype=np.uint8).tobytes()
    return data[: n // 2] + b"attack42 foozzzbar shellz" + data[n // 2:]


def _sw_db(pats, ids, mode=ht.HS_MODE_BLOCK):
    return ht.database.compile_patterns(
        pats, None, ids, mode,
        grey=ht.Grey(host_scan_limit=smallwrite.HOST_SCAN_LIMIT))


def test_device_equals_host(monkeypatch):
    blob = _sw_corpus(smallwrite.HOST_SCAN_LIMIT * 2)
    want = REF.scan(REF.compile_multi(SW_PATS, ids=[1, 2, 3]), blob)
    dev_db = _sw_db(SW_PATS, [1, 2, 3])
    with Uploads() as up:
        big = HOST.scan(dev_db, blob)
    assert up.n > 0, "over the limit, the scan did not take the device branch"
    monkeypatch.setattr(smallwrite, "HOST_SCAN_LIMIT", 1 << 62)
    with Uploads() as up:
        host = HOST.scan(_sw_db(SW_PATS, [1, 2, 3]), blob)
    assert up.n == 0
    assert big == host == want
    assert {m[0] for m in big} == {1, 2, 3}


def test_stream_device_equals_host(monkeypatch):
    """tests/test_smallwrite.py's two writes of half the corpus each stay
    under the limit (it holds a write, not the stream); a second split,
    whose first write is past the limit, takes the device branch."""
    blob = _sw_corpus(smallwrite.HOST_SCAN_LIMIT + 4096)

    def run(pkg, db):
        out = []
        for cut in (len(blob) // 2, len(blob) - 4096):
            st = pkg.open_stream(db)
            ms = pkg.scan_stream(st, blob[:cut])
            ms += pkg.scan_stream(st, blob[cut:])
            out.append(ms + pkg.close_stream(st))
        return out

    want = run(REF, REF.compile_multi(SW_PATS[:2], ids=[1, 2],
                                      mode=hs.HS_MODE_STREAM))
    with Uploads() as up:
        dev = run(HOST, _sw_db(SW_PATS[:2], [1, 2], ht.HS_MODE_STREAM))
    assert up.n > 0
    monkeypatch.setattr(smallwrite, "HOST_SCAN_LIMIT", 1 << 62)
    with Uploads() as up:
        hostms = run(HOST, _sw_db(SW_PATS[:2], [1, 2], ht.HS_MODE_STREAM))
    assert up.n == 0
    assert dev == hostms == want and all(any(m[0] == 1 for m in ms)
                                         for ms in dev)


# --- serialized feature databases across the two packages ---------------------

U = hs.HS_FLAG_UTF8
XDB = {
    "combination": ([r"abc", r"def", r"xyz", "(101|102)&!103", "!102"],
                    [hs.HS_FLAG_QUIET, 0, 0, hs.HS_FLAG_COMBINATION,
                     hs.HS_FLAG_COMBINATION], [101, 102, 103, 900, 901],
                    None, [b"abc stuff", b"xyz abc def", b"nothing", b""]),
    "fuzzy": ([r"attack", r"abcd", r"admin[0-9]{1,3}"], [0, 0, 0],
              [1, 2, 3], [dict(edit_distance=1), dict(hamming_distance=1),
                          dict(min_length=8, max_offset=40)],
              [b"attck atack attackk", b"zz abxd abd admin333 admin1",
               b"axtack " * 8]),
    "utf8": ([r"h.llo", r"[α-ω]+x", r"gr[äa]y"], [U, U, U], [1, 2, 3], None,
             ["hällo hxllo h€llo αβγx gräy gray".encode(), b"",
              "δx xx ωx".encode()]),
    "anchored": (FAMILY + [r"x12(GET|POST|PUT) /[a-z]{1,20}"],
                 [0] * 5, [1, 2, 3, 4, 5], None,
                 [b"xx attack734z yy payload12399z zz evilstring55z "
                  b"gadget12z x12POST /abc", b"attack7z"]),
}


@pytest.mark.parametrize("kind", sorted(XDB))
def test_serialized_across_packages(kind):
    """A database serialized by either package loads in the other
    (`load_reference` here, `deserialize_database` there) and scans the
    same, block and stream mode, on each of the port's routes."""
    pats, flags, ids, ext, corpora = XDB[kind]
    for mode in (hs.HS_MODE_BLOCK, hs.HS_MODE_STREAM):
        ref_db = REF.compile_patterns(
            pats, flags, ids, mode,
            ext=ext and [hs.ExprExt(**e) for e in ext])
        port_db = HOST.compile_patterns(
            pats, flags, ids, mode,
            ext=ext and [ht.ExprExt(**e) for e in ext])
        from_ref = ht.load_reference(hs.serialize_database(ref_db))
        from_port = hs.deserialize_database(ht.serialize_database(port_db))
        from_port.host_scan_limit = REF.limit
        again = ht.deserialize_database(ht.serialize_database(from_ref))
        for data in corpora:
            if mode == hs.HS_MODE_BLOCK:
                want = REF.scan(ref_db, data)
                assert REF.scan(from_port, data) == want
            else:
                want = _one_stream(REF, ref_db, data)
                assert _one_stream(REF, from_port, data) == want
            for route in (HOST, DEVICE):
                for db in (from_ref, port_db, again):
                    db.host_scan_limit = route.limit
                    got = (route.scan(db, data) if mode == hs.HS_MODE_BLOCK
                           else _one_stream(route, db, data))
                    assert got == want, (kind, mode, route, data)


def _one_stream(pkg, db, data):
    st = pkg.open_stream(db)
    half = len(data) // 2
    return (pkg.scan_stream(st, data[:half]) + pkg.scan_stream(st, data[half:])
            + pkg.close_stream(st))
