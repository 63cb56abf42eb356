"""The bit-NFA engine, the internal table builders and the native host
runtime through the port against the JAX package: every test of
tests/test_bitnfa.py, tests/test_internal.py and tests/test_native.py.

Scans run as bodies of torch_parity.parity (the reference's host route,
and both of the port's routes on the CPU: its host route and the device
branch forced), equal to the reference's exactly. The port's own
internals (the graph passes, the DFA kernel's learned capacity, the
extraction, the native library) are held against the reference's and
the reference test's oracles. Two of tests/test_internal.py's cases test
JAX internals and take their port counterparts here: the extraction's
plain version against torch.nonzero, and a dropped database releasing
the tables the device branch hung on it."""

import gc
import os
import weakref

import numpy as np
import pytest
import torch

import hyperscan_tpu as hs
import hyperscan_tpu_torch as ht
import torch_ref_native  # noqa: F401 (the reference's native build, locked)
from hyperscan_tpu.compiler import glushkov as ref_glushkov
from hyperscan_tpu.compiler import parser as ref_parser
from hyperscan_tpu.utils import oracle as ref_oracle
from hyperscan_tpu_torch import database as port_database
from hyperscan_tpu_torch import native
from hyperscan_tpu_torch.compiler.bitnfa import (bitnfa_scan_reference,
                                                 build_bitnfa)
from hyperscan_tpu_torch.compiler.glushkov import build_nfa, reduce_graph
from hyperscan_tpu_torch.compiler.parser import parse
from hyperscan_tpu_torch.ops import dfa_kernel
from hyperscan_tpu_torch.runtime.smallwrite import teddy_filter_host
from hyperscan_tpu_torch.utils.oracle import ast_match_ends, nfa_match_ends
from torch_parity import DEVICE, HOST, REF, Uploads, parity

BLOWUPS = [r".*a.{18}b", r".*[ab]c.{12}[de]", r"(x|y).*q.{9}z"]


def _rand(rng, alphabet: bytes, n: int) -> bytes:
    return bytes(rng.choice(np.frombuffer(alphabet, np.uint8), size=n))


def _ends(ms):
    return {t for (_i, _f, t) in ms}


def _bitnfa_ends(pat, data, flags=0):
    """The port's bit-NFA reference scan of one pattern (the oracle of
    tests/test_bitnfa.py's device cases; the AST oracle is quadratic on
    a leading .*)."""
    nfa = build_bitnfa([reduce_graph(build_nfa(parse(pat, flags)))], [0])
    return {t for (_e, t) in bitnfa_scan_reference(nfa, data)}


def _nfa_engines(pkg, db):
    return [e for e in db.engines if isinstance(e, pkg.database.NfaEngine)]


# --- tests/test_bitnfa.py ----------------------------------------------------


def test_blowup_pattern_compiles_to_bitnfa():
    rng = np.random.default_rng(11)
    data = _rand(rng, b"aabxy", 3000)
    want = _bitnfa_ends(r".*a.{18}b", data)

    def body(pkg):
        db = pkg.compile_multi([r".*a.{18}b"])
        (eng,) = _nfa_engines(pkg, db)
        assert eng.acyclic and eng.max_depth == 20
        ms = pkg.scan(db, data)
        assert _ends(ms) == want
        return eng.acyclic, eng.max_depth, ms

    parity(body)


@pytest.mark.parametrize("pat", [r".*a.{5}b", r"a*b", r"(a|.)*x", r".*foo",
                                 r"[^x]*foo"])
def test_reduce_graph_preserves_match_ends(pat):
    rng = np.random.default_rng(7)
    node = parse(pat, 0)
    r = reduce_graph(build_nfa(node))
    rr = ref_glushkov.reduce_graph(ref_glushkov.build_nfa(
        ref_parser.parse(pat, 0)))
    assert r.num_positions == rr.num_positions
    datas = [_rand(rng, b"abfox\n ", int(rng.integers(0, 40)))
             for _ in range(25)]
    for d in datas:
        got = {t for (_e, t) in bitnfa_scan_reference(build_bitnfa([r], [0]),
                                                       d)}
        assert got == ast_match_ends(node, d), (pat, d)

    def body(pkg):
        db = pkg.compile_multi([pat], flags=[pkg.HS_FLAG_ALLOWEMPTY])
        out = [pkg.scan(db, d) for d in datas]
        assert [_ends(ms) for ms in out] == [
            ast_match_ends(node, d) for d in datas]
        return out

    parity(body)


@pytest.mark.parametrize("pat", BLOWUPS)
def test_bitnfa_host_path_vs_oracle(pat):
    rng = np.random.default_rng(3)
    node = parse(pat, 0)
    datas = [_rand(rng, b"abcdexyzq", int(rng.integers(0, 300)))
             for _ in range(15)]

    def body(pkg):
        db = pkg.compile_multi([pat])
        out = [pkg.scan(db, d) for d in datas]
        for d, ms in zip(datas, out):
            assert _ends(ms) == ast_match_ends(node, d), (pat, d[:60])
        return out

    parity(body)


def test_bitnfa_device_path_vs_reference():
    rng = np.random.default_rng(5)
    pat = r".*a.{18}b"
    d = _rand(rng, b"aabxy", 150_000)
    want = _bitnfa_ends(pat, d)
    assert len(want) > 100

    def body(pkg):
        got = pkg.scan(pkg.compile_multi([pat]), d)
        assert _ends(got) == want
        return got

    parity(body)


def test_bitnfa_device_anchored():
    rng = np.random.default_rng(6)
    pat = r"^[ab]a.{10}b"
    d = _rand(rng, b"ab", 140_000)
    want = _bitnfa_ends(pat, d)

    def body(pkg):
        db = pkg.compile_patterns([pat], max_dfa_states=8, allow_teddy=False)
        assert isinstance(db.engines[0], pkg.database.NfaEngine)
        got = pkg.scan(db, d)
        assert _ends(got) == want
        return got

    parity(body)


def test_bitnfa_streaming_and_codec():
    rng = np.random.default_rng(9)
    pat = r".*a.{18}b"
    d = _rand(rng, b"aabxy", 2500)

    def body(pkg):
        sdb = pkg.compile_multi([pat], mode=pkg.HS_MODE_STREAM)
        want = _ends(pkg.scan(pkg.compile_multi([pat]), d))
        out = []
        for cuts in ([100, 500, 1400], [1, 2, 20, 21], [2499]):
            st = pkg.open_stream(sdb)
            ms, prev = [], 0
            for c in cuts + [len(d)]:
                ms += pkg.scan_stream(st, d[prev:c])
                prev = c
            ms += pkg.close_stream(st)
            assert _ends(ms) == want, cuts
            out.append(ms)
        st = pkg.open_stream(sdb)
        pkg.scan_stream(st, d[:1200])
        blob = pkg.compress_stream(st)
        st2 = pkg.expand_stream(sdb, blob)
        a = pkg.scan_stream(st, d[1200:]) + pkg.close_stream(st)
        b = pkg.scan_stream(st2, d[1200:]) + pkg.close_stream(st2)
        assert a == b
        return out, a, blob

    parity(body)


def test_bitnfa_serialize_roundtrip():
    rng = np.random.default_rng(1)
    d = _rand(rng, b"abcdexyzq", 400)

    def body(pkg):
        db = pkg.compile_multi(BLOWUPS, ids=[1, 2, 3])
        db2 = pkg.deserialize_database(pkg.serialize_database(db))
        got = sorted(pkg.scan(db2, d))
        assert sorted(pkg.scan(db, d)) == got
        return got

    parity(body)


def test_bitnfa_native_matches_numpy(monkeypatch):
    from hyperscan_tpu.native import bitnfa_scan_batch_native as ref_native
    from hyperscan_tpu_torch.runtime.nfa_host import nfa_scan_host

    rng = np.random.default_rng(2)
    db = ht.compile_multi([r".*a.{18}b"])
    rdb = hs.compile_multi([r".*a.{18}b"])
    eng, reng = db.engines[0], rdb.engines[0]
    data = rng.choice(np.frombuffer(b"aabxy", np.uint8), size=(2, 3000))
    lengths = np.asarray([3000, 2500], np.int32)
    nat = native.bitnfa_scan_batch_native(eng, data, lengths,
                                          [eng.start_state] * 2)
    assert nat is not None, "the port's native library did not build"
    want = ref_native(reng, data, lengths, [reng.start_state] * 2)
    monkeypatch.setenv("HSTPU_NO_NATIVE", "1")
    fallback = nfa_scan_host(eng, data, lengths, [eng.start_state] * 2)
    for got in (nat, fallback):
        for (gp, gv), (wp, wv) in zip(got[0], want[0]):
            assert gp.tolist() == wp.tolist() and gv.tolist() == wv.tolist()
        assert got[1] == want[1]


def test_capacity_overflow_learns_hint(monkeypatch):
    """The port's counterpart: an overflow dispatches kernel C again at
    the needed power of two and remembers it on the engine, so a repeat
    scan dispatches once."""
    rng = np.random.default_rng(4)
    db = port_database.compile_patterns([r"ab"],
                                        grey=ht.Grey(allow_teddy=False))
    eng = db.engines[0]
    d = bytes(rng.choice(np.frombuffer(b"ab", np.uint8), size=200_000))
    calls = []
    real = dfa_kernel.dfa_scan_chunks

    def counted(*a, **kw):
        calls.append(a[-1])
        return real(*a, **kw)

    monkeypatch.setattr(dfa_kernel, "dfa_scan_chunks", counted)
    recs1, fin1 = dfa_kernel.dfa_scan_corpus_device(
        eng, [d], np.ones(1, bool), capacity=64, device="cpu")
    first = list(calls)
    hint = dfa_kernel.get_capacity_hint(eng, "dfa")
    assert len(first) == 2 and first[0] == 64 and hint == first[1] >= \
        len(recs1[0])
    del calls[:]
    recs2, fin2 = dfa_kernel.dfa_scan_corpus_device(
        eng, [d], np.ones(1, bool), capacity=64, device="cpu")
    assert calls == [hint], "a repeat scan dispatched kernel C again"
    assert sorted(zip(*[a.tolist() for a in recs1])) == sorted(
        zip(*[a.tolist() for a in recs2]))
    # as many records as the reference's scan of the same pattern matches
    want = REF.scan(REF.compile_patterns([r"ab"], allow_teddy=False), d)
    assert len(want) == len(recs1[0])


def test_anchored_dominance_reduction():
    DOTALL = ht.HS_FLAG_DOTALL
    g1 = build_nfa(parse(r"^.*foo", DOTALL))
    r1 = reduce_graph(g1)
    assert r1.num_positions == g1.num_positions - 1
    assert nfa_match_ends(r1, b"foo") == {3}
    r2 = reduce_graph(build_nfa(parse(r"^.+foo", DOTALL)))
    assert nfa_match_ends(r2, b"foo") == set()
    assert nfa_match_ends(r2, b"xfoo") == {4}
    datas = [b"foo", b"xfoo", b"\nfoo xfoo", b""]

    def body(pkg):
        out = []
        for pat in (r"^.*foo", r"^.+foo"):
            db = pkg.compile(pat, pkg.HS_FLAG_DOTALL)
            out.append([pkg.scan(db, d) for d in datas])
        assert [_ends(ms) for ms in out[0]] == [{3}, {4}, {4, 9}, set()]
        assert [_ends(ms) for ms in out[1]] == [set(), {4}, {4, 9}, set()]
        return out

    parity(body)


def test_layered_kernel_eod_accepts():
    """tests/test_bitnfa.py's Pallas interpret-mode case (skipped there
    unless HSTPU_SLOW_TESTS is set): a layered engine with EOD accepts
    over 9,000 bytes past a 1 KiB host limit, the last ten bytes an EOD
    match. Here the port's plain version of kernel D runs it, against
    the bit-NFA reference scan and the reference's host route."""
    pat = r".*x.{8}(y|z)$"
    rng = np.random.default_rng(3)
    d = _rand(rng, b"xyzab", 8990) + b"xabxyzabzy"
    want = _bitnfa_ends(pat, d)
    assert len(d) in want

    def body(pkg):
        db = pkg.compile_patterns([pat], max_dfa_states=8, allow_teddy=False)
        (eng,) = db.engines
        assert isinstance(eng, pkg.database.NfaEngine) and \
            bool(eng.accept_eod_gid.max())
        got = pkg.scan(db, d)
        assert _ends(got) == want
        return got

    parity(body)


def test_cyclic_nfa_speculative_device_scan(monkeypatch):
    pat = r"(ax|by|cz|dw)+[!]"
    rng = np.random.default_rng(17)
    blob = bytearray((32 + rng.integers(0, 95, 300_000)).astype(np.uint8)
                     .tobytes())
    for _ in range(60):
        frag = b"ax" * int(rng.integers(0, 4)) + b"by" + b"!"
        off = int(rng.integers(0, len(blob) - 20))
        blob[off:off + len(frag)] = frag
    data = bytes(blob)

    def body(pkg):
        db = pkg.compile_patterns([pat], max_dfa_states=8, allow_teddy=False)
        (eng,) = _nfa_engines(pkg, db)
        assert not eng.acyclic and eng.spec_dfa is not None
        got = sorted(pkg.scan(db, data))
        db2 = pkg.compile_patterns([pat], max_dfa_states=8,
                                   allow_teddy=False)
        _nfa_engines(pkg, db2)[0].spec_dfa = None
        ref = sorted(pkg.scan(db2, data))
        assert got == ref and len(got) >= 40
        db3 = pkg.deserialize_database(pkg.serialize_database(db))
        assert _nfa_engines(pkg, db3)[0].spec_dfa is not None
        assert sorted(pkg.scan(db3, data)) == got
        return got

    parity(body, share_compiles=False)

    # a tiny core: transitions leave the explored space (a real sink) and
    # the sink-touched chunks rescan exactly on the host
    monkeypatch.setattr(port_database, "SPEC_DFA_STATES", 5)
    db4 = port_database.compile_patterns(
        [pat], grey=ht.Grey(max_dfa_states=8, allow_teddy=False,
                            host_scan_limit=0))
    (eng4,) = _nfa_engines(HOST, db4)
    assert eng4.spec_dfa is not None and eng4.spec_dfa.sink_state is not None
    want = REF.scan(REF.compile_patterns([pat], max_dfa_states=8,
                                         allow_teddy=False), data)
    with Uploads() as up:
        assert sorted(DEVICE.scan(db4, data)) == sorted(want)
    assert up.n > 0


# --- tests/test_internal.py --------------------------------------------------


UTF8_RANGES = [
    [(0x41, 0x5A)],
    [(0x7E, 0x84)],
    [(0x7F0, 0x812)],
    [(0xD7FA, 0xE005)],
    [(0xFFF0, 0x10010)],
    [(0x3B1, 0x3C9), (0x10400, 0x10427)],
]


@pytest.mark.parametrize("ranges", UTF8_RANGES)
def test_utf8_range_split_bruteforce(ranges):
    """Each codepoint set splits into byte-sequence alternations that
    cover it exactly, equal to the reference's; a UTF-8 class of it
    matches exactly its codepoints on every route."""
    from hyperscan_tpu.compiler.utf8 import cp_ranges_to_seqs as ref_split
    from hyperscan_tpu_torch.compiler.utf8 import cp_ranges_to_seqs

    seqs = cp_ranges_to_seqs(ranges)
    assert seqs == ref_split(ranges)

    def covered(bs: bytes) -> bool:
        return any(len(bs) == len(seq)
                   and all(lo <= b <= hi for (b, (lo, hi)) in zip(bs, seq))
                   for seq in seqs)

    cps = []
    for (lo, hi) in ranges:
        for cp in range(max(0, lo - 2), hi + 3):
            if 0xD800 <= cp <= 0xDFFF or cp > 0x10FFFF:
                continue
            inside = any(lo_ <= cp <= hi_ for (lo_, hi_) in ranges)
            assert covered(chr(cp).encode("utf-8")) == inside, hex(cp)
            cps.append((cp, inside))
    cls = "[" + "".join(rf"\x{{{lo:x}}}-\x{{{hi:x}}}"
                        for (lo, hi) in ranges) + "]"
    text = "".join(chr(cp) + "," for (cp, _i) in cps).encode("utf-8")
    ends, off = set(), 0
    for cp, inside in cps:
        off += len(chr(cp).encode("utf-8"))
        if inside:
            ends.add(off)
        off += 1

    def body(pkg):
        got = pkg.scan(pkg.compile(cls, pkg.HS_FLAG_UTF8), text)
        assert _ends(got) == ends
        return got

    parity(body)


def test_ucp_category_ranges_sanity():
    from hyperscan_tpu.compiler import ucp as ref_ucp
    from hyperscan_tpu_torch.compiler.ucp import category_ranges, word_ranges

    lu = category_ranges("Lu")
    assert lu == ref_ucp.category_ranges("Lu")
    assert any(lo <= ord("A") <= hi for (lo, hi) in lu)
    assert not any(lo <= ord("a") <= hi for (lo, hi) in lu)
    w = word_ranges()
    assert w == ref_ucp.word_ranges()
    for ch in "aZ9_δ漢":
        assert any(lo <= ord(ch) <= hi for (lo, hi) in w), ch
    assert not any(lo <= ord("-") <= hi for (lo, hi) in w)

    def body(pkg):
        got = pkg.scan(pkg.compile(r"\p{Lu}", pkg.HS_FLAG_UTF8
                                   | pkg.HS_FLAG_UCP), "aZ δΔ 漢".encode())
        assert _ends(got) == {2, 7}
        return got

    parity(body)


@pytest.mark.parametrize("density,n", [(0.0, 1 << 14), (0.001, 1 << 14),
                                       (0.3, 1 << 13)])
def test_plane_extract_plain_vs_nonzero(density, n):
    """tests/test_internal.py's sparse_extract case, on the port's
    extraction (the dense family's; its CUDA kernel is held to this plain
    version on the card): the first cap1 nonzero positions of the valid
    chunks, equal to torch.nonzero over the masked plane and to the
    reference's sparse_extract on the same plane."""
    import jax.numpy as jnp

    from hyperscan_tpu.ops.teddy import sparse_extract
    from hyperscan_tpu_torch.ops.extract import plane_extract_plain
    from hyperscan_tpu_torch.ops.teddy import EXTRACT_CHUNK

    rng = np.random.default_rng(0)
    plane = np.where(rng.random(n) < density, rng.integers(1, 99, n),
                     0).astype(np.uint8)
    nvalid = n - 100
    keep = plane.copy()
    for c in range(n // EXTRACT_CHUNK):
        if c * EXTRACT_CHUNK >= nvalid:
            keep[c * EXTRACT_CHUNK:(c + 1) * EXTRACT_CHUNK] = 0
    want = torch.nonzero(torch.from_numpy(keep)).squeeze(1)
    for cap1 in (1 << 13, 16):
        meta, pos = plane_extract_plain(torch.from_numpy(plane), nvalid,
                                        cap1)
        total, n_hit = (int(x) for x in meta)
        assert total == want.numel()
        assert n_hit == int((keep.reshape(-1, EXTRACT_CHUNK) != 0)
                            .any(1).sum())
        k = min(cap1, total)
        assert pos[:k].tolist() == want[:k].tolist()
        assert (pos[k:] == -1).all()
    rmeta, packed = sparse_extract(
        [jnp.asarray(plane.astype(np.int32))], jnp.int32(nvalid), 1 << 13,
        1 << 9, nz=jnp.asarray(plane.astype(np.int32)),
        chunk=EXTRACT_CHUNK)
    assert int(np.asarray(rmeta)[0]) == total
    if total <= 1 << 13:
        assert np.asarray(packed[0, :total]).tolist() == want.tolist()


def test_teddy_plan_masks_cover_factors():
    from hyperscan_tpu.compiler import literals as ref_literals
    from hyperscan_tpu.compiler.teddy import build_teddy as ref_build
    from hyperscan_tpu_torch.compiler.literals import Factor, LitAtom
    from hyperscan_tpu_torch.compiler.teddy import build_teddy

    rng = np.random.default_rng(1)
    words = [bytes(rng.integers(97, 123, rng.integers(3, 10)).tolist())
             for _ in range(200)]
    plan = build_teddy([Factor(tuple(LitAtom(b, 0xFF) for b in w))
                        for w in words])
    ref_plan = ref_build([ref_literals.Factor(tuple(
        ref_literals.LitAtom(b, 0xFF) for b in w)) for w in words])
    assert np.array_equal(plan.masks, ref_plan.masks)
    assert list(plan.bucket_of) == list(ref_plan.bucket_of)
    for fid, w in enumerate(words):
        wd, bit = divmod(plan.bucket_of[fid], 32)
        for m in range(plan.m):
            if m < len(w):
                assert plan.masks[m, wd, w[-1 - m]] & (1 << bit), (fid, m)
    corpus = bytearray((97 + rng.integers(0, 26, 20_000)).astype(np.uint8))
    for k in range(0, 200, 9):
        off = 50 + 97 * k
        corpus[off:off + len(words[k])] = words[k]
    corpus = bytes(corpus)

    def body(pkg):
        got = pkg.scan(pkg.compile_lit_multi(words, ids=list(range(200))),
                       corpus)
        assert {(k, 50 + 97 * k + len(words[k])) for k in range(0, 200, 9)} \
            <= {(i, t) for (i, _f, t) in got}
        return got

    parity(body)


def test_fuzzy_graph_width_accounting():
    from hyperscan_tpu.compiler.fuzzy import fuzzy_graph as ref_fuzzy
    from hyperscan_tpu_torch.compiler.fuzzy import fuzzy_graph

    fz = fuzzy_graph(build_nfa(parse("abcd", 0)), edit=1, hamming=0)
    rfz = ref_fuzzy(ref_glushkov.build_nfa(ref_parser.parse("abcd", 0)),
                    edit=1, hamming=0)
    probes = [b"abd", b"abxd", b"abxcd", b"ad", b"abcd", b"zabcdz"]
    for p in probes:
        assert nfa_match_ends(fz, p) == ref_oracle.nfa_match_ends(rfz, p)
    assert 3 in nfa_match_ends(fz, b"abd")
    assert 4 in nfa_match_ends(fz, b"abxd")
    assert 5 in nfa_match_ends(fz, b"abxcd")
    assert nfa_match_ends(fz, b"ad") == set()

    def body(pkg):
        db = pkg.compile_ext_multi(["abcd"], ids=[1],
                                   ext=[pkg.ExprExt(edit_distance=1)])
        out = [pkg.scan(db, p) for p in probes]
        assert [_ends(ms) for ms in out] == [nfa_match_ends(fz, p)
                                             for p in probes]
        return out

    parity(body)


def test_reverse_graph_som_roundtrip():
    from hyperscan_tpu_torch.compiler.dfa import determinize, reverse_graph

    rev = determinize([reverse_graph(build_nfa(parse("a{1,3}bc", 0)),
                                     eod=False)], [0])
    data = b"aaabc"
    s = rev.start_state
    starts = set()
    for j in range(len(data) - 1, -1, -1):
        s = int(rev.trans[s, rev.byte_to_class[data[j]]])
        aid = int(rev.accept_id[s])
        if aid:
            for (_e, adj) in rev.accept_sets[aid]:
                starts.add(j + adj)
    assert starts == {0, 1, 2}

    def body(pkg):
        db = pkg.compile("a{1,3}bc", pkg.HS_FLAG_SOM_LEFTMOST)
        got = pkg.scan(db, data + b" abc aabc")
        assert got[0] == (0, 0, 5)
        return got

    parity(body)


def test_lbr_counter_engine():
    pats = ([rf"[0-9]{{{500 + i},{1000 + i}}}" for i in range(50)]
            + [rf"[^ ]{{{5000 + i},}}" for i in range(50)])
    rng = np.random.default_rng(9)
    datas = [bytes(rng.choice(np.frombuffer(b"0123x", np.uint8),
                              p=[0.24, 0.24, 0.24, 0.24, 0.04],
                              size=int(rng.integers(0, 180))))
             for _ in range(15)]
    node = parse(r"[0-9]{40,60}", 0)

    def body(pkg):
        db = pkg.compile_multi(pats, ids=list(range(100)))
        assert all(isinstance(e, pkg.database.LbrEngine) for e in db.engines)
        assert db.state_count() == 100
        ms = pkg.scan(db, b"x" + b"7" * 600 + b" tail")
        got0 = sorted(m[2] for m in ms if m[0] == 0)
        assert got0[0] == 501 and got0[-1] == 601 and len(got0) == 101
        db2 = pkg.compile_multi([r"[0-9]{40,60}"])
        out = [pkg.scan(db2, d) for d in datas]
        for d, got in zip(datas, out):
            assert _ends(got) == ast_match_ends(node, d)
        return ms, out

    parity(body)


def test_dropped_database_releases_its_tables():
    """The port's counterpart of the reference's jit-registry case: the
    device branch hangs its tables on the database's own objects (the
    literal object, the engines), and no module keeps them, so dropping a
    database after a device-branch scan frees them all."""
    refs = []
    for pats in (["attackZZ", "needle77"], [r"[0-9]{3}-[0-9]{4}"]):
        refs += _scanned_and_dropped(pats)
    gc.collect()
    assert refs and all(r() is None for r in refs)


def _scanned_and_dropped(pats):
    """Weak references to a database, its literal object and engines and
    the device tables hung on them, after a device-branch scan."""
    db = ht.database.compile_patterns(pats, grey=ht.Grey(host_scan_limit=0))
    assert ht.scan(db, b"xx attackZZ yy 555-1212 " + b"." * 200,
                   device="cpu")
    held = [db] + list(db.engines)
    if db.lit is not None:
        held.append(db.lit)
        assert {"_torch_tables", "_torch_family", "_confirm_dev"} <= \
            set(db.lit.__dict__)
        held.append(db.lit._torch_tables["cpu"][0].masks)
    for eng in db.engines:
        assert eng.__dict__.get("_torch_dfa_tables")
        held += list(eng._torch_dfa_tables.values())
    return [weakref.ref(o) for o in held]


# --- tests/test_native.py ----------------------------------------------------


def test_native_builds(tmp_path, monkeypatch):
    """The port's g++ build in a cold cache: under a temporary name of
    this process's own, then installed; it loads and a second call finds
    it."""
    import subprocess

    assert native.get_lib() is not None
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    cmds = []
    real = subprocess.run

    def run(cmd, *a, **kw):
        cmds.append(list(cmd))
        return real(cmd, *a, **kw)

    monkeypatch.setattr(subprocess, "run", run)
    assert native._build() is not None
    (cmd,) = cmds
    out = cmd[cmd.index("-o") + 1]
    assert out.endswith(f".{os.getpid()}.tmp")
    built = sorted(p.name for p in (tmp_path / "hyperscan_tpu_torch").iterdir())
    assert built == [os.path.basename(out)[:-len(f".{os.getpid()}.tmp")]]
    assert native._build() is not None and len(cmds) == 1


def test_scan_matches_with_and_without_native():
    data = b"zz attack42 foobaz 555-1212 " * 30

    def body(pkg):
        db = pkg.compile_multi(
            [r"attack[0-9]+", r"foo(bar|baz)", r"[0-9]{3}-[0-9]{4}"],
            ids=[1, 2, 3])
        with_native = pkg.scan(db, data)
        os.environ["HSTPU_NO_NATIVE"] = "1"
        try:
            without = pkg.scan(db, data)
        finally:
            del os.environ["HSTPU_NO_NATIVE"]
        assert with_native == without
        assert {m[0] for m in with_native} == {1, 2, 3}
        return with_native

    parity(body)


def _plan(rng, lo, hi, n):
    from hyperscan_tpu_torch.compiler.literals import Factor, LitAtom
    from hyperscan_tpu_torch.compiler.teddy import build_teddy

    lits = [bytes(rng.integers(lo, hi, rng.integers(*n)).tolist())
            for _ in range({(3, 9): 50, (2, 12): 200}[n])]
    return lits, build_teddy([Factor(tuple(LitAtom(b, 0xFF) for b in lit))
                              for lit in lits])


def test_teddy_filter_native_equals_numpy(monkeypatch):
    from hyperscan_tpu.runtime.smallwrite import teddy_filter_host as ref_f

    rng = np.random.default_rng(0)
    lits, plan = _plan(rng, 97, 123, (3, 9))
    corpus = np.frombuffer(rng.integers(97, 123, 65536, dtype=np.uint8)
                           .tobytes() + lits[0] + lits[7], dtype=np.uint8)
    got = native.teddy_filter_native(corpus, plan.masks)
    assert got is not None
    want = ref_f(corpus, plan.masks)
    monkeypatch.setenv("HSTPU_NO_NATIVE", "1")
    plain = teddy_filter_host(corpus, plan.masks)
    for pos, words in (got, plain):
        assert np.array_equal(pos, want[0]) and np.array_equal(words, want[1])


def test_teddy_filter_both_gates_equal_numpy(monkeypatch):
    rng = np.random.default_rng(5)
    lits, plan = _plan(rng, 32, 127, (2, 12))
    corpus = np.frombuffer(rng.integers(32, 127, 100003, dtype=np.uint8)
                           .tobytes() + lits[3] + lits[11] + lits[42],
                           dtype=np.uint8)
    lib = native.get_lib()
    masks = np.ascontiguousarray(plan.masks, dtype=np.int32)
    M, W, _ = masks.shape
    pair = native._pair_table(plan.masks)
    nib, _survival = native._nib_tables(plan.masks)
    pair8 = native._pair_table8(plan.masks)
    _p = native._ptr
    monkeypatch.setenv("HSTPU_NO_NATIVE", "1")
    ref_pos, ref_words = teddy_filter_host(corpus, plan.masks)
    for fn, args in (
            (lib.hstpu_teddy_filter_nib, (_p(masks), M, W, _p(pair), _p(nib))),
            (lib.hstpu_teddy_filter_pair, (_p(masks), M, W, _p(pair))),
            (lib.hstpu_teddy_filter_pair8, (_p(masks), M, W, _p(pair8)))):
        cap = 1 << 14
        out_pos = np.empty(cap, np.int64)
        out_words = np.empty((W, cap), np.int32)
        cnt = int(fn(*args, _p(corpus), corpus.shape[0], _p(out_pos),
                     _p(out_words), cap))
        assert cnt <= cap
        assert np.array_equal(out_pos[:cnt], ref_pos)
        assert np.array_equal(out_words[:, :cnt], ref_words)


def test_confirm_native_equals_numpy(monkeypatch):
    from hyperscan_tpu.runtime.lit_runtime import confirm_candidates as rcc
    from hyperscan_tpu_torch.runtime.lit_runtime import confirm_candidates

    pats = ["abc", "xabcdefghijklm", "ABC", "q", "deadbeefcafe"]
    flags = [0, 0, ht.HS_FLAG_CASELESS, 0, 0]
    db = ht.compile_multi(pats, ids=[1, 2, 3, 4, 5], flags=flags)
    rdb = hs.compile_multi(pats, ids=[1, 2, 3, 4, 5], flags=flags)
    corpus = np.frombuffer(b"abcxabcdefghijklmqqaBcdeadbeefcafe abc",
                           np.uint8).copy()
    pos, words = teddy_filter_host(corpus, db.lit.masks)
    total = 0
    for bs_l in ([0], [0, 5], [0, 17], [0, 1, 2, 3, 30]):
        bs = np.asarray(bs_l, np.int64)
        f_n, p_n = confirm_candidates(db.lit, corpus, bs, pos, words)
        f_r, p_r = rcc(rdb.lit, corpus, bs, pos, words)
        monkeypatch.setenv("HSTPU_NO_NATIVE", "1")
        f_p, p_p = confirm_candidates(db.lit, corpus, bs, pos, words)
        monkeypatch.delenv("HSTPU_NO_NATIVE")
        want = sorted(zip(f_r.tolist(), p_r.tolist()))
        assert sorted(zip(f_n.tolist(), p_n.tolist())) == want, bs_l
        assert sorted(zip(f_p.tolist(), p_p.tolist())) == want, bs_l
        total += len(f_n)
    assert total
