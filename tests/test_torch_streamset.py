"""The port's StreamSet against the JAX package's
(hyperscan_tpu_torch.runtime.streamset vs hyperscan_tpu.runtime.streamset).

Mirrors tests/test_streamset.py:75-288: both packages compile the same
databases and take the same write rounds; the port's StreamSets scan on
the CPU (device="cpu", the plain PyTorch versions), the reference as its
own tests run it. Per-round match lists and EOD reports are compared
exactly, against the reference's StreamSet and against the port's own
per-stream scan_streams. The pre-stitched form is held as the port has
it, `ext_t` (a flat uint8 tensor on the StreamSet's device), against the
reference's `ext_rows` (its TPU rows layout).
"""

import numpy as np
import pytest
import torch

import hyperscan_tpu as hs
import hyperscan_tpu_torch as ht
import torch_ref_native  # noqa: F401 (the reference's native build, locked)

from hyperscan_tpu.runtime import streamset as RSS
from hyperscan_tpu_torch.ops import teddy_families as F
from hyperscan_tpu_torch.runtime import streamset as PSS
from hyperscan_tpu_torch.runtime.stream import history_required

CPU = "cpu"

DBSETS = {
    "literal": (["attack", "payload7", "select"], [1, 2, 3], [0, 0, 0]),
    "validators": (
        [r"attack[0-9]{2,4}z", r"ad(min|visor)q", r"^hdr[a-f]{2}"],
        [1, 2, 3], [0, 0, 0],
    ),
    "chains": (
        [r"foomark[0-9]{3,9}barmark", r"lead\d{4,}tail"],
        [1, 2], [0, 0],
    ),
    "engines": (
        [r"[0-9]{3}-[0-9]{4}", r"q[a-z]*7end"],
        [1, 2], [0, 0],
    ),
    "som": (
        [r"num[0-9]{2,5}x", "plainlit"],
        [1, 2], [hs.HS_FLAG_SOM_LEFTMOST, hs.HS_FLAG_SOM_LEFTMOST],
    ),
    "single": (
        ["dup", r"v[0-9]ral"], [1, 2],
        [hs.HS_FLAG_SINGLEMATCH, 0],
    ),
    "vacuous": (
        [r"x*", "anchor"], [1, 2],
        [hs.HS_FLAG_ALLOWEMPTY, 0],
    ),
}


def _both(name):
    pats, ids, flags = DBSETS[name]
    ref = hs.compile_multi(pats, ids=ids, flags=flags,
                           mode=hs.HS_MODE_STREAM)
    port = ht.compile_multi(pats, ids=ids, flags=flags,
                            mode=ht.HS_MODE_STREAM)
    return ref, port


def _gen_writes(rng, S, rounds):
    """Random writes salted with fragments that can hit the patterns
    (tests/test_streamset.py:52)."""
    frags = [b"attack123z", b"attack", b"payload7", b"adminq", b"advisorq",
             b"hdrab", b"foomark12345barmark", b"lead4444tail", b"555-1212",
             b"qzz7end", b"num123x", b"plainlit", b"dup", b"v9ral",
             b"xxxx", b"anchor", b"select"]
    writes = []
    for _r in range(rounds):
        per = []
        for _s in range(S):
            n = int(rng.integers(0, 60))
            c = bytearray(rng.integers(32, 127, size=n).astype(np.uint8))
            for _k in range(int(rng.integers(0, 3))):
                f = frags[int(rng.integers(0, len(frags)))]
                p = int(rng.integers(0, max(1, n)))
                c[p:p + len(f)] = f[:max(0, n - p)]
            per.append(bytes(c))
        writes.append(per)
    return writes


@pytest.mark.parametrize("dbname", sorted(DBSETS))
@pytest.mark.parametrize("seed", [3, 11])
def test_streamset_equals_reference_and_scan_streams(dbname, seed):
    """Mirror of test_streamset.py:75: every round and the close equal
    the reference's StreamSet and the port's own scan_streams."""
    rdb, pdb = _both(dbname)
    rng = np.random.default_rng(seed)
    S, ROUNDS = 4, 5
    writes = _gen_writes(rng, S, ROUNDS)
    rss = RSS.open_streamset(rdb, S)
    pss = PSS.open_streamset(pdb, S, device=CPU)
    streams = [ht.open_stream(pdb, device=CPU) for _ in range(S)]
    for r in range(ROUNDS):
        got = PSS.scan_streamset(pdb, pss, writes[r])
        assert got == RSS.scan_streamset(rdb, rss, writes[r]), (dbname, r)
        one = ht.scan_streams(pdb, streams, writes[r])
        assert [sorted(g) for g in got] == [sorted(o) for o in one]
    got = PSS.close_streamset(pdb, pss)
    assert got == RSS.close_streamset(rdb, rss)
    assert [sorted(g) for g in got] == \
        [sorted(ht.close_stream(s)) for s in streams]


def test_streamset_state_interop_crosses_packages():
    """Mirror of test_streamset.py:97: a detached stream of the port's
    StreamSet continues like the per-stream path, and its compressed
    state equals the reference's snapshot byte for byte."""
    rdb, pdb = _both("validators")
    rng = np.random.default_rng(5)
    S = 3
    writes = _gen_writes(rng, S, 3)
    rss = RSS.open_streamset(rdb, S)
    pss = PSS.open_streamset(pdb, S, device=CPU)
    streams = [ht.open_stream(pdb, device=CPU) for _ in range(S)]
    for r in range(3):
        ht.scan_streams(pdb, streams, writes[r])
        RSS.scan_streamset(rdb, rss, writes[r])
        PSS.scan_streamset(pdb, pss, writes[r])
    tail = _gen_writes(rng, S, 1)[0]
    for i in range(S):
        s_copy = PSS.streamset_stream(pss, i)
        assert s_copy.device == torch.device("cpu")
        blob = ht.compress_stream(s_copy)
        assert blob == hs.compress_stream(RSS.streamset_stream(rss, i))
        a = ht.scan_stream(streams[i], tail[i])
        assert ht.scan_stream(s_copy, tail[i]) == a
        s2 = ht.expand_stream(pdb, blob, device=CPU)
        assert ht.scan_stream(s2, tail[i]) == a
        # load it back into the StreamSet: the slot goes on the same way
        PSS.streamset_load(pss, i, ht.expand_stream(pdb, blob, device=CPU))
    PSS.scan_streamset(pdb, pss, tail)


def test_streamset_pipelined_equals_reference():
    """Mirror of test_streamset.py:123 and :182: started rounds finished
    in order equal synchronous rounds and the reference's pipelined
    rounds, for a pure-literal database and for stateful ones."""
    for name in ("literal", "engines", "chains"):
        rdb, pdb = _both(name)
        rng = np.random.default_rng(9)
        S, ROUNDS = 3, 4
        writes = _gen_writes(rng, S, ROUNDS)
        sync = PSS.open_streamset(pdb, S, device=CPU)
        want = [PSS.scan_streamset(pdb, sync, w) for w in writes]
        rss = RSS.open_streamset(rdb, S)
        rh = [RSS.streamset_write_start(rdb, rss, w) for w in writes]
        ref = [RSS.streamset_write_finish(rdb, rss, h) for h in rh]
        pss = PSS.open_streamset(pdb, S, device=CPU)
        ph = [PSS.streamset_write_start(pdb, pss, w) for w in writes]
        got = [PSS.streamset_write_finish(pdb, pss, h) for h in ph]
        assert got == want == ref, name
        assert PSS.close_streamset(pdb, pss) == \
            PSS.close_streamset(pdb, sync) == RSS.close_streamset(rdb, rss)


def test_streamset_ext_t_equals_reference_ext_rows():
    """Mirror of test_streamset.py:146: the pre-stitched form, the port's
    `ext_t` (a flat tensor on the StreamSet's device) against the
    reference's `ext_rows` (its rows layout, Pallas in interpret mode),
    and against the chunks form. host_scan_limit 0 also sends the
    chunks form to the device path; its rounds pipeline through
    confirm_fetch_many."""
    from hyperscan_tpu.ops.teddy import corpus_to_rows
    import jax.numpy as jnp

    pats = ["attack", "payload7", r"sig[0-9]{2}end"]
    rdb = hs.compile_multi(pats, ids=[1, 2, 3], mode=hs.HS_MODE_STREAM)
    pdb = ht.compile_multi(pats, ids=[1, 2, 3], mode=ht.HS_MODE_STREAM)
    rng = np.random.default_rng(21)
    S, ROUNDS = 3, 3
    writes = _gen_writes(rng, S, ROUNDS)
    ss_chunks = PSS.open_streamset(pdb, S, device=CPU)
    want = [PSS.scan_streamset(pdb, ss_chunks, w) for w in writes]
    rss = RSS.open_streamset(rdb, S)
    pss = PSS.open_streamset(pdb, S, device=CPU)
    assert history_required(pdb) > 0
    for r in range(ROUNDS):
        outs = []
        for mod, ss in ((RSS, rss), (PSS, pss)):
            hl = np.asarray([len(h) for h in ss.hist], dtype=np.int64)
            cl = np.asarray([len(c) for c in writes[r]], dtype=np.int64)
            ext = np.frombuffer(b"".join(
                bytes(h) + c for h, c in zip(ss.hist, writes[r])),
                dtype=np.uint8)
            if mod is RSS:
                h = RSS.streamset_write_start(
                    rdb, ss, ext_np=ext, ext_rows=jnp.asarray(
                        corpus_to_rows(ext)), hlens=hl, chunk_lens=cl)
                outs.append(RSS.streamset_write_finish(rdb, ss, h))
            else:
                ext_t = torch.from_numpy(ext.copy())
                h = PSS.streamset_write_start(
                    pdb, ss, ext_np=ext, ext_t=ext_t, hlens=hl,
                    chunk_lens=cl)
                assert h.dev_handle is not None
                assert h.dev_handle.corpus is ext_t
                outs.append(PSS.streamset_write_finish(pdb, ss, h))
        assert outs[0] == outs[1] == want[r], r
    assert PSS.close_streamset(pdb, pss) == RSS.close_streamset(rdb, rss)

    pdb.host_scan_limit = 0
    pipe = PSS.open_streamset(pdb, S, device=CPU)
    handles = [PSS.streamset_write_start(pdb, pipe, w) for w in writes]
    assert all(h.dev_handle is not None for h in handles)
    gots = F.confirm_fetch_many([h.dev_handle for h in handles])
    got = [PSS.streamset_write_finish(pdb, pipe, h, got=g)
           for h, g in zip(handles, gots)]
    assert got == want


def test_streamset_overflow_redispatches_on_own_extents():
    """A round started before an earlier round taught the database a
    larger load overflows its capacities; its finish dispatches it again
    over its own extent tensor (no host fallback) and loses nothing."""
    pdb = ht.compile_multi(["aaaa", "attack"], ids=[1, 2],
                           mode=ht.HS_MODE_STREAM)
    pdb.host_scan_limit = 64
    S = 4
    writes = [[b"x attack y" * 10] * S,
              [b"a" * 3000] * S]  # a flood: every byte a candidate
    sync = PSS.open_streamset(pdb, S, device=CPU)
    want = [PSS.scan_streamset(pdb, sync, w) for w in writes]
    fresh = ht.compile_multi(["aaaa", "attack"], ids=[1, 2],
                             mode=ht.HS_MODE_STREAM)
    fresh.host_scan_limit = 64
    ss = PSS.open_streamset(fresh, S, device=CPU)
    handles = [PSS.streamset_write_start(fresh, ss, w) for w in writes]
    ext1 = handles[1].dev_handle.corpus
    got = [PSS.streamset_write_finish(fresh, ss, h) for h in handles]
    assert got == want and sum(map(len, got[1])) == S * 2997
    st = F.family_state(fresh.lit)
    assert sum(st.dispatches.values()) > 2  # the flood dispatched again
    assert handles[1].dev_handle.corpus is ext1


def test_streamset_guards_and_device():
    """Mirror of test_streamset.py:204, :221 and :253, plus the device
    rules: a StreamSet runs on the card by default (and raises without
    one), and `ext_t` must be a flat uint8 tensor on its device."""
    _r, pdb = _both("engines")
    ss = PSS.open_streamset(pdb, 2, device=CPU)
    h = PSS.streamset_write_start(pdb, ss, [b"abc", b"def"])
    h2 = PSS.streamset_write_start(pdb, ss, [b"x", b"y"])
    with pytest.raises(ht.InvalidError):
        PSS.streamset_write_finish(pdb, ss, h2)
    with pytest.raises(ht.InvalidError):
        PSS.streamset_stream(ss, 0)
    PSS.streamset_write_finish(pdb, ss, h)
    PSS.streamset_write_finish(pdb, ss, h2)
    PSS.close_streamset(pdb, ss)
    with pytest.raises(ht.InvalidError):
        PSS.streamset_write_start(pdb, ss, [b"x", b"y"])

    db = ht.compile_multi(["stopword", "other1"], ids=[1, 2],
                          mode=ht.HS_MODE_STREAM)
    calls = []

    def cb(mid, frm, to, fl):
        calls.append((mid, to))
        return 1

    ss = PSS.open_streamset(db, 2, device=CPU)
    PSS.scan_streamset(db, ss, [b"x stopword y", b"quiet"], [cb, None])
    assert ss.terminated[0] and len(calls) == 1
    out2 = PSS.scan_streamset(db, ss, [b"stopword again", b"other1"],
                              [cb, None])
    assert out2[0] == [] and len(calls) == 1 and out2[1][0][0] == 2
    assert PSS.scan_streamset(db, ss, [b"stopword", b"zz"])[0] == []
    empty = PSS.open_streamset(db, 0, device=CPU)
    assert PSS.scan_streamset(db, empty, []) == []
    assert PSS.close_streamset(db, empty) == []

    db.host_scan_limit = 0
    ss = PSS.open_streamset(db, 1, device=CPU)
    ext = np.frombuffer(b"stopword", np.uint8)
    for bad in (torch.zeros(8, dtype=torch.int32),
                torch.zeros(9, dtype=torch.uint8),
                torch.zeros((2, 4), dtype=torch.uint8),
                torch.zeros(8, dtype=torch.uint8, device="meta")):
        with pytest.raises(ht.InvalidError):
            PSS.streamset_write_start(db, ss, ext_np=ext, ext_t=bad,
                                      chunk_lens=np.asarray([8]))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            PSS.open_streamset(db, 1)


# --- the round's extents: one stitch from the flat histories -----------------


def _ragged_writes(rng, S, rounds, hreq):
    """Writes of mixed lengths: empty ones, ones shorter than the history
    requirement and longer ones, salted like _gen_writes'."""
    base = _gen_writes(rng, S, rounds)
    sizes = [0, 1, max(1, hreq // 2), max(1, hreq - 1), hreq + 3, 90]
    return [[(w * 4)[:sizes[int(rng.integers(0, len(sizes)))]]
             if rng.random() < 0.6 else w for w in per] for per in base]


def _hist_of(ss):
    return [bytes(h) for h in ss.hist]


@pytest.mark.parametrize("dbname", ["literal", "chains", "validators"])
@pytest.mark.parametrize("case", ["ragged", "early", "load", "in_flight3"])
def test_streamset_stitched_rounds_equal_reference(dbname, case):
    """Rounds whose extents the stitch builds from the flat histories
    equal the reference's StreamSet on the same writes, round by round,
    history by history and at the close: ragged writes (empty ones,
    ones shorter than the history requirement), early rounds whose
    history is still shorter than the requirement, a stream loaded
    mid-sequence, and three rounds started before the first finish.
    The next round's histories are copied out of the round's extents,
    so they share no memory with them."""
    rdb, pdb = _both(dbname)
    hreq = history_required(pdb)
    rng = np.random.default_rng(sum(map(ord, dbname + case)))
    S, ROUNDS = 6, 6
    if case == "early":
        writes = [[c[:int(rng.integers(0, 4))] for c in per]
                  for per in _gen_writes(rng, S, 3)]
        writes += _ragged_writes(rng, S, ROUNDS - 3, hreq)
    else:
        writes = _ragged_writes(rng, S, ROUNDS, hreq)
    assert any(len(c) == 0 for per in writes for c in per)
    assert any(0 < len(c) < hreq for per in writes for c in per)
    rss = RSS.open_streamset(rdb, S)
    pss = PSS.open_streamset(pdb, S, device=CPU)
    if case == "in_flight3":
        for r0 in range(0, ROUNDS, 3):
            rh = [RSS.streamset_write_start(rdb, rss, w)
                  for w in writes[r0:r0 + 3]]
            ph = [PSS.streamset_write_start(pdb, pss, w)
                  for w in writes[r0:r0 + 3]]
            assert all(np.shares_memory(a.ext_np, b.ext_np) is False
                       for a, b in zip(ph, ph[1:]))
            assert not any(np.shares_memory(pss.hist.buf, h.ext_np)
                           for h in ph)
            want = [RSS.streamset_write_finish(rdb, rss, h) for h in rh]
            got = [PSS.streamset_write_finish(pdb, pss, h) for h in ph]
            assert got == want, r0
            assert _hist_of(pss) == _hist_of(rss)
    else:
        for r, w in enumerate(writes):
            if case == "load" and r == 3:
                s = ht.open_stream(pdb, device=CPU)
                ht.scan_stream(s, b"zz foomark123" + bytes(hreq))
                blob = ht.compress_stream(s)
                RSS.streamset_load(rss, 2, hs.expand_stream(rdb, blob))
                PSS.streamset_load(pss, 2,
                                   ht.expand_stream(pdb, blob, device=CPU))
                assert _hist_of(pss) == _hist_of(rss)
                assert bytes(pss.hist[2]) == \
                    ht.expand_stream(pdb, blob, device=CPU).history
            h = PSS.streamset_write_start(pdb, pss, w)
            assert not np.shares_memory(pss.hist.buf, h.ext_np)
            got = PSS.streamset_write_finish(pdb, pss, h)
            assert got == RSS.scan_streamset(rdb, rss, w), r
            assert _hist_of(pss) == _hist_of(rss), r
            assert all(len(x) <= hreq for x in pss.hist)
            if case == "early" and r < 2:
                assert all(len(x) < hreq for x in pss.hist)
    for i in range(S):
        assert PSS.streamset_stream(pss, i).history == \
            RSS.streamset_stream(rss, i).history
    assert PSS.close_streamset(pdb, pss) == RSS.close_streamset(rdb, rss)


_STITCH_SHAPES = {
    "uniform": ([5] * 4, [7] * 4),
    "ragged": ([0, 3, 5, 1], [7, 0, 2, 9]),
    "empty_chunks": ([4, 4, 4], [0, 0, 0]),
    "no_history": ([0] * 5, [3, 1, 4, 1, 5]),
    "one": ([6], [11]),
    "none": ([], []),
}


@pytest.mark.parametrize("shape", sorted(_STITCH_SHAPES))
def test_stitch_equals_concatenation(shape):
    """`_stitch` writes each stream's history then its chunk, end to end,
    from the packed histories and the packed chunks: uniform and ragged
    extents, empty chunks, no histories, one stream and none."""
    hlen, clen = (np.asarray(x, dtype=np.int64)
                  for x in _STITCH_SHAPES[shape])
    rng = np.random.default_rng(len(hlen))
    hist = rng.integers(0, 256, int(hlen.sum()), dtype=np.uint8)
    blob = rng.integers(0, 256, int(clen.sum()), dtype=np.uint8)
    hoff, coff = PSS._exclusive_cumsum(hlen), PSS._exclusive_cumsum(clen)
    want = b"".join(hist[o:o + n].tobytes() + blob[c:c + m].tobytes()
                    for o, n, c, m in zip(hoff, hlen, coff, clen))
    dst = np.full(int((hlen + clen).sum()), 0xAA, dtype=np.uint8)
    PSS._stitch(dst, hist, hlen, blob, clen)
    assert dst.tobytes() == want


@pytest.mark.parametrize("shape", sorted(_STITCH_SHAPES))
@pytest.mark.parametrize("spread", [False, True])
def test_pack_equals_slices(shape, spread):
    """`_pack` copies each segment of a buffer end to end into memory of
    its own: segments at one stride (the strided copy) or scattered and
    overlapping (the gather)."""
    lens = np.asarray(_STITCH_SHAPES[shape][0], dtype=np.int64)
    S = len(lens)
    rng = np.random.default_rng(S + 10 * spread)
    off = (rng.integers(0, 40, S).astype(np.int64) if spread
           else np.arange(S, dtype=np.int64) * 9 + 2)
    buf = rng.integers(0, 256, 64, dtype=np.uint8)
    got = PSS._pack(buf, off, lens)
    assert got.tobytes() == b"".join(buf[o:o + n].tobytes()
                                     for o, n in zip(off, lens))
    assert got.dtype == np.uint8 and not np.shares_memory(got, buf)


@pytest.mark.parametrize("dbname", ["literal", "chains"])
def test_streamset_ext_np_buffer_refilled(dbname):
    """A caller of the `ext_np` form may refill its staging buffer once a
    round has finished: the next round's histories are copies, so
    rounds built in one reused buffer equal the reference's StreamSet
    on the same writes."""
    rdb, pdb = _both(dbname)
    rng = np.random.default_rng(43)
    S = 5
    writes = (_gen_writes(rng, S, 2)
              + _ragged_writes(rng, S, 3, history_required(pdb)))
    rss = RSS.open_streamset(rdb, S)
    pss = PSS.open_streamset(pdb, S, device=CPU)
    staging = np.zeros(1 << 12, dtype=np.uint8)
    for r, w in enumerate(writes):
        ext = b"".join(bytes(h) + c for h, c in zip(pss.hist, w))
        staging[:len(ext)] = np.frombuffer(ext, dtype=np.uint8)
        h = PSS.streamset_write_start(
            pdb, pss, ext_np=staging[:len(ext)],
            chunk_lens=np.asarray([len(c) for c in w], dtype=np.int64))
        got = PSS.streamset_write_finish(pdb, pss, h)
        staging[:] = 0xFF
        assert got == RSS.scan_streamset(rdb, rss, w), r
        assert _hist_of(pss) == _hist_of(rss), r
    assert PSS.close_streamset(pdb, pss) == RSS.close_streamset(rdb, rss)


def test_streamset_chunks_of_other_buffer_types():
    """Chunks that are not `bytes` (bytearray, memoryview, uint8 arrays)
    stitch like their bytes; the engines keep them as bytes, and a list
    the caller refills between a round's start and its finish does not
    reach them."""
    _r, pdb = _both("engines")
    rng = np.random.default_rng(2)
    S = 3
    writes = _gen_writes(rng, S, 3)
    a = PSS.open_streamset(pdb, S, device=CPU)
    b = PSS.open_streamset(pdb, S, device=CPU)
    kinds = (bytearray, memoryview,
             lambda c: np.frombuffer(c, dtype=np.uint8))
    for w in writes:
        mixed = [k(c) for k, c in zip(kinds, w)]
        assert PSS.scan_streamset(pdb, b, mixed) == \
            PSS.scan_streamset(pdb, a, w)
        assert _hist_of(a) == _hist_of(b)
    got = []
    for w in ([b"call 555-12", b"qab", b"x"],
              [b"12 then 555-1212", b"cd7end", b"qz7end"]):
        listed = list(w)
        h = PSS.streamset_write_start(pdb, b, listed)
        listed[:] = [bytes(len(c)) for c in w]
        got.append(PSS.streamset_write_finish(pdb, b, h))
        assert got[-1] == PSS.scan_streamset(pdb, a, w)
        assert _hist_of(a) == _hist_of(b)
    assert sum(map(len, got[-1])) >= 3
