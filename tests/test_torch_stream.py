"""The port's streaming runtime against the JAX package's
(hyperscan_tpu_torch.runtime.stream vs hyperscan_tpu.runtime.stream).

Mirrors tests/test_stream.py: both packages compile the same patterns and
take the same writes; the port's streams scan on the CPU (device="cpu",
its plain PyTorch versions), the reference as its own tests run it
(Pallas in interpret mode, XLA on the CPU). Match lists, EOD reports and
compressed stream states are compared exactly, the states byte for byte
in both directions. Also held: stream == block and vectored == block in
the port, the large-write device routes (host_scan_limit lowered), the
wide-infix split write of tests/test_chains.py, scan_streams over an
8-shard CPU mesh against the reference's 8-device mesh, and the stream
entry points' device rules.
"""

import numpy as np
import pytest
import torch

import hyperscan_tpu as hs
import hyperscan_tpu_torch as ht
import torch_ref_native  # noqa: F401 (the reference's native build, locked)

from hyperscan_tpu.database import compile_patterns as ref_compile
from hyperscan_tpu.grey import Grey as RefGrey
from hyperscan_tpu_torch.database import compile_patterns as port_compile
from hyperscan_tpu_torch.grey import Grey as PortGrey
from hyperscan_tpu_torch.runtime.stream import Stream

CPU = "cpu"

PATTERNS = [
    (r"attack", 0),
    (r"error|warning", 0),
    (r"admin[0-9]{1,3}", 0),
    (r"^root:x", 0),
    (r"passwd$", 0),
    (r"\bshell\b", 0),
    (r"foo[a-z]+bar", 0),          # general path (unbounded gap)
    (r"[0-9]{3}-[0-9]{4}", 0),     # general path (no factor)
    (r"xyz\z", 0),
]

CORPORA = [
    b"",
    b"attack",
    b"attack at dawn; warning: error in passwd",
    b"root:x:0:0 admin77 shell 555-1212 foozzzbar xyz",
    b"passwd\npasswd",
    b"sh" + b"e" * 40 + b"ll shell",
    b"a" * 300 + b"attack" + b"b" * 300,
    b"xyz xyz",
]

# databases whose stream state holds every codec field: chain evidence
# (class gaps, a general infix), SOM engine registers and deferred
# EOD-capable SOM reports, SINGLEMATCH and combination state
CODEC_SETS = {
    "mixed": ([p for p, _f in PATTERNS], [f for _p, f in PATTERNS]),
    "chains": ([r"foomark[0-9]{3,9}barmark", r"lead\d{4,}tail",
                r"fooseg(ab|cd)*barseg"], [0, 0, 0]),
    "som": ([r"num[0-9]{2,5}x", r"a[0-9]*$", "plainlit"],
            [ht.HS_FLAG_SOM_LEFTMOST] * 3),
    "single": (["dup", r"v[0-9]ral"], [ht.HS_FLAG_SINGLEMATCH, 0]),
}


def _both(pats, flags, mode, grey=None):
    ids = list(range(len(pats)))
    ref = ref_compile(pats, flags, ids, mode, grey=RefGrey(**(grey or {})))
    port = port_compile(pats, flags, ids, mode,
                        grey=PortGrey(**(grey or {})))
    return ref, port


def _splits(data, rng):
    yield [data]
    if len(data) > 1:
        for _ in range(3):
            k = rng.integers(1, min(5, len(data)) + 1)
            cuts = sorted(rng.choice(len(data), size=k,
                                     replace=False).tolist())
            parts, prev = [], 0
            for c in cuts + [len(data)]:
                parts.append(data[prev:c])
                prev = c
            yield parts


@pytest.fixture(scope="module")
def dbs():
    exprs = [p for (p, _f) in PATTERNS]
    flags = [f for (_p, f) in PATTERNS]
    return {mode: _both(exprs, flags, mode)
            for mode in (hs.HS_MODE_BLOCK, hs.HS_MODE_STREAM,
                         hs.HS_MODE_VECTORED)}


def _ref_stream(sdb, parts):
    st = hs.open_stream(sdb)
    ms = []
    for p in parts:
        ms.extend(hs.scan_stream(st, p))
    return ms + hs.close_stream(st)


def _port_stream(sdb, parts):
    st = ht.open_stream(sdb, device=CPU)
    ms = []
    for p in parts:
        ms.extend(ht.scan_stream(st, p))
    return ms + ht.close_stream(st)


def test_stream_and_vectored_equal_block_and_reference(dbs):
    """Mirror of test_stream.py:72 and :85: each split of each corpus
    gives the port's block matches through its streams and its vectored
    scan, and the reference's stream and vectored match lists exactly."""
    (_rb, pb), (rs, ps), (rv, pv) = (dbs[m] for m in (
        hs.HS_MODE_BLOCK, hs.HS_MODE_STREAM, hs.HS_MODE_VECTORED))
    rng = np.random.default_rng(42)
    for data in CORPORA:
        want = {(m, t) for (m, _f, t) in ht.scan(pb, data, device=CPU)}
        for parts in _splits(data, rng):
            got = _port_stream(ps, parts)
            assert {(m, t) for (m, _f, t) in got} == want, (data, parts)
            assert got == _ref_stream(rs, parts), (data, parts)
            vec = ht.scan_vector(pv, parts, device=CPU)
            assert {(m, t) for (m, _f, t) in vec} == want, (data, parts)
            assert vec == hs.scan_vector(rv, parts)


def _codec_writes(rng, n_writes):
    frags = [b"foomark1234", b"5678barmark", b"lead12345", b"678tail",
             b"foosegabcd", b"abbarseg", b"num123", b"x", b"a1234",
             b"plainlit", b"dup", b"v7ral", b"attack", b"admin12",
             b"root:x", b"passwd", b"foozzbar", b"555-12", b"34"]
    out = []
    for _ in range(n_writes):
        n = int(rng.integers(0, 40))
        c = bytearray((32 + rng.integers(0, 95, size=n)).astype(np.uint8))
        for _k in range(int(rng.integers(0, 3))):
            f = frags[int(rng.integers(0, len(frags)))]
            c += f
        out.append(bytes(c))
    return out


@pytest.mark.parametrize("name", sorted(CODEC_SETS))
def test_compressed_state_crosses_packages(name):
    """After the same writes, the port's compress_stream bytes equal the
    reference's (STREAM_MAGIC HSTPUST5), write by write; each package
    expands the other's buffer and goes on exactly as the original."""
    pats, flags = CODEC_SETS[name]
    rdb, pdb = _both(pats, flags, hs.HS_MODE_STREAM)
    rng = np.random.default_rng(len(name))
    writes = _codec_writes(rng, 8)
    rs, ps = hs.open_stream(rdb), ht.open_stream(pdb, device=CPU)
    for k, w in enumerate(writes):
        assert ht.scan_stream(ps, w) == hs.scan_stream(rs, w), (name, k)
        rb, pbuf = hs.compress_stream(rs), ht.compress_stream(ps)
        assert pbuf == rb, (name, k)
        if k % 3 == 2:
            # swap: each package continues from the other's bytes
            rs = hs.expand_stream(rdb, pbuf)
            ps = ht.expand_stream(pdb, rb, device=CPU)
    assert ht.close_stream(ps) == hs.close_stream(rs)


def test_reset_expand_copy_equal_reference(dbs):
    """Mirror of test_stream.py:107, :140 and :151: reset_and_expand
    (with and without a callback), copy and reset give the reference's
    match lists."""
    rs_db, ps_db = dbs[hs.HS_MODE_STREAM]
    data = b"attack at dawn; warning: error in passwd"
    outs = []
    for mod, db, kw in ((hs, rs_db, {}), (ht, ps_db, {"device": CPU})):
        st = mod.open_stream(db, **kw)
        mod.scan_stream(st, data[:15])
        buf = mod.compress_stream(st)
        victim = mod.open_stream(db, **kw)
        mod.scan_stream(victim, b"root passwd")
        eod = []
        got_eod = mod.reset_and_expand_stream(
            victim, buf, lambda e, f, t, fl: eod.append((e, f, t)))
        rest = mod.scan_stream(victim, data[15:]) + mod.close_stream(victim)
        v2 = mod.open_stream(db, **kw)
        mod.scan_stream(v2, b"root passwd")
        quiet = mod.reset_and_expand_stream(v2, buf)
        st = mod.open_stream(db, **kw)
        mod.scan_stream(st, b"atta")
        st2 = mod.copy_stream(st)
        a = mod.scan_stream(st, b"ck") + mod.close_stream(st)
        b = mod.scan_stream(st2, b"ck") + mod.close_stream(st2)
        st3 = mod.open_stream(db, **kw)
        mod.scan_stream(st3, b"attack")
        mod.reset_stream(st3)
        r = mod.scan_stream(st3, b"^^attack") + mod.close_stream(st3)
        to = mod.open_stream(db, **kw)
        mod.scan_stream(to, b"passwd")
        rc_eod = mod.reset_and_copy_stream(to, mod.copy_stream(v2),
                                           lambda *x: 0)
        rc = mod.scan_stream(to, data[15:]) + mod.close_stream(to)
        outs.append((got_eod, eod, rest, quiet, a, b, r, rc_eod, rc))
    assert outs[0] == outs[1]
    got_eod, eod, _rest, quiet, a, b, r, _rc_eod, _rc = outs[1]
    assert got_eod == eod and (4, 0, 11) in eod and quiet == []
    assert a == b and any(m[0] == 0 for m in a) and (0, 0, 8) in r


def test_singlematch_termination_and_modes():
    """Mirror of test_stream.py:160, :173 and :182."""
    rdb, pdb = _both([r"attack"], [hs.HS_FLAG_SINGLEMATCH],
                     hs.HS_MODE_STREAM)
    want = []
    rs = hs.open_stream(rdb)
    for w in (b"attack attack ", b"attack"):
        want += hs.scan_stream(rs, w)
    want += hs.close_stream(rs)
    st = ht.open_stream(pdb, device=CPU)
    got = ht.scan_stream(st, b"attack attack ") + ht.scan_stream(st, b"attack")
    assert got + ht.close_stream(st) == want == [(0, 0, 6)]

    st = ht.open_stream(pdb, device=CPU)
    ht.scan_stream(st, b"attack", lambda i, f, t, fl: 1)
    assert st.terminated
    from hyperscan_tpu_torch.errors import ScanTerminated

    with pytest.raises(ScanTerminated):
        ht.scan_stream(st, b"more")

    _rb, bdb = _both(["attack"], [0], hs.HS_MODE_BLOCK)
    _rv, vdb = _both(["attack"], [0], hs.HS_MODE_VECTORED)
    with pytest.raises(ht.DbModeError):
        ht.open_stream(bdb, device=CPU)
    with pytest.raises(ht.DbModeError):
        ht.scan(pdb, b"data", device=CPU)
    with pytest.raises(ht.DbModeError):
        ht.scan_vector(pdb, [b"data"], device=CPU)
    assert ht.scan_vector(vdb, [b"att", b"ack"], device=CPU) == [(0, 0, 6)]


def test_batched_scan_streams_equal_reference(dbs):
    """Mirror of test_stream.py:192, also with threads=2."""
    rdb, pdb = dbs[hs.HS_MODE_STREAM]
    chunk1 = [b"atta", b"warn", b"admin", b"root", b"pass", b"xy"]
    chunk2 = [b"ck", b"ing!", b"77 go", b":x:0", b"wd", b"z"]
    rst = [hs.open_stream(rdb) for _ in chunk1]
    want = [hs.scan_streams(rdb, rst, c) for c in (chunk1, chunk2)]
    want.append([hs.close_stream(s) for s in rst])
    for threads in (1, 2):
        pst = [ht.open_stream(pdb, device=CPU) for _ in chunk1]
        got = [ht.scan_streams(pdb, pst, c, threads=threads)
               for c in (chunk1, chunk2)]
        got.append([ht.close_stream(s) for s in pst])
        assert got == want


@pytest.mark.parametrize("case", ["chain_trimmed", "zero_length",
                                  "vacuous_empty"])
def test_boundary_regressions_equal_reference(case):
    """Mirror of test_stream.py:216, :239 and :247: chain evidence whose
    prefix left the history, zero-length writes that keep the boundary
    dedupe, and an empty first write of a vacuous pattern."""
    if case == "chain_trimmed":
        pats, flags = [r"foo.*bar"], [0]
        splits = [[b"foo" + b"z" * k, b"bar"] for k in range(14)]
    elif case == "zero_length":
        pats, flags = [r"abcdef"], [0]
        splits = [[b"xxabcdef", b"", b""]]
    else:
        pats, flags = [r"x*"], [hs.HS_FLAG_ALLOWEMPTY]
        splits = [[b"ab"], [b"", b"ab"], [b"", b"", b"ab"]]
    rdb, pdb = _both(pats, flags, hs.HS_MODE_STREAM)
    for parts in splits:
        assert _port_stream(pdb, parts) == _ref_stream(rdb, parts), parts


def _random_parts(seed, sizes, plants):
    rng = np.random.default_rng(seed)
    parts = []
    for size in sizes:
        c = (32 + rng.integers(0, 95, size=size)).astype(np.uint8)
        i = int(rng.integers(0, size - 30))
        c[i:i + 8] = np.frombuffer(plants, np.uint8)
        parts.append(c.tobytes())
    return parts


def test_large_writes_literal_device_path():
    """Mirror of test_stream.py:259 with host_scan_limit lowered: writes
    above it take the literal device path (the port's plain kernels on
    the CPU, the reference's interpret mode) and equal the reference and
    the port's block scan."""
    pats = ["attack" + str(i) for i in range(60)] + [r"foo.*bar"]
    grey = {"host_scan_limit": 4096}
    rdb, pdb = _both(pats, [0] * 61, hs.HS_MODE_STREAM, grey)
    _rb, bdb = _both(pats, [0] * 61, hs.HS_MODE_BLOCK)
    parts = _random_parts(4, (500, 20_000, 120, 16_000), b"attack5 ")
    parts[1] = parts[1][:1000] + b"foo" + parts[1][1000:]
    parts[3] = b"bar " + parts[3]
    got = _port_stream(pdb, parts)
    assert got == _ref_stream(rdb, parts)
    want = ht.scan(bdb, b"".join(parts), device=CPU)
    assert sorted((m[0], m[2]) for m in got) == \
        sorted((m[0], m[2]) for m in want)
    assert len(got) >= 4


@pytest.mark.parametrize("case", ["bounded", "unbounded"])
def test_large_writes_engine_device_path(case):
    """Mirror of test_stream.py:288 (a bounded DFA: the chunk-halo kernel
    entered in the carried states) and :323 (an unbounded DFA: the
    speculative kernel), host_scan_limit lowered: the port's plain
    kernels equal the reference and the port's block scan."""
    if case == "bounded":
        pat, flags = r"[0-9]{6}[a-f]", 0
        rng = np.random.default_rng(7)
        data = bytes(rng.choice(np.frombuffer(b"0123abgh ", np.uint8),
                                size=6000))
        data = data[:2997] + b"456789c" + data[3004:]
        parts = [data[:3000], data[3000:]]
    else:
        pat, flags = r"q[a-y]*z", hs.HS_FLAG_DOTALL
        rng = np.random.default_rng(1)
        parts = [b"q" + b"m" * 3000,
                 b"m" * 2000 + b"z"
                 + bytes(rng.integers(65, 90, 3000, dtype=np.uint8))]
    rdb, pdb = _both([pat], [flags], hs.HS_MODE_STREAM,
                     {"host_scan_limit": 1024})
    assert pdb.engines and not pdb.lit
    assert (pdb.engines[0].max_depth is not None) == (case == "bounded")
    _rb, bdb = _both([pat], [flags], hs.HS_MODE_BLOCK)
    got = _port_stream(pdb, parts)
    assert got == _ref_stream(rdb, parts)
    want = ht.scan(bdb, b"".join(parts), device=CPU)
    assert sorted(got) == sorted(want) and want


def test_wide_infix_split_write_equals_reference():
    """The wide-infix split write of tests/test_chains.py (commit
    53b41dd): a write boundary inside the last alternation token leaves
    a carried infix mask wider than int64; through scan_stream, the
    codec (bytes equal to the reference's) and the StreamSet path."""
    from hyperscan_tpu.runtime import streamset as RSS
    from hyperscan_tpu_torch.runtime import streamset as PSS

    alts = "|".join(f"tok{i:02d}" for i in range(16))
    rdb, pdb = _both([f"foomark({alts})*barmark"], [0], hs.HS_MODE_STREAM)
    assert len(pdb.lit.chains[0].infix[0].follow) - 1 > 62
    outs, bufs = [], []
    for mod, db, kw in ((hs, rdb, {}), (ht, pdb, {"device": CPU})):
        st = mod.open_stream(db, **kw)
        out = mod.scan_stream(st, b"x" * 40 + b"foomarktok15tok1")
        bufs.append(mod.compress_stream(st))
        st2 = mod.expand_stream(db, bufs[-1], **kw)
        out += mod.scan_stream(st2, b"5tok1")
        out += mod.scan_stream(st2, b"4barmark zz")
        outs.append(out + mod.close_stream(st2))
    assert outs[0] == outs[1] and any(m[0] == 0 for m in outs[1])
    assert bufs[0] == bufs[1]
    writes = [[b"y" * 20 + b"foomarktok15tok1", b"noise only here...."],
              [b"5tok15tok1", b"more noise.........."],
              [b"5barmark!!", b"...................."]]
    rss = RSS.open_streamset(rdb, 2)
    pss = PSS.open_streamset(pdb, 2, device=CPU)
    got = [PSS.scan_streamset(pdb, pss, w) for w in writes]
    assert got == [RSS.scan_streamset(rdb, rss, w) for w in writes]
    assert sum(len(m) for r in got for m in r) >= 1


def test_scan_streams_on_cpu_mesh_equals_reference_mesh():
    """Mirror of tests/test_parallel.py:196: scan_streams(mesh=) over an
    8-shard CPU mesh equals the unsharded port and the reference's
    8-device mesh, chain evidence carried across writes included."""
    from hyperscan_tpu.parallel.sharded import make_mesh as ref_mesh
    from hyperscan_tpu_torch.parallel import make_mesh

    pats = ["attack" + str(i) for i in range(30)] + [r"foo.*bar"]
    rdb, pdb = _both(pats, [0] * 31, hs.HS_MODE_STREAM)
    rng = np.random.default_rng(5)
    S = 11
    writes = []
    for r in range(3):
        ws = []
        for s in range(S):
            c = (32 + rng.integers(0, 95, size=10_000)).astype(np.uint8)
            if (r + s) % 3 == 0:
                c[50:58] = np.frombuffer(b"attack7 ", np.uint8)
            if s == 2 and r == 0:
                c[100:103] = np.frombuffer(b"foo", np.uint8)
            if s == 2 and r == 2:
                c[200:203] = np.frombuffer(b"bar", np.uint8)
            ws.append(c.tobytes())
        writes.append(ws)

    def run(mod, db, mesh, **kw):
        sts = [mod.open_stream(db, **kw) for _ in range(S)]
        out = [mod.scan_streams(db, sts, w, mesh=mesh) for w in writes]
        return out + [[mod.close_stream(s) for s in sts]]

    want = run(hs, rdb, ref_mesh(8))
    assert run(ht, pdb, make_mesh(8, device=CPU), device=CPU) == want
    assert run(ht, pdb, None, device=CPU) == want
    assert sum(len(m) for r in want for m in r) >= 8


def test_stream_device_rules():
    """Streams run on the card by default and raise without one; a write
    over streams of several devices raises; a mesh with another explicit
    device raises."""
    from hyperscan_tpu_torch.parallel import make_mesh

    pdb = port_compile(["attack"], [0], [0], hs.HS_MODE_STREAM)
    vdb = port_compile(["attack"], [0], [0], hs.HS_MODE_VECTORED)
    if not torch.cuda.is_available():
        for call in (lambda: ht.open_stream(pdb),
                     lambda: ht.scan_vector(vdb, [b"attack"]),
                     lambda: ht.expand_stream(pdb, ht.compress_stream(
                         ht.open_stream(pdb, device=CPU)))):
            with pytest.raises(RuntimeError, match="cuda"):
                call()
    a = ht.open_stream(pdb, device=CPU)
    assert a.device == torch.device("cpu")
    b = Stream(db=pdb, device=torch.device("meta"))
    b._init_states()
    with pytest.raises(ht.InvalidError, match="different devices"):
        ht.scan_streams(pdb, [a, b], [b"x", b"y"])
    with pytest.raises(ht.InvalidError, match="different devices"):
        ht.scan_streams(pdb, [a], [b"x"], device="meta")
    with pytest.raises(ht.InvalidError):
        ht.scan_streams(pdb, [a], [b"x" * 70_000],
                        mesh=make_mesh(2, device=CPU), threads=2)
    assert ht.scan_streams(pdb, [a], [b"attack"],
                           mesh=make_mesh(2, device=CPU)) == [[(0, 0, 6)]]
