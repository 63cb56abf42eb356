"""The port's chain resolution (runtime/lit_runtime.resolve_chains: every
chain role's DFAs packed into one table set, scanned in two passes over
all chain expressions at once) held to the JAX package on the CPU.

Block mode: exact (id, from, to) match lists of `scan_batch`, through the
port's host route and its device branch (host_scan_limit 0, the plain
versions on device="cpu") against the reference's host route, for
tests/test_chains.py's patterns and corpora, the bench formula's gate
shape `gate<id>x(ab|cd)*<word><id>end` at 0-48 pairs, leading-gap,
trailing-gap and three-role chains, many chain expressions with several
windows a block, and blocks that start with a chain's anchored role.

Stream mode: a gate plant and a class-gap plant split at every offset
across a write boundary of a StreamSet, and at several offsets across the
writes of single streams; every round's matches and the carried chain
state (`chain_state`, which stream.py builds from resolve_chains'
`chain_out` records) equal the reference's.
"""

import numpy as np
import pytest

import bench
import hyperscan_tpu as hs
import hyperscan_tpu_torch as ht
import torch_ref_native  # noqa: F401 (the reference's native build, locked)
from hyperscan_tpu.runtime import streamset as RSS
from hyperscan_tpu_torch.runtime import streamset as PSS

from test_chains import CHAIN_PATTERNS, CORPORA, LEAD_TRAIL_PATTERNS
from test_chains import _lt_corpora

CPU = "cpu"
ROUTES = ["host", "device"]


def _gates(n: int):
    """The first n gate rules of the bench formula (shape 5)."""
    pats, ids = bench._patterns(6 * n)
    return [(p, i) for p, i in zip(pats, ids) if i % 6 == 5][:n]


def _gate_plant(pat_id: int, pairs: int, rng) -> bytes:
    word = bench.WORDS[pat_id % len(bench.WORDS)]
    gap = b"".join(rng.choice([b"ab", b"cd"]) for _ in range(pairs))
    return b"gate%dx" % pat_id + gap + b"%s%dend" % (word.encode(), pat_id)


_DBS = {}


def _dbs(key, pats, ids, mode=0):
    """(reference, port) databases of the patterns, compiled once."""
    if key not in _DBS:
        kw = {"ids": ids, "mode": mode} if mode else {"ids": ids}
        ref = hs.compile_multi(pats, **kw)
        port = ht.compile_multi(pats, **kw)
        assert port.lit is not None and port.lit.chains
        _DBS[key] = (ref, port)
    return _DBS[key]


def _same_batch(key, pats, ids, blocks, route):
    ref, port = _dbs(key, pats, ids)
    want = hs.scan_batch(ref, blocks)
    saved = getattr(port, "host_scan_limit", None)
    if route == "device":
        port.host_scan_limit = 0
    try:
        got = ht.scan_batch(port, blocks, device=CPU)
    finally:
        if route == "device":
            if saved is None:
                del port.host_scan_limit
            else:
                port.host_scan_limit = saved
    assert got == want
    return got


def _noise(rng, n: int) -> bytearray:
    return bytearray((32 + rng.integers(0, 95, n)).astype(np.uint8).tobytes())


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("k", range(len(CORPORA)))
def test_chain_patterns_corpora(k, route):
    """tests/test_chains.py's patterns on each of its corpora."""
    ids = list(range(len(CHAIN_PATTERNS)))
    _same_batch("chains", CHAIN_PATTERNS, ids, [CORPORA[k]], route)


@pytest.mark.parametrize("pairs", [0, 1, 2, 7, 16, 48])
def test_gate_shape_pairs(pairs):
    """The gate shape with `pairs` (ab|cd) pairs, whole and broken, in
    blocks with several gate rules."""
    gates = _gates(12)
    pats = [p for p, _i in gates]
    ids = [i for _p, i in gates]
    rng = np.random.default_rng(pairs)
    blocks = []
    for _p, gid in gates:
        blob = _noise(rng, 400)
        good = _gate_plant(gid, pairs, rng)
        blob[20:20 + len(good)] = good
        bad = bytearray(_gate_plant(gid, pairs + 1, rng))
        bad[len(b"gate%dx" % gid)] = ord("Z")  # a broken gap
        blob[250:250 + len(bad)] = bad
        blocks.append(bytes(blob))
    got = _same_batch("gates12", pats, ids, blocks, "device")
    assert sum(len(m) for m in got) >= len(gates)


LTX_PATTERNS = LEAD_TRAIL_PATTERNS + [
    r"alpha.*beta.*gamma",                   # three roles, class gaps
    r"one11(ab|cd)*two22(ef|gh)+three33",    # three roles, two infixes
]
LTX_CORPORA = _lt_corpora() + [
    b"alpha beta gamma alphabetagamma gamma beta alpha",
    b"xx one11abtwo22efthree33 one11two22three33 one11cdtwo22ghghthree33",
]


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("k", range(len(LTX_CORPORA)))
def test_lead_trail_and_three_roles(k, route):
    """Leading-gap, trailing-gap and three-role chains."""
    ids = list(range(len(LTX_PATTERNS)))
    _same_batch("ltx", LTX_PATTERNS, ids, [LTX_CORPORA[k]], route)


@pytest.mark.parametrize("seed", [3, 8, 21])
def test_many_chains_many_windows(seed):
    """50 gate rules and class-gap chains, blocks of 20-40 plants with
    repeated rules, overlapping windows and near misses."""
    gates = _gates(50)
    extra = [r"foo[a-z]+bar", r"abc\s+def", r"head[^\n]*tail"]
    pats = [p for p, _i in gates] + extra
    ids = [i for _p, i in gates] + [1001, 1002, 1003]
    rng = np.random.default_rng(seed)
    frags = [b"fooqqbar", b"foo bar", b"abc \t def", b"head..tail",
             b"head\ntail"]
    blocks = []
    for _b in range(6):
        blob = _noise(rng, 3000)
        for _k in range(int(rng.integers(20, 41))):
            if rng.integers(0, 4):
                gid = gates[int(rng.integers(0, len(gates)))][1]
                f = _gate_plant(gid, int(rng.integers(0, 9)), rng)
                if not rng.integers(0, 5):
                    f = f[:-2]  # a near miss
            else:
                f = frags[int(rng.integers(0, len(frags)))]
            off = int(rng.integers(0, len(blob) - len(f)))
            blob[off:off + len(f)] = f
        blocks.append(bytes(blob))
    got = _same_batch("many", pats, ids, blocks, "device")
    assert sum(len(m) for m in got) >= 20


ANCH_PATTERNS = [r"^hdr.*end", r"^gate7x(ab|cd)*door7end", r"hdr[a-z]+tail"]
ANCH_DATA = [b"hdr x end", b"hdrqqtail end", b"gate7xabdoor7end hdr end"]


@pytest.mark.parametrize("route", ROUTES)
def test_anchored_role_block_starts(route):
    """Blocks that start with the anchored role and blocks that start a
    byte later (no anchored match there)."""
    blocks = []
    for d in ANCH_DATA:
        blocks += [d, b"." + d, d + b" " + d]
    got = _same_batch("anch", ANCH_PATTERNS, [1, 2, 3], blocks, route)
    assert got[0] and not [m for m in got[1] if m[0] in (1, 2)]


def test_anchored_role_stream_writes():
    """In a stream only the first write starts anchored: a later write
    that starts with the anchored role's bytes matches nothing of it."""
    ref, port = _dbs("anch_s", ANCH_PATTERNS, [1, 2, 3], hs.HS_MODE_STREAM)
    for d in ANCH_DATA:
        rs = hs.open_stream(ref)
        ps = ht.open_stream(port, device=CPU)
        for w in (d, d, b"x" + d):
            assert ht.scan_stream(ps, w) == hs.scan_stream(rs, w)
        assert ht.close_stream(ps) == hs.close_stream(rs)


# --- streaming: carried chain state -----------------------------------------

STREAM_PATTERNS = [r"gate5x(ab|cd)*union5end", r"foo[a-z]+bar",
                   r"lead\d{4,}tail", r"hdr[^\n]{40,}stop.*",
                   r"[a-z]{40,}END7"]
STREAM_IDS = [5, 6, 7, 8, 9]
GATE = b"gate5x" + b"abcd" * 12 + b"union5end"  # longer than the history
CLASS = b"foo" + b"q" * 30 + b"bar"


def _norm_state(state):
    return sorted((k, (list(map(int, v[0])), int(v[1])))
                  for k, v in state.items())


@pytest.mark.parametrize("plant", ["gate", "class"])
def test_streamset_split_at_every_offset(plant):
    """Flow i carries the plant cut at offset i across its first write
    boundary; every round's matches and the carried chain state equal
    the reference's."""
    ref, port = _dbs("stream", STREAM_PATTERNS, STREAM_IDS,
                     hs.HS_MODE_STREAM)
    p = GATE if plant == "gate" else CLASS
    S = len(p) - 1
    rounds = [
        [b"..x " + p[:i] for i in range(1, len(p))],
        [p[i:] + b" y.." for i in range(1, len(p))],
        [b"tail " + p[: i % 7] for i in range(1, len(p))],
    ]
    rss = RSS.open_streamset(ref, S)
    pss = PSS.open_streamset(port, S, device=CPU)
    for r, w in enumerate(rounds):
        got = PSS.scan_streamset(port, pss, w)
        assert got == RSS.scan_streamset(ref, rss, w), r
        assert _norm_state(pss.chain_state) == _norm_state(rss.chain_state)
        if r == 1:
            assert all(any(m[0] in (5, 6) for m in g) for g in got)
    assert PSS.close_streamset(port, pss) == RSS.close_streamset(ref, rss)


@pytest.mark.parametrize("cut", [1, 5, 17, 40])
def test_single_stream_splits(cut):
    """Single streams: the gate, class-gap, leading-run and trailing-run
    plants cut across several writes at `cut`-byte steps."""
    ref, port = _dbs("stream", STREAM_PATTERNS, STREAM_IDS,
                     hs.HS_MODE_STREAM)
    data = (b"zz " + GATE + b" " + CLASS + b" lead12345678tail hdr"
            + b"x" * 50 + b"stop!!" + GATE[:20] + b" " + b"q" * 70
            + b"END7 " + b"q" * 39 + b"END7")
    rs = hs.open_stream(ref)
    ps = ht.open_stream(port, device=CPU)
    for at in range(0, len(data), cut):
        w = data[at:at + cut]
        assert ht.scan_stream(ps, w) == hs.scan_stream(rs, w), at
        assert _norm_state(ps.chain_state) == _norm_state(rs.chain_state)
    assert ht.close_stream(ps) == hs.close_stream(rs)
