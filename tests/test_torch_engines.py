"""The port's general-engine block scans against the JAX package's.

The same inputs, made from a numpy seed, go through the reference's
device functions (the DFA chunk kernel in Pallas interpret mode, the
bit-NFA through the CPU route of `nfa_scan_corpus_device`, the XLA sweep)
and the port's (their plain PyTorch versions on the CPU), and through the
two packages' `scan` / `scan_batch` with `host_scan_limit=0`, which
forces every scan onto the device path. Everything is an integer, so the
comparisons are exact; records are compared as sets.

Each case runs over several blocks: an empty one, unaligned tails,
NUL/0xFF bytes, anchored and floating entries, and at least three chunk
(or, with a small tile, NFA tile) boundaries."""

import numpy as np
import pytest

import hyperscan_tpu as hs
import hyperscan_tpu_torch as ht
import torch_ref_native  # noqa: F401 (the reference's native build, locked)
from hyperscan_tpu.database import NfaEngine as RefNfa
from hyperscan_tpu.database import compile_patterns as ref_compile
from hyperscan_tpu.grey import Grey as RefGrey
from hyperscan_tpu.ops import dfa_kernel as RDK
from hyperscan_tpu.ops import nfa_kernel as RNK
from hyperscan_tpu_torch.database import LbrEngine, NfaEngine, SomEngine
from hyperscan_tpu_torch.database import compile_patterns as port_compile
from hyperscan_tpu_torch.grey import Grey as PortGrey
from hyperscan_tpu_torch.ops import dfa_kernel as PDK
from hyperscan_tpu_torch.ops import nfa_kernel as PNK
from hyperscan_tpu_torch.ops.teddy import upload_blocks
from hyperscan_tpu_torch.tools.benchdata import NFA_ENGINES, plant_many_class

DOTALL = hs.HS_FLAG_DOTALL
SOM = hs.HS_FLAG_SOM_LEFTMOST

# one database per device route: (patterns, flags, grey tunables)
ROUTES = {
    "bounded_dfa": ([r"ab[cd]{2,6}ef", r"[0-9]{3}-[0-9]{4}",
                     r"GET /[a-z]{1,12} "], [0, 0, 0],
                    dict(allow_teddy=False)),
    "unbounded_dfa": ([r"\d+[a-z]{3,}\d+"], [DOTALL],
                      dict(allow_teddy=False)),
    "cyclic_nfa": ([r"(ax|by|cz|dw)+[!]"], [0],
                   dict(max_dfa_states=8, allow_teddy=False)),
    "acyclic_nfa": ([r".*a.{18}b"], [0], dict()),
    "eod_nfa": ([r".*x.{8}(y|z)$"], [0],
                dict(max_dfa_states=8, allow_teddy=False)),
    "wide_nfa": ([r".*a.{60}b"], [0], dict(max_dfa_states=8)),
}
# kernel D's other shapes, for the bit-NFA scan alone: 45 classes (two
# membership words a byte) and P = 502 (16 carry words a thread)
NFA_ROUTES = {f"{name}_nfa": ([pat], [0], grey)
              for name, (pat, grey) in NFA_ENGINES.items()}
PLANTS = [b"abcdef", b"abddddef", b"555-1212", b"GET /index ", b"12abc34",
          b"9zzzzzzzz8", b"axby!", b"dwcz!", b"a" + b"q" * 18 + b"b",
          b"x12345678y", b"a" + b"\x00" * 60 + b"b", b"\x00\xff"]
ALPHA = np.frombuffer(b"aabxyz0123456789-cdefGET /!axbycz\x00\xff", np.uint8)


def _compile(route, grey_extra=None):
    pats, flags, g = ROUTES[route] if route in ROUTES else NFA_ROUTES[route]
    g = dict(g, host_scan_limit=0, **(grey_extra or {}))
    ref = ref_compile(pats, flags, list(range(len(pats))), grey=RefGrey(**g))
    port = port_compile(pats, flags, list(range(len(pats))),
                        grey=PortGrey(**g))
    return ref, port


def _blocks(seed: int, sizes=(1700, 0, 1501, 7, 2600)):
    """Blocks from a numpy seed with the plants spliced in; each block
    ends with NUL/0xFF bytes where it is long enough."""
    rng = np.random.default_rng(seed)
    out = []
    for n in sizes:
        b = rng.choice(ALPHA, size=n).astype(np.uint8)
        for k in range(n // 97):
            p = np.frombuffer(PLANTS[int(rng.integers(len(PLANTS)))],
                              np.uint8)
            off = int(rng.integers(0, max(1, n - len(p))))
            b[off:off + len(p)] = p[:n - off]
        out.append(b.tobytes())
    return out


def _recs(recs):
    return set(zip(*[np.asarray(a, np.int64).tolist() for a in recs]))


def _engine(db):
    (eng,) = db.engines
    return eng


# --- (a) the bounded DFA chunk scan ------------------------------------------


@pytest.mark.parametrize("carried", [False, True])
def test_dfa_scan_corpus_equals_reference(carried):
    ref, port = _compile("bounded_dfa")
    re_, pe = _engine(ref), _engine(port)
    blocks = _blocks(1)
    anch = np.asarray([True, False, True, False, True])
    init = None
    if carried:
        init = np.random.default_rng(2).integers(
            0, pe.num_states, size=len(blocks)).astype(np.int32)
    want, wfin = RDK.dfa_scan_corpus_device(re_, blocks, anch, 1 << 14,
                                            init)
    got, gfin = PDK.dfa_scan_corpus_device(pe, blocks, anch, 1 << 14, init,
                                           device="cpu")
    assert _recs(got) == _recs(want) and len(_recs(want)) >= 10
    assert gfin.tolist() == np.asarray(wfin).tolist()
    if carried:
        assert gfin[1] == init[1]  # the empty block keeps its carried state


def test_dfa_scan_halo_zero_with_carried_states():
    """H = 0 (a depth-1 engine) with carried entry states."""
    ref = ref_compile([r"[0-9]"], [0], [0],
                      grey=RefGrey(allow_teddy=False, host_scan_limit=0))
    port = port_compile([r"[0-9]"], [0], [0],
                        grey=PortGrey(allow_teddy=False, host_scan_limit=0))
    re_, pe = _engine(ref), _engine(port)
    assert PDK.chunk_shape(pe) == (0, 512)
    blocks = _blocks(3)
    init = np.full(len(blocks), pe.start_state, np.int32)
    want, wfin = RDK.dfa_scan_corpus_device(re_, blocks,
                                            np.ones(5, bool), 1 << 14, init)
    got, gfin = PDK.dfa_scan_corpus_device(pe, blocks, np.ones(5, bool),
                                           1 << 14, init, device="cpu")
    assert _recs(got) == _recs(want) and len(_recs(want)) >= 100
    assert gfin.tolist() == np.asarray(wfin).tolist()


# --- (b) the speculative DFA -------------------------------------------------


def test_speculative_dfa_cascade_equals_reference():
    """A run inside the pattern's class crosses many chunk boundaries
    (tests/test_dfa.py:93-97): the host chain must re-sync exactly."""
    ref = hs.compile(r"q[a-y]*z", flags=DOTALL)
    port = ht.compile(r"q[a-y]*z", flags=DOTALL)
    re_, pe = _engine(ref), _engine(port)
    assert pe.max_depth is None
    d2 = b"q" + b"m" * (PDK.SPEC_CS * 20) + b"z" + b"qmz"
    blocks = [d2[:7000], d2[7000:], b"", b"qaz\x00\xffqz"]
    anch = np.asarray([True, False, True, True])
    want, wfin = RDK.dfa_scan_corpus_device_speculative(re_, blocks, anch)
    got, gfin = PDK.dfa_scan_corpus_device_speculative(pe, blocks, anch,
                                                       device="cpu")
    assert _recs(got) == _recs(want) and len(_recs(want)) >= 3
    assert gfin.tolist() == np.asarray(wfin).tolist()


def test_speculative_dfa_full_miss_equals_reference():
    """Nearly every chunk boundary sits mid-match (tests/test_dfa.py:
    141-142): speculation misses and the host rescans them."""
    ref, port = _compile("unbounded_dfa")
    re_, pe = _engine(ref), _engine(port)
    unit = b"123456789" * 40 + b"abcdefgh" * 40 + b"55"
    data = (unit * (60_000 // len(unit)))[:50_000]
    blocks = [data[:21_000], data[21_000:], b""]
    anch = np.ones(3, bool)
    want, wfin = RDK.dfa_scan_corpus_device_speculative(re_, blocks, anch)
    corpus, corpus_t, starts, lens = upload_blocks(blocks, "cpu")
    plan = PDK.plan_chunks(starts, lens, 0, PDK.SPEC_CS,
                           np.full(3, pe.start_state), pe.float_state)
    _c, _t, _a, fin = PDK._run_chunks(
        pe, corpus_t, PDK.device_tables(pe, "cpu"), plan, 0, 1 << 14, "x")
    rescanned, _extra, _f = PDK.dfa_spec_chain(pe, corpus, starts, lens,
                                               plan, fin)
    assert len(rescanned) >= 50
    got, gfin = PDK.dfa_scan_corpus_device_speculative(pe, blocks, anch,
                                                       device="cpu")
    assert _recs(got) == _recs(want) and len(_recs(want)) > 50
    assert gfin.tolist() == np.asarray(wfin).tolist()


# --- (c) the speculative NFA -------------------------------------------------


def test_speculative_nfa_equals_reference():
    ref, port = _compile("cyclic_nfa")
    re_, pe = _engine(ref), _engine(port)
    assert not pe.acyclic and pe.spec_dfa is not None
    rng = np.random.default_rng(17)
    blocks = []
    for n in (3000, 0, 2100, 9):
        blob = bytearray(rng.choice(ALPHA, size=n).tobytes())
        for _ in range(n // 60):
            frag = b"ax" * int(rng.integers(0, 40)) + b"by!"
            off = int(rng.integers(0, max(1, n - len(frag))))
            blob[off:off + len(frag)] = frag[:n - off]
        blocks.append(bytes(blob))
    anch = np.asarray([True, True, False, True])
    (wd, wh, wfin) = RDK.nfa_scan_corpus_device_speculative(re_, blocks,
                                                            anch)
    (gd, gh, gfin) = PDK.nfa_scan_corpus_device_speculative(
        pe, blocks, anch, device="cpu")
    assert _recs(gd) == _recs(wd) and len(_recs(wd)) >= 10

    def host(recs):
        return {(b, int(p), int(v)) for (b, pp, vv) in recs
                for p, v in zip(pp, vv)}

    assert host(gh) == host(wh) and host(wh)  # some chunks rescanned
    assert [int(f) for f in gfin] == [int(f) for f in wfin]


# --- (d) the layered bit-NFA -------------------------------------------------


@pytest.mark.parametrize("route", ["acyclic_nfa", "eod_nfa", "wide_nfa",
                                   "many_class_nfa", "p502_nfa"])
def test_nfa_scan_corpus_equals_reference(route, monkeypatch):
    ref, port = _compile(route)
    re_ = next(e for e in ref.engines if isinstance(e, RefNfa))
    pe = next(e for e in port.engines if isinstance(e, NfaEngine))
    assert PNK.nfa_device_eligible(pe) and RNK.nfa_device_eligible(re_)
    plan = PNK.device_plan(pe, "cpu")
    # tiles of 256 bytes: many tile boundaries in the plain version
    monkeypatch.setattr(PNK, "_PLAIN_TILE_BUDGET",
                        256 * (plan.P + plan.K + 8))
    assert PNK._tile(plan) == 256
    if route in ("wide_nfa", "p502_nfa"):
        assert pe.num_positions > 48
    if route == "many_class_nfa":
        assert plan.K > 32
    blocks = _blocks(5, sizes=(1700, 0, 1501, 1, 2600, 33))
    if route == "many_class_nfa":
        for k in (0, 2, 4):
            blocks[k] = plant_many_class(blocks[k], 40, 331)
    # EOD accepts at the ends of three blocks
    for k in (0, 4, 5):
        blocks[k] = blocks[k][:-10] + b"x\xff2345678z"
    anch = np.asarray([True, False, True, True, False, True])
    want, weod = RNK.nfa_scan_corpus_device(re_, blocks, anch)
    got, geod = PNK.nfa_scan_corpus_device(pe, blocks, anch, device="cpu")
    assert _recs(got) == _recs(want)
    assert geod.tolist() == np.asarray(weod).tolist()
    if route == "eod_nfa":
        assert np.count_nonzero(weod) == 3
    else:
        assert len(_recs(want)) >= 5


# --- (e) the API: every route, prefilter gating, host engines ----------------


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_scan_batch_equals_reference(route):
    ref, port = _compile(route)
    blocks = _blocks(7)
    for k in (0, 4):  # EOD accepts
        blocks[k] = blocks[k][:-10] + b"x\xff2345678z"
    want = hs.scan_batch(ref, blocks)
    assert ht.scan_batch(port, blocks, device="cpu") == want
    assert sum(map(len, want)) >= 2
    data = b"".join(blocks)
    assert ht.scan(port, data, device="cpu") == hs.scan(ref, data)


def _pair(pats, flags):
    ids = list(range(len(pats)))
    return (ref_compile(pats, flags, ids, grey=RefGrey(host_scan_limit=0)),
            port_compile(pats, flags, ids, grey=PortGrey(host_scan_limit=0)))


def test_prefilter_gated_engines_equal_reference():
    """Engines whose every expression is literal-prefilter gated scan only
    the blocks where a mandatory factor hit."""
    pats = [r"attack\d+[a-z]*x.*y", r"login[0-9]{2}.{30}b", "plainword"]
    ref, port = _pair(pats, [0, 0, 0])
    (eng,) = port.engines
    from hyperscan_tpu_torch.runtime.scan import _lit_prefilter_eids

    assert port.lit is not None and eng.eids() <= _lit_prefilter_eids(
        port.lit)
    hits = [b"xx attack12abcx yy y", b"login12" + b"q" * 30 + b"b",
            b"plainword", b"attack1 no close", b""]
    blocks = _blocks(9) + hits
    want = hs.scan_batch(ref, blocks)
    assert ht.scan_batch(port, blocks, device="cpu") == want
    assert sum(map(len, want[-5:])) >= 3


def test_host_engines_equal_reference():
    """SOM and LBR engines stay on the host in both packages, beside a
    device DFA and a literal."""
    pats = [r"[a-c]+x\d", r"z{40,}", r"[0-9]{3}-[0-9]{4}", "attack"]
    ref, port = _pair(pats, [SOM, 0, 0, 0])
    kinds = {type(e) for e in port.engines}
    assert SomEngine in kinds and LbrEngine in kinds
    blocks = _blocks(11) + [b"abcax7 " + b"z" * 45 + b" 555-1234 attack",
                            b"z" * 41]
    want = hs.scan_batch(ref, blocks)
    assert ht.scan_batch(port, blocks, device="cpu") == want
    assert sum(map(len, want)) >= 5


# --- (f) overflowing capacities ----------------------------------------------


def test_capacity_one_returns_every_record():
    _ref, port = _compile("bounded_dfa")
    _r2, nport = _compile("acyclic_nfa")
    blocks = _blocks(13)
    anch = np.ones(len(blocks), bool)
    for mod, db, fn in ((PDK, port, "dfa_scan_corpus_device"),
                        (PNK, nport, "nfa_scan_corpus_device")):
        eng = next(e for e in db.engines
                   if not isinstance(e, (SomEngine, LbrEngine)))
        roomy, fin_r = getattr(mod, fn)(eng, blocks, anch, 1 << 14,
                                        device="cpu")
        eng.__dict__.pop("_torch_cap_hints", None)
        tight, fin_t = getattr(mod, fn)(eng, blocks, anch, 1, device="cpu")
        assert _recs(tight) == _recs(roomy) and len(_recs(roomy)) >= 10
        assert fin_t.tolist() == fin_r.tolist()
