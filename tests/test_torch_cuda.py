"""The port's CUDA kernels on the card, against their plain PyTorch
versions, and the port's scan on the card against its scan on the CPU.

Every test here needs a CUDA card and skips where there is none. This
file imports neither JAX nor the JAX package, so it also runs on a
machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Every value is an integer, so equality is exact."""

import numpy as np
import pytest
import torch

import hyperscan_tpu_torch as ht
from hyperscan_tpu_torch.database import compile_patterns
from hyperscan_tpu_torch.grey import Grey
from hyperscan_tpu_torch.ops import teddy as T

PATS = (["attack%d" % i for i in range(30)]
        + [r"payload%d[0-9]{2,4}z" % i for i in range(20)]
        + [r"q%dh[a-f0-9]{8}" % i for i in range(20)]
        + [r"\x00\x00ab%d" % i for i in range(5)]
        + [r"\xff\xfezz%d" % i for i in range(5)])
PLANT = b" attack7 payload12345z q3hdeadbeef \x00\x00ab3 \xff\xfezz4 "


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _corpus(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    c = rng.integers(0, 256, size=n).astype(np.uint8)
    c[rng.random(n) < 0.5] = ord("a")
    p = np.frombuffer(PLANT, np.uint8)
    for off in range(0, n - len(p), 9973):
        c[off:off + len(p)] = p
    return c


@pytest.mark.cuda
@pytest.mark.parametrize("use_classes", [True, False])
@pytest.mark.parametrize("n", [(1 << 20) + 13, 100, 0])
def test_filter_compact_kernel_equals_plain(card, use_classes, n):
    db = ht.compile_multi(PATS, ids=list(range(len(PATS))))
    ft, _ct = T.device_tables(db.lit, card)
    corpus = torch.from_numpy(_corpus(n, 1)).to(card)
    for capc in (1, 128):
        pos_k, cnt_k = T.filter_compact(corpus, ft, capc,
                                        use_classes=use_classes)
        pos_p, cnt_p = T.filter_compact_plain(corpus, ft, capc,
                                              use_classes=use_classes)
        assert torch.equal(cnt_k, cnt_p)
        valid = (torch.arange(capc, device=card)[None, :]
                 < cnt_p.clamp(max=capc)[:, None])
        assert torch.equal(pos_k[valid], pos_p[valid])


@pytest.mark.cuda
def test_hash_confirm_kernel_equals_plain(card):
    db = ht.compile_multi(PATS, ids=list(range(len(PATS))))
    ft, ct = T.device_tables(db.lit, card)
    corpus = torch.from_numpy(_corpus(1 << 20, 2)).to(card)
    pos_c, cnt = T.filter_compact_plain(corpus, ft, 4096, use_classes=True)
    _meta, pos = T.compact_combine(pos_c, cnt, 4096, 1 << 16)
    for cap2 in (1 << 16, 3):  # roomy, and overflowing (total stays exact)
        pairs_k, tot_k = T.hash_confirm(corpus, pos, ct, cap2)
        pairs_p, tot_p = T.hash_confirm_plain(corpus, pos, ct, cap2)
        assert int(tot_k) == int(tot_p) > 3
    k = int(tot_p)
    pairs_k, _ = T.hash_confirm(corpus, pos, ct, 1 << 16)
    pairs_p, _ = T.hash_confirm_plain(corpus, pos, ct, 1 << 16)
    assert set(map(tuple, pairs_k[:k].tolist())) == \
        set(map(tuple, pairs_p[:k].tolist()))


EDGE_PATS = [r"abc", r"wxyz1", r"0123456789", r"HeLLo", r"\x00\x00q9"]
EDGE_TOKENS = [b"abc", b"hElLo", b"wxyz1", b"0123456789", b"\x00\x00q9",
               b"z", b"1", b"a"]


@pytest.fixture
def edge(card):
    """Kernel B's edge database (tails shorter than 8 bytes, a caseless
    mask, a full 8-byte tail) and a corpus of n = 2^18 + 5 bytes (not a
    multiple of 8) with a match every few bytes and at 2, 7 and n - 1."""
    db = ht.compile_multi(EDGE_PATS, flags=[0, 0, 0, ht.HS_FLAG_CASELESS, 0],
                          ids=list(range(len(EDGE_PATS))))
    _ft, ct = T.device_tables(db.lit, card)
    n = (1 << 18) + 5
    pick = np.random.default_rng(21).integers(0, len(EDGE_TOKENS), n // 2)
    host = np.frombuffer(b"".join(EDGE_TOKENS[i] for i in pick)[:n],
                         np.uint8).copy()
    for off, lit in ((0, b"abc"), (3, b"HELLO"), (n - 5, b"wxyz1")):
        host[off:off + len(lit)] = np.frombuffer(lit, np.uint8)
    return ct, host


def _pair_keys(pairs, k):
    return sorted(((pairs[:k, 1].long() << 20) | pairs[:k, 0]).tolist())


@pytest.mark.cuda
@pytest.mark.parametrize("start", [0, 3])  # 3: a view 3 bytes past 8
def test_hash_confirm_kernel_edges(card, edge, start):
    """Every position as a candidate (0-7 and n - 1 included) on a tensor
    that ends at n or starts off an 8-byte boundary; the same list behind
    -1s (skipped); the empty list (no launch) and a list of -1s."""
    ct, host = edge
    n = host.size
    corpus = torch.from_numpy(np.concatenate(
        [np.zeros(start, np.uint8), host])).to(card)[start:]
    every = torch.arange(n, dtype=torch.int32, device=card)
    pairs_p, tot_p = T.hash_confirm_plain(corpus, every, ct, 1 << 20)
    total = int(tot_p)
    assert total > n // 16
    assert {2, 7, n - 1} <= set(pairs_p[:total, 1].tolist())
    pairs_k, tot_k = T.hash_confirm(corpus, every, ct, 1 << 20)
    assert int(tot_k) == total
    assert _pair_keys(pairs_k, total) == _pair_keys(pairs_p, total)
    padded = torch.cat([every, torch.full((999,), -1, dtype=torch.int32,
                                          device=card)])
    pairs_c, tot_c = T.hash_confirm(corpus, padded, ct, 1 << 20)
    assert int(tot_c) == total
    assert _pair_keys(pairs_c, total) == _pair_keys(pairs_p, total)
    T.reset_launches()
    assert int(T.hash_confirm(corpus, every[:0], ct, 8)[1]) == 0
    assert T.LAUNCHES["teddy_hash_confirm"] == 0
    assert int(T.hash_confirm(corpus, torch.full_like(every, -1), ct,
                              8)[1]) == 0
    assert T.LAUNCHES["teddy_hash_confirm"] == 1


@pytest.mark.cuda
def test_hash_confirm_kernel_all_hit_and_past_cap2(card, edge):
    """A list in which every candidate hits (every lane of a warp
    appends), and cap2 below the total: the total stays exact and the
    rows kept are plain pairs."""
    ct, host = edge
    corpus = torch.from_numpy(host).to(card)
    every = torch.arange(host.size, dtype=torch.int32, device=card)
    pairs_p, tot_p = T.hash_confirm_plain(corpus, every, ct, 1 << 20)
    total = int(tot_p)
    hits = torch.unique(pairs_p[:total, 1]).int()
    pairs_h, tot_h = T.hash_confirm(corpus, hits, ct, 1 << 20)
    want_h, want_t = T.hash_confirm_plain(corpus, hits, ct, 1 << 20)
    assert int(tot_h) == int(want_t) >= hits.numel()
    assert _pair_keys(pairs_h, int(tot_h)) == _pair_keys(want_h, int(tot_h))
    small = total // 3
    pairs_k, tot_k = T.hash_confirm(corpus, every, ct, small)
    assert int(tot_k) == total
    kept = _pair_keys(pairs_k, small)
    want = _pair_keys(pairs_p, total)
    for key in set(kept):
        assert kept.count(key) <= want.count(key)


@pytest.mark.cuda
def test_hash_confirm_kernel_many_groups(card, edge):
    """More groups than the kernel stages in shared memory (1,536): the
    records are read from global memory, and every pair comes once a
    repeat of its group."""
    ct, host = edge
    corpus = torch.from_numpy(host).to(card)
    R = 1536 // len(ct.groups) + 1
    many = T.ConfirmTables(groups=ct.groups * R, meta=ct.meta.repeat(R, 1),
                           slots=ct.slots)
    cands = torch.arange(4096, dtype=torch.int32, device=card)
    want_p, want_t = T.hash_confirm_plain(corpus, cands, many, 1 << 22)
    got_p, got_t = T.hash_confirm(corpus, cands, many, 1 << 22)
    total = int(want_t)
    assert total > 0 and int(got_t) == total
    assert _pair_keys(got_p, total) == _pair_keys(want_p, total)


@pytest.mark.cuda
def test_scan_on_card_equals_cpu_and_counts_launches(card):
    db = compile_patterns(PATS, ids=list(range(len(PATS))),
                          grey=Grey(host_scan_limit=0))
    data = _corpus(300_001, 3).tobytes()
    T.reset_launches()
    got = ht.scan(db, data)  # the card, by default
    assert T.LAUNCHES["teddy_filter_compact"] >= 1
    assert T.LAUNCHES["teddy_hash_confirm"] >= 1
    assert got == ht.scan(db, data, device="cpu")
    assert len(got) >= 10


# --- the engine kernels: C (dfa_scan) and D (nfa_layered) -------------------

from hyperscan_tpu_torch.ops import dfa_kernel as DK  # noqa: E402
from hyperscan_tpu_torch.ops import nfa_kernel as NK  # noqa: E402
from hyperscan_tpu_torch.ops.teddy import flatten_blocks  # noqa: E402
from hyperscan_tpu_torch.tools.benchdata import (  # noqa: E402
    NFA_ENGINES, plant_many_class)

ENGINE_ALPHA = np.frombuffer(b"aabxyz0123456789-cdefGET /!\x00\xff", np.uint8)


def _engine_blocks(seed: int, sizes):
    rng = np.random.default_rng(seed)
    plants = [b"abcdef", b"555-1212", b"GET /index ", b"a" + b"q" * 60 + b"b",
              b"x12345678y", b"a" + b"q" * 18 + b"b"]
    out = []
    for n in sizes:
        b = rng.choice(ENGINE_ALPHA, size=n).astype(np.uint8)
        for _ in range(n // 300):
            p = np.frombuffer(plants[int(rng.integers(len(plants)))],
                              np.uint8)
            off = int(rng.integers(0, max(1, n - len(p))))
            b[off:off + len(p)] = p[:n - off]
        out.append(b.tobytes())
    return out


def _sorted_rows(recs, total, width):
    r = recs[:int(total)].long()
    key = r[:, 0] * 512 + r[:, 1] if width == 3 else r[:, 0]
    return r[torch.argsort(key)].cpu()


def _dfa_engine(pats, **grey):
    db = compile_patterns(pats, grey=Grey(allow_teddy=False, **grey))
    return db.engines[0]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["bounded", "halo0_carried",
                                  "bounded_global"])
def test_dfa_scan_kernel_equals_plain(card, case):
    if case == "halo0_carried":
        eng = _dfa_engine([r"[0-9]", r"[a-c]"])
    else:
        eng = _dfa_engine([r"ab[cd]{2,6}ef", r"[0-9]{3}-[0-9]{4}",
                           r"GET /[a-z]{1,12} "])
    H, CS = DK.chunk_shape(eng) if eng.max_depth else (0, DK.SPEC_CS)
    blocks = _engine_blocks(4, (300_001, 0, 77, 5000, 1 << 16))
    corpus, starts, lens = flatten_blocks(blocks)
    rng = np.random.default_rng(5)
    entry = (rng.integers(0, eng.num_states, size=len(blocks))
             if case == "halo0_carried" else np.full(len(blocks),
                                                     eng.start_state))
    if case == "halo0_carried":
        assert H == 0
    plan = DK.plan_chunks(starts, lens, H, CS, entry, eng.float_state)
    placement = "global" if case == "bounded_global" else "shared"
    out = {}
    for which, dev in (("kernel", card), ("plain", card)):
        ct = torch.from_numpy(corpus).to(dev)
        meta = torch.from_numpy(plan.meta).to(dev)
        tabs = DK.device_tables(eng, dev)
        for cap in (1 << 20, 3):  # roomy, and overflowing (total exact)
            if which == "kernel":
                recs, tot, fin = DK.dfa_scan_chunks(ct, tabs, meta, H, cap,
                                                    placement=placement)
            else:
                recs, tot, fin = DK.dfa_scan_chunks_plain(ct, tabs, meta, H,
                                                          cap)
            out[(which, cap)] = (recs, int(tot), fin.cpu())
    k_recs, k_tot, k_fin = out[("kernel", 1 << 20)]
    p_recs, p_tot, p_fin = out[("plain", 1 << 20)]
    assert k_tot == p_tot == out[("kernel", 3)][1] > 10
    assert torch.equal(k_fin, p_fin)
    assert torch.equal(_sorted_rows(k_recs, k_tot, 3),
                       _sorted_rows(p_recs, p_tot, 3))


def _chunk_route(route):
    """(DFA, H, CS) of each caller of kernel C: the bounded DFA, the
    unbounded DFA's speculative scan, a cyclic NFA's lazy-DFA core."""
    if route == "bounded":
        eng = _dfa_engine([r"ab[cd]{2,6}ef", r"[0-9]{3}-[0-9]{4}",
                           r"GET /[a-z]{1,12} "])
        return (eng, *DK.chunk_shape(eng))
    if route == "spec_dfa":
        db = compile_patterns([r"\d+[a-z]{3,}\d+"], [ht.HS_FLAG_DOTALL],
                              grey=Grey(allow_teddy=False))
        return db.engines[0], 0, DK.SPEC_CS
    db = compile_patterns([r"(ax|by|cz|dw)+[!]"],
                          grey=Grey(max_dfa_states=8, allow_teddy=False))
    return db.engines[0].spec_dfa, 0, DK.SPEC_CS


@pytest.mark.cuda
@pytest.mark.parametrize("placement", ["shared", "global"])
@pytest.mark.parametrize("route", ["bounded", "spec_dfa", "spec_nfa"])
def test_dfa_scan_routes_past_cap(card, route, placement):
    """Kernel C on every caller's DFA and both table placements, entered
    in carried (random) states over blocks with unaligned starts: the
    total stays exact at a cap below it, and the records (as a set) and
    finals equal the plain version's."""
    eng, H, CS = _chunk_route(route)
    blocks = _engine_blocks(21, (200_003, 0, 5, 4099, 70_001, 1))
    for k in range(0, len(blocks), 2):  # matches for every route
        blocks[k] = (b"12abc34 axbycz! dwdw! abdddef 555-1234 "
                     + blocks[k])
    corpus, starts, lens = flatten_blocks(blocks)
    entry = np.random.default_rng(22).integers(0, eng.num_states,
                                               len(blocks))
    plan = DK.plan_chunks(starts, lens, H, CS, entry, eng.float_state)
    ct = torch.from_numpy(corpus).to(card)
    meta = torch.from_numpy(plan.meta).to(card)
    tabs = DK.device_tables(eng, card)
    p_recs, p_tot, p_fin = DK.dfa_scan_chunks_plain(ct, tabs, meta, H,
                                                    1 << 20)
    total = int(p_tot)
    assert total > 20
    want = set(map(tuple, p_recs[:total].tolist()))
    T.reset_launches()
    for cap in (total + 1, total // 5):  # every record; past the cap
        recs, tot, fin = DK.dfa_scan_chunks(ct, tabs, meta, H, cap,
                                            placement=placement)
        assert int(tot) == total
        assert torch.equal(fin, p_fin)
        got = set(map(tuple, recs[:min(cap, total)].tolist()))
        assert len(got) == min(cap, total) and got <= want
    assert T.LAUNCHES["dfa_scan"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("placement", [None, "shared", "global"])
def test_dfa_modes_large_dfa_equal_plain(card, placement):
    """A DFA of S x C = 12,288 (past the row mode's shared-table limit,
    inside the chunk scan's): both modes of kernel C, at their default
    placement and at each forced one, equal their plain versions."""
    eng = _dfa_engine([r"a[^\n]{10}b"])
    assert eng.trans.size == 12_288
    tabs = DK.device_tables(eng, card)
    assert DK.placement_of(tabs, None, "chunks") == "shared"
    assert DK.placement_of(tabs, None, "rows") == "global"
    H, CS = DK.chunk_shape(eng)
    blocks = _engine_blocks(23, (200_003, 0, 4099, 70_001, 1))
    corpus, starts, lens = flatten_blocks(blocks)
    entry = np.random.default_rng(24).integers(0, eng.num_states,
                                               len(blocks))
    plan = DK.plan_chunks(starts, lens, H, CS, entry, eng.float_state)
    ct = torch.from_numpy(corpus).to(card)
    meta = torch.from_numpy(plan.meta).to(card)
    p_recs, p_tot, p_fin = DK.dfa_scan_chunks_plain(ct, tabs, meta, H,
                                                    1 << 20)
    total = int(p_tot)
    assert total > 20
    recs, tot, fin = DK.dfa_scan_chunks(ct, tabs, meta, H, total,
                                        placement=placement)
    assert int(tot) == total and torch.equal(fin, p_fin)
    assert set(map(tuple, recs.tolist())) == \
        set(map(tuple, p_recs[:total].tolist()))
    B, L = 64, 4099
    data = np.frombuffer(corpus[:B * L].tobytes(), np.uint8).reshape(B, L)
    d_t = torch.from_numpy(data.copy()).to(card)
    l_t = torch.full((B,), L, dtype=torch.int32, device=card)
    l_t[::7] = 1000
    a_k, f_k = D.dfa_scan_rows(tabs, int(eng.start_state), d_t, l_t,
                               placement=placement)
    a_p, f_p = D.dfa_scan_batch_plain(tabs.trans.view(tabs.S, tabs.C),
                                      tabs.b2c, tabs.accept,
                                      int(eng.start_state), d_t, l_t)
    assert torch.equal(a_k, a_p) and torch.equal(f_k, f_p)
    assert int((a_p != 0).sum()) > 20


# kernel D's cases: (pattern, block sizes)
NFA_CASES = {
    "eod": (r".*x.{8}(y|z)$", (300_001, 0, 77, 5000, 1 << 16, 1)),
    "wide": (r".*a.{60}b", (300_001, 0, 77, 5000, 1 << 16, 1)),
    "many_class": (NFA_ENGINES["many_class"][0],
                   (300_001, 0, 77, 5000, 1 << 16, 1)),
    "p502": (r".*a.{500}b", (300_001, 0, 77, 5000, 1 << 16, 1)),
    "blocks_16k": (r".*a.{18}b", (64,) * 16_384),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(NFA_CASES))
def test_nfa_layered_kernel_equals_plain(card, case):
    """Kernel D against its plain version, also past a cap below the
    record total: EOD accepts, P > 48, 45 classes (two membership words
    a byte), P = 502, and 16,384 blocks of 64 bytes (a block edge in
    every other word)."""
    pat, sizes = NFA_CASES[case]
    db = compile_patterns([pat], grey=Grey(max_dfa_states=8,
                                           allow_teddy=False))
    eng = db.engines[0]
    assert NK.nfa_device_eligible(eng)
    blocks = _engine_blocks(6, sizes)
    if case == "many_class":
        for k in (0, 3, 4):
            blocks[k] = plant_many_class(blocks[k], 100, 997)
    for k in (0, 2, 4):  # EOD accepts
        blocks[k] = blocks[k][:-10] + b"x\xff2345678z"
    corpus, starts, lens = flatten_blocks(blocks)
    anch = np.resize(np.asarray([1, 0, 1, 0, 1, 1], bool), len(blocks))
    ct = torch.from_numpy(corpus).to(card)
    plan = NK.device_plan(eng, card)
    bs, be, ba, _ne = NK.block_bounds(starts, lens, anch, card)
    out = {}
    for which, fn in (("kernel", NK.nfa_layered),
                      ("plain", NK.nfa_layered_plain)):
        for cap in (1 << 20, 3):
            recs, tot, eod = fn(ct, plan, bs, be, ba, cap)
            out[(which, cap)] = (recs, int(tot), eod.cpu())
    k_recs, k_tot, k_eod = out[("kernel", 1 << 20)]
    p_recs, p_tot, p_eod = out[("plain", 1 << 20)]
    assert k_tot == p_tot == out[("kernel", 3)][1]
    assert torch.equal(k_eod, p_eod)
    assert torch.equal(_sorted_rows(k_recs, k_tot, 2),
                       _sorted_rows(p_recs, p_tot, 2))
    if case == "eod":
        assert int((p_eod != 0).sum()) == 3
    else:
        assert p_tot > 10
    if case in ("wide", "p502"):
        assert eng.num_positions > 48
    if case == "many_class":
        assert plan.K > 32


@pytest.mark.cuda
def test_engine_scan_on_card_equals_cpu_and_counts_launches(card):
    pats = [r"ab[cd]{2,6}ef", r"\d+[a-z]{3,}\d+", r".*a.{18}b",
            r"(ax|by|cz|dw)+[!]"]
    db = compile_patterns(pats, grey=Grey(host_scan_limit=0,
                                          max_dfa_states=64))
    blocks = _engine_blocks(7, (200_001, 0, 5000, 1 << 16))
    T.reset_launches()
    got = ht.scan_batch(db, blocks)  # the card, by default
    assert T.LAUNCHES["dfa_scan"] >= 1
    assert T.LAUNCHES["nfa_layered"] >= 1
    assert got == ht.scan_batch(db, blocks, device="cpu")
    assert sum(map(len, got)) >= 10


# --- the literal families: gate (5), survivor rescan (6), kconfirm (4),
# --- plane mode and extraction (3) -----------------------------------------

from hyperscan_tpu_torch.ops import extract as X  # noqa: E402
from hyperscan_tpu_torch.ops import teddy_families as F  # noqa: E402
from hyperscan_tpu_torch.ops import teddy_gate as G  # noqa: E402
from hyperscan_tpu_torch.ops import teddy_kconfirm as K  # noqa: E402

WORDS = ["attack", "payload", "shell", "admin", "select", "union"]
GATED_PATS = [WORDS[i % 6] + str(i) + "zq" for i in range(600)]
FAMILY_KERNELS = {
    "gated": ("teddy_gate", "teddy_rescan_rows", "teddy_hash_confirm"),
    "compact": ("teddy_filter_compact", "teddy_hash_confirm"),
    "kconfirm": ("teddy_kconfirm",),
    "dense": ("teddy_filter_plane", "plane_extract", "teddy_hash_confirm"),
}


def _gated_corpus(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    c = (32 + rng.integers(0, 95, size=n)).astype(np.uint8)
    for k, off in enumerate(range(0, n - 16, 4093)):
        p = [b"attack0zq ", b"union5zq", b"payload13zq!"][k % 3]
        c[off:off + len(p)] = np.frombuffer(p, np.uint8)
    return c


def _same_cells(pos_k, cnt_k, pos_p, cnt_p, cap):
    assert torch.equal(cnt_k, cnt_p)
    valid = (torch.arange(cap, device=cnt_p.device)[None, :]
             < cnt_p.clamp(max=cap)[:, None])
    assert torch.equal(pos_k[valid], pos_p[valid])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [(1 << 20) + 13, 100, 0])
def test_gate_and_rescan_kernels_equal_plain(card, n):
    db = ht.compile_multi(GATED_PATS, ids=list(range(len(GATED_PATS))))
    ft, _ct = T.device_tables(db.lit, card)
    gt = G.device_gate_table(db.lit, card)
    corpus = torch.from_numpy(_gated_corpus(n, 1)).to(card)
    flags_k, k_k = G.gate_rows(corpus, gt)
    flags_p, k_p = G.gate_rows_plain(corpus, gt)
    assert torch.equal(flags_k, flags_p) and torch.equal(k_k, k_p)
    for capc in (1, 128):
        pos_k, cnt_k = G.rescan_rows(corpus, ft, flags_k, capc)
        pos_p, cnt_p = T.filter_compact_plain(corpus, ft, capc,
                                              use_classes=True,
                                              row_flags=flags_p)
        _same_cells(pos_k, cnt_k, pos_p, cnt_p, capc)
        # the gate is a superset: the rescan equals the full filter
        pos_a, cnt_a = T.filter_compact(corpus, ft, capc, use_classes=True)
        _same_cells(pos_k, cnt_k, pos_a, cnt_a, capc)
    if n > 1000:
        assert int(cnt_k.sum()) > 100


def _gate_case(M: int, device):
    """Gate tables of depth M over 128 classes (byte b in class b % 128)
    whose words are nonzero for about 128 x 0.006^(1/M) classes each, so
    about 0.6% of random positions pass, and a random corpus of 3 cells
    and 4,099 bytes."""
    rng = np.random.default_rng(M)
    b2c = torch.from_numpy((np.arange(256) % 128).astype(np.uint8))
    live = rng.random((M, 128)) < 0.006 ** (1 / M)
    words = rng.integers(0, 1 << 31, (M, 128)) | (1 << 30)
    gcm = np.where(live, words, 0).astype(np.int32)
    n = 3 * 65536 + 4099
    corpus = rng.integers(0, 256, n).astype(np.uint8)
    return (G.gate_tables(b2c.to(device), gcm),
            torch.from_numpy(corpus).to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("M", range(1, 9))
def test_gate_kernel_any_depth_equals_plain(card, M):
    """Kernel 5 at every suffix depth (its vectors split into 128-bit
    parts and single words in every way), on random gate words sparse
    enough that some rows stay unflagged, at a length that is neither a
    multiple of 32 nor of a cell: flags and counts equal the plain
    version's."""
    gt, corpus = _gate_case(M, card)
    n = corpus.numel()
    T.reset_launches()
    flags_k, k_k = G.gate_rows(corpus, gt)
    assert T.LAUNCHES["teddy_gate"] == 1
    flags_p, k_p = G.gate_rows_plain(corpus, gt)
    assert torch.equal(flags_k, flags_p) and torch.equal(k_k, k_p)
    flagged = int(k_p.sum())
    assert 0 < flagged < n // 128


@pytest.mark.cuda
@pytest.mark.parametrize("n", [(1 << 20) + 13, 100, 0])
def test_kconfirm_kernel_equals_plain(card, n):
    db = ht.compile_multi(PATS, ids=list(range(len(PATS))))
    ft, _ct = T.device_tables(db.lit, card)
    kt = K.confirm_planes(db.lit, card)
    assert kt is not None
    corpus = torch.from_numpy(_corpus(n, 4)).to(card)
    for use_classes in (True, False):
        out_k = K.filter_kconfirm(corpus, ft, kt, use_classes=use_classes)
        out_p = K.filter_kconfirm_plain(corpus, ft, kt,
                                        use_classes=use_classes)
        assert torch.equal(out_k[0], out_p[0])  # candidates a cell
        _same_cells(out_k[2], out_k[1], out_p[2], out_p[1], K.CAPC2)
        _same_cells(out_k[3], out_k[1], out_p[3], out_p[1], K.CAPC2)
    if n > 1000:
        assert int(out_p[1].sum()) > 10


@pytest.mark.cuda
@pytest.mark.parametrize("n", [(1 << 20) + 13, 100, 0])
def test_plane_and_extract_kernels_equal_plain(card, n):
    db = ht.compile_multi(PATS, ids=list(range(len(PATS))))
    ft, _ct = T.device_tables(db.lit, card)
    corpus = torch.from_numpy(_corpus(n, 5)).to(card)
    for use_classes in (True, False):
        plane = T.filter_plane(corpus, ft, use_classes=use_classes)
        assert torch.equal(plane, T.filter_plane_plain(
            corpus, ft, use_classes=use_classes))
    for cap1 in (3, 1 << 20):
        for n_valid in (n, max(0, n - 300)):
            meta_k, pos_k = X.plane_extract(plane, n_valid, cap1)
            meta_p, pos_p = X.plane_extract_plain(plane, n_valid, cap1)
            assert torch.equal(meta_k, meta_p) and torch.equal(pos_k, pos_p)


def _plane(n: int, density: float, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    hit = rng.random(n) < density
    return (hit * rng.integers(1, 256, n)).astype(np.uint8)


def _same_extract(plane, n_valid: int, cap1: int) -> int:
    """The one-pass extraction equals its plain version, in one launch;
    returns the total."""
    T.reset_launches()
    meta_k, pos_k = X.plane_extract(plane, n_valid, cap1)
    assert T.LAUNCHES["plane_extract"] == 1
    meta_p, pos_p = X.plane_extract_plain(plane, n_valid, cap1)
    assert torch.equal(meta_k, meta_p), (meta_k, meta_p)
    assert torch.equal(pos_k, pos_p)
    return int(meta_p[0])


RANGE, STEP = 65536, 8192  # the extraction kernel's bytes a ticket, a step


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["all_nonzero", "many_waves", "n_valid",
                                  "one_chunk", "two_calls"])
def test_plane_extract_kernel_edges(card, case):
    """The extraction's look-back at its edges: every byte nonzero with
    cap1 below, at and above the total (ranges past the kernel's shared
    buffer); a 96 MiB plane (1,536 ranges, more than one resident wave, so
    tickets and the look-back cross waves); n_valid inside a chunk, at 0,
    at and beside a range edge and at a step edge; a plane of one chunk;
    and calls in a row on other planes and capacities, so status words of
    one call cannot leak into the next."""
    if case == "all_nonzero":
        plane = torch.ones((1 << 20) + 3 * 256, dtype=torch.uint8,
                           device=card)
        n = plane.numel()
        for cap1 in (1000, n - 1, n, n + 5):
            assert _same_extract(plane, n, cap1) == n
    elif case == "many_waves":
        p = _plane(96 << 20, 0.001, 1)
        p[(40 << 20):(40 << 20) + 300_000] = 7  # a dense stretch
        plane = torch.from_numpy(p).to(card)
        total = _same_extract(plane, plane.numel(), 1 << 20)
        assert total > 300_000
        _same_extract(plane, plane.numel(), total // 3)
        _same_extract(plane, plane.numel() - 1000, T._p2(total))
    elif case == "n_valid":
        plane = torch.from_numpy(_plane((1 << 20) + 7 * 256, 0.02,
                                        2)).to(card)
        for n_valid in (plane.numel(), 0, 1000, 257, 5 * RANGE,
                        5 * RANGE + 1, 5 * RANGE - 1, 5 * RANGE - 256,
                        3 * STEP):
            _same_extract(plane, n_valid, 1 << 20)
            _same_extract(plane, n_valid, 37)
    elif case == "one_chunk":
        p = np.zeros(256, np.uint8)
        p[[0, 3, 17, 128, 255]] = [1, 9, 200, 1, 3]
        plane = torch.from_numpy(p).to(card)
        for n_valid in (256, 1, 0, 1000):
            for cap1 in (1, 5, 300):
                _same_extract(plane, n_valid, cap1)
    else:
        big = torch.from_numpy(_plane(4 << 20, 0.05, 3)).to(card)
        small = torch.from_numpy(_plane(10 * 256, 0.3, 4)).to(card)
        for plane, cap1 in ((big, 1 << 20), (small, 1 << 20),
                            (big, 5000), (small, 3), (big, 1 << 18)):
            _same_extract(plane, plane.numel(), cap1)


def _rescan_same(corpus, ft, flags, capc):
    """The rescan with and without the gate's row counts equals the plain
    version (one launch each); returns the plain counts."""
    counts = flags.reshape(-1, G.ROWS_PER_CELL).sum(1, dtype=torch.int32)
    pos_p, cnt_p = T.filter_compact_plain(corpus, ft, capc,
                                          use_classes=True, row_flags=flags)
    for rc in (None, counts):
        T.reset_launches()
        pos_k, cnt_k = G.rescan_rows(corpus, ft, flags, capc, row_counts=rc)
        assert T.LAUNCHES["teddy_rescan_rows"] == 1
        _same_cells(pos_k, cnt_k, pos_p, cnt_p, capc)
    return cnt_p


@pytest.mark.cuda
def test_rescan_kernel_hot_and_empty_cells(card):
    """Cells with every row flagged (the block-wide path), with 65 and 64
    flagged rows (either side of the hot threshold), with a few and with
    none, and a last partial cell, over a corpus dense in candidates; capc
    1, 128 and above the hottest cell's count."""
    db = ht.compile_multi(GATED_PATS, ids=list(range(len(GATED_PATS))))
    ft, _ct = T.device_tables(db.lit, card)
    n = 7 * 65536 + 1000
    c = _gated_corpus(n, 7)
    p = np.frombuffer(b"attack0zq union5zq ", np.uint8)
    c[:65536 * 3] = np.resize(p, 65536 * 3)  # cells 0-2 full of candidates
    corpus = torch.from_numpy(c).to(card)
    rows = np.zeros((8, 512), np.uint8)
    rows[0] = 1                        # hot: all 512
    rows[2, ::7] = 1                   # hot: 74
    rows[3, :64] = 1                   # 64: the warp's
    rows[4, [0, 1, 200, 511]] = 1      # a few, the cell's first and last
    rows[6, 100:] = 1                  # hot: 412
    rows[7, :8] = 1                    # the last partial cell, past n too
    flags = torch.from_numpy(rows.reshape(-1)).to(card)
    cnt = _rescan_same(corpus, ft, flags, 1)
    assert int(cnt[0]) > 5000 and int(cnt[1]) == int(cnt[5]) == 0
    for capc in (128, int(cnt.max()) + 1):
        _rescan_same(corpus, ft, flags, capc)


@pytest.mark.cuda
def test_rescan_kernel_more_cells_than_warps(card):
    """More cells than the card holds warps at once (16 a multiprocessor,
    two blocks of eight warps), flagged by the gate, with a last partial
    cell: every warp takes several cells."""
    db = ht.compile_multi(GATED_PATS, ids=list(range(len(GATED_PATS))))
    ft, _ct = T.device_tables(db.lit, card)
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    n = (sms * 16 + 37) * 65536 - 5000
    corpus = torch.from_numpy(_gated_corpus(n, 8)).to(card)
    flags, _k = G.gate_rows(corpus, G.device_gate_table(db.lit, card))
    for capc in (1, 128):
        cnt = _rescan_same(corpus, ft, flags, capc)
    assert int(cnt.sum()) > 10_000


@pytest.mark.cuda
@pytest.mark.parametrize("family", list(F.FAMILIES))
def test_scan_each_family_on_card_counts_launches(card, family):
    db = compile_patterns(GATED_PATS, ids=list(range(len(GATED_PATS))),
                          grey=Grey(host_scan_limit=0))
    data = _gated_corpus(300_001, 6).tobytes()
    F.force_family(db.lit, family)
    T.reset_launches()
    got = ht.scan(db, data)  # the card, by default
    for name in FAMILY_KERNELS[family]:
        assert T.LAUNCHES[name] >= 1, name
    others = set(T.LAUNCHES) - set(FAMILY_KERNELS[family])
    assert all(T.LAUNCHES[k] == 0 for k in others)
    assert got == ht.scan(db, data, device="cpu")
    assert len(got) >= 50


# --- the multi-device path: kernel 7 (teddy_words), kernel C's row-mode
# --- batch scan, and a 4-shard mesh on one card ----------------------------

from hyperscan_tpu_torch import parallel as P  # noqa: E402
from hyperscan_tpu_torch.ops import dfa as D  # noqa: E402
from hyperscan_tpu_torch.ops import match as MT  # noqa: E402
from hyperscan_tpu_torch.ops import teddy_words as TW  # noqa: E402

WORD_PATS = (["attack%d" % i for i in range(300)]  # W = 2 words
             + [r"\x00\x00ab%d" % i for i in range(5)]
             + [r"\xff\xfezz%d" % i for i in range(5)])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [(1 << 20) + 13, 65536 + 7, 100, 1, 0])
def test_teddy_words_kernel_equals_plain(card, n):
    db = ht.compile_multi(WORD_PATS, ids=list(range(len(WORD_PATS))))
    masks = T.mask_tables(db.lit.masks, card)
    c = _corpus(n, 8)
    for off in range(0, n - 9, 1001):
        c[off:off + 8] = np.frombuffer(b"attack%02d" % (off % 97), np.uint8)
    corpus = torch.from_numpy(c).to(card)
    for start in sorted({0, min(n, 7), n // 2}):
        cnt_p, pos_p, words_p = TW.filter_words_plain(corpus, masks, start)
        cnt_k, seg_k = TW.filter_words_count(corpus, masks, start,
                                             segments=True)
        assert torch.equal(cnt_k, cnt_p)
        assert torch.equal(seg_k, TW.segment_counts(pos_p, n, start))
        assert torch.equal(TW.filter_words_count(corpus, masks, start), cnt_p)
        total = pos_p.numel()
        for cap in (total + 5, max(1, total // 3)):
            pos_k, words_k = TW.filter_words_list(corpus, masks, seg_k, cap,
                                                  start)
            k = min(cap, total)
            assert torch.equal(pos_k[:k], pos_p[:k])
            assert torch.equal(words_k[:, :k], words_p[:, :k])
            assert not pos_k[k:].any() and not words_k[:, k:].any()
        if n > 1000 and start == 0:
            assert total > 50


@pytest.mark.cuda
@pytest.mark.parametrize("use_classes", [True, False])
@pytest.mark.parametrize("n", [(1 << 20) + 13, 3 * 65536 + 517])
def test_teddy_words_table_routes_equal_plain(card, use_classes, n):
    """Kernel 7 with each table route forced, at an unaligned length with
    a look-back head: cell and segment counts, positions and words equal
    the plain version (byte tables) exactly, and the list stops at cap
    without losing the count."""
    db = ht.compile_multi(WORD_PATS, ids=list(range(len(WORD_PATS))))
    masks = T.mask_tables(db.lit.masks, card)
    assert masks.cmasks is not None  # the alphabet compresses
    c = _corpus(n, 13)
    for off in range(0, n - 9, 701):
        c[off:off + 8] = np.frombuffer(b"attack%02d" % (off % 89), np.uint8)
    corpus = torch.from_numpy(c).to(card)
    start = 8 + 3  # a shard's look-back head, unaligned
    cnt_p, pos_p, words_p = TW.filter_words_plain(corpus, masks, start)
    total = pos_p.numel()
    assert total > 500
    cnt_k, seg_k = TW.filter_words_count(corpus, masks, start, segments=True,
                                         use_classes=use_classes)
    assert torch.equal(cnt_k, cnt_p)
    assert torch.equal(seg_k, TW.segment_counts(pos_p, n, start))
    T.reset_launches()
    for cap in (total, total // 7):
        pos_k, words_k = TW.filter_words_list(corpus, masks, seg_k, cap,
                                              start, use_classes=use_classes)
        assert torch.equal(pos_k, pos_p[:cap])
        assert torch.equal(words_k, words_p[:, :cap])
    assert T.LAUNCHES["teddy_words_list"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("init", ["scalar", "rows"])
def test_chained_dfa_scan_batch_equals_plain(card, init):
    eng = _dfa_engine([r"ab[cd]{2,6}ef", r"[0-9]{3}-[0-9]{4}",
                       r"GET /[a-z]{1,12} "])
    blocks = _engine_blocks(9, [1100] * 40 + [0, 1, 511, 512, 513])
    B, L = len(blocks), 1100
    data = np.zeros((B, L), np.uint8)
    lengths = np.zeros(B, np.int32)
    for i, b in enumerate(blocks):
        data[i, :len(b)] = np.frombuffer(b, np.uint8)
        lengths[i] = len(b)
    tabs = DK.device_tables(eng, card)
    init_state = (eng.start_state if init == "scalar" else torch.from_numpy(
        np.random.default_rng(3).integers(0, eng.num_states, B)
        .astype(np.int32)).to(card))
    d_t = torch.from_numpy(data).to(card)
    l_t = torch.from_numpy(lengths).to(card)
    args = (tabs.trans.view(tabs.S, tabs.C), tabs.b2c, tabs.accept,
            init_state, d_t, l_t)
    T.reset_launches()
    a_k, f_k = D.dfa_scan_batch(*args)
    assert T.LAUNCHES["dfa_scan_rows"] == 1  # one launch a call
    assert T.LAUNCHES["dfa_scan"] == 0
    a_p, f_p = D.dfa_scan_batch_plain(*args)
    assert torch.equal(a_k, a_p) and torch.equal(f_k, f_p)
    assert int(MT.count_matches(a_k)) > 20


def _one_card_meshes(card):
    return (P.Mesh([card], ("d",)),
            P.Mesh(np.array([card] * 4, dtype=object).reshape(2, 2),
                   ("x", "y")))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [(1 << 20) + 13, 4 * 65536, 4 * 65536 + 1,
                               100])
def test_four_shards_on_one_card_equal_one_shard(card, n):
    db = ht.compile_multi(WORD_PATS, ids=list(range(len(WORD_PATS))))
    c = _corpus(n, 10)
    for off in range(0, n - 9, 1001):
        c[off:off + 8] = np.frombuffer(b"attack%02d" % (off % 97), np.uint8)
    one, four = _one_card_meshes(card)
    T.reset_launches()
    got1 = P.sharded_teddy_count(c, db.lit.masks, one)
    got4 = P.sharded_teddy_count(c, db.lit.masks, four)
    shards = sum(hi > lo for lo, hi in P.sharded.segments(n, 4))
    assert T.LAUNCHES["teddy_words_count"] == 1 + shards
    total, _pos, _w = TW.teddy_scan(c, db.lit.masks)
    assert got1 == got4 == total
    assert T.LAUNCHES["teddy_words_list"] == 1


@pytest.mark.cuda
def test_sharded_scans_on_one_card(card):
    one, four = _one_card_meshes(card)
    blocks = [_gated_corpus(s, s).tobytes()
              for s in (70_001, 5, 120_000, 65_536, 33_333, 1, 90_000)]
    db = compile_patterns(GATED_PATS, ids=list(range(len(GATED_PATS))))
    want = ht.scan_batch(db, blocks)
    assert ht.scan_batch(db, blocks, mesh=one) == want
    assert ht.scan_batch(db, blocks, mesh=four) == want
    assert sum(map(len, want)) >= 50
    eng = _dfa_engine([r"ab[cd]{2,6}ef", r"[0-9]{3}-[0-9]{4}"])
    eblocks = _engine_blocks(11, [1000] * 30 + [0, 513])
    data, lengths = P.pad_batch_for_mesh(eblocks, four, pad_len=1100)
    c1 = P.sharded_scan_counts(eng, data, lengths, one)
    assert c1 == P.sharded_scan_counts(eng, data, lengths, four) > 5
    m1 = P.sharded_scan_matches(eng, data, lengths, one, capacity=512)
    m4 = P.sharded_scan_matches(eng, data, lengths, four, capacity=512)
    assert int(m1[0].sum()) == int(m4[0].sum()) == c1
    assert m4[4].shape == (4, data.shape[0] // 4)


# --- kernel 4's stage modes (row 11) and streaming on the card ---------------

from hyperscan_tpu_torch.runtime import streamset as SS  # noqa: E402

KC_PATS = (["attack%d" % i for i in range(40)]
           + [r"payload%d[0-9]{2,4}z" % i for i in range(30)]
           + [r"q%dh[a-f0-9]{8}" % i for i in range(30)])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [(1 << 20) + 13, 4 * 65536, 100])
def test_kconfirm_stages_equal_plain(card, n):
    """Stages 0-2 of kernel 4 equal their plain versions; stage 3's
    candidate counts equal stage 0's, its match counts stage 2's."""
    db = ht.compile_multi(KC_PATS, ids=list(range(len(KC_PATS))))
    ft, _ct = T.device_tables(db.lit, card)
    kt = K.confirm_planes(db.lit, card)
    uc = ft.cmasks is not None
    corpus = torch.from_numpy(_gated_corpus(n, 3)).to(card)
    full = K.filter_kconfirm(corpus, ft, kt, use_classes=uc)
    T.reset_launches()
    got = {}
    for stage in (0, 1, 2):
        k = K.filter_kconfirm(corpus, ft, kt, use_classes=uc, stage=stage)
        p = K.filter_kconfirm_stage_plain(corpus, ft, kt, use_classes=uc,
                                          stage=stage)
        for a, b in zip(k, p):
            assert torch.equal(a, b), stage
        got[stage] = k
    assert T.LAUNCHES["teddy_kconfirm_stage"] == 3
    assert T.LAUNCHES["teddy_kconfirm"] == 0
    assert torch.equal(full[0], got[0][0]) and torch.equal(full[0], got[2][0])
    assert torch.equal(full[1], got[2][2])


@pytest.mark.cuda
def test_streamset_round_on_card_equals_cpu(card):
    """Pipelined StreamSet rounds on the card, the extents uploaded by the
    caller (`ext_t`), equal the same rounds on the CPU; the round's
    filter kernel ran."""
    db = ht.compile_multi(KC_PATS, ids=list(range(len(KC_PATS))),
                          mode=ht.HS_MODE_STREAM)
    S, write = 48, 8192
    writes = [[_gated_corpus(write, 100 * r + i).tobytes()
               for i in range(S)] for r in range(3)]
    ref = SS.open_streamset(db, S, device="cpu")
    want = [SS.scan_streamset(db, ref, w) for w in writes]
    ss = SS.open_streamset(db, S, device=card)
    T.reset_launches()
    handles = []
    for w in writes:
        hl = np.asarray([len(h) for h in ss.hist], np.int64)
        ext = np.frombuffer(b"".join(bytes(h) + c for h, c in zip(ss.hist, w)),
                            np.uint8).copy()
        handles.append(SS.streamset_write_start(
            db, ss, ext_np=ext, ext_t=torch.from_numpy(ext).to(card),
            hlens=hl, chunk_lens=np.full(S, write, np.int64)))
    gots = F.confirm_fetch_many([h.dev_handle for h in handles])
    got = [SS.streamset_write_finish(db, ss, h, got=g)
           for h, g in zip(handles, gots)]
    assert got == want and sum(len(m) for r in got for m in r) > 20
    fam = handles[0].dev_handle.family
    assert all(T.LAUNCHES[k] > 0 for k in FAMILY_KERNELS[fam])
    assert SS.close_streamset(db, ss) == SS.close_streamset(db, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("in_flight", [2, 3])
def test_streamset_chunks_rounds_pinned_on_card_equal_cpu(card, in_flight):
    """`chunks` rounds on the card, over 200 KiB of extents each and
    `in_flight` rounds started before the oldest finishes, equal the same
    writes on the CPU round by round, history by history and at the
    close. Every round's extents were stitched into pinned memory of
    their own (`stitch_pinned`) and were not written again while their
    finish could read them; the histories are copies, sharing no memory
    with any round's extents."""
    from collections import deque

    from hyperscan_tpu_torch import trace as TR

    db = ht.compile_multi(KC_PATS, ids=list(range(len(KC_PATS))),
                          mode=ht.HS_MODE_STREAM)
    S, rounds = 64, 7
    rng = np.random.default_rng(in_flight)
    flows = [_gated_corpus(rounds * 4000, 7 * i + in_flight).tobytes()
             for i in range(S)]
    cuts = (np.arange(1, rounds) * 4000
            + rng.integers(-1900, 1900, (S, rounds - 1)))
    cuts[::9, 2] = cuts[::9, 1]  # empty writes
    cuts[1::9, 3] = cuts[1::9, 2] + 5  # writes shorter than the history
    bounds = np.concatenate([np.zeros((S, 1), np.int64), cuts,
                             np.full((S, 1), rounds * 4000)], axis=1)
    writes = [[flows[i][bounds[i, r]:bounds[i, r + 1]] for i in range(S)]
              for r in range(rounds)]
    assert all(sum(map(len, w)) > 200 << 10 for w in writes)
    ref = SS.open_streamset(db, S, device="cpu")
    want, want_hist = [], []
    for w in writes:
        want.append(SS.scan_streamset(db, ref, w))
        want_hist.append([bytes(h) for h in ref.hist])
    ss = SS.open_streamset(db, S, device=card)
    before = dict(TR.COUNTS)
    pending, got = deque(), []

    def finish():
        h, snap, r = pending.popleft()
        assert h.ext_np.tobytes() == snap, r
        got.append(SS.streamset_write_finish(db, ss, h))

    for r, w in enumerate(writes):
        h = SS.streamset_write_start(db, ss, w)
        assert h.dev_handle is not None
        assert torch.from_numpy(h.ext_np).is_pinned()
        assert [bytes(x) for x in ss.hist] == want_hist[r]
        pending.append((h, h.ext_np.tobytes(), r))
        live = [p[0].ext_np for p in pending]
        assert not any(np.shares_memory(a, b)
                       for k, a in enumerate(live) for b in live[k + 1:])
        assert not any(np.shares_memory(ss.hist.buf, a) for a in live)
        if len(pending) == in_flight:
            finish()
            assert [bytes(x) for x in ss.hist] == want_hist[r]
    while pending:
        finish()
    assert got == want and sum(len(m) for r in got for m in r) > 100
    assert TR.COUNTS["stitch_pinned"] - before["stitch_pinned"] == rounds
    assert SS.close_streamset(db, ss) == SS.close_streamset(db, ref)


@pytest.mark.cuda
def test_stream_engines_on_card_equal_cpu(card):
    """Large stream writes of a bounded DFA scan on kernel C entered in
    the carried states and equal the CPU's; scan_streams(threads=2) makes
    the card current in its threads and equals one thread."""
    db = compile_patterns([r"[0-9]{6}[a-f]", "attack7"], [0, 0], [1, 2],
                          mode=ht.HS_MODE_STREAM,
                          grey=Grey(host_scan_limit=1 << 10))
    S = 8
    writes = [[_gated_corpus(5000, 10 * r + i).tobytes() for i in range(S)]
              for r in range(3)]
    writes[1][0] = b"12a" + writes[1][0][3:]
    writes[0][0] = writes[0][0][:-4] + b"3456"
    cpu = [ht.open_stream(db, device="cpu") for _ in range(S)]
    want = [ht.scan_streams(db, cpu, w) for w in writes]
    want.append([ht.close_stream(s) for s in cpu])
    for threads in (1, 2):
        T.reset_launches()
        st = [ht.open_stream(db, device=card) for _ in range(S)]
        got = [ht.scan_streams(db, st, w, threads=threads) for w in writes]
        got.append([ht.close_stream(s) for s in st])
        assert got == want
        assert T.LAUNCHES["dfa_scan"] > 0
    assert any(m[0] == 1 and m[2] == 5003 for m in want[1][0])


# --- the redesigned kernels: kernel 4 over the packed tables at any (M, W),
# --- and kernel C's row mode --------------------------------------------------

import dataclasses  # noqa: E402


def _reshaped_tables(masks: np.ndarray, M: int, W: int):
    """Tables of depth M and W words whose candidates include those of
    `masks` [M0, W0, 256]: words folded by OR when W < W0, copies rotated
    by a different amount at each suffix offset added when W > W0 (they
    pass other positions), suffix offsets dropped when M < M0, all-ones
    ones added when M > M0 (each a superset, so planted matches still
    pass)."""
    M0, W0, _ = masks.shape
    u = masks.astype(np.int64) & 0xFFFFFFFF
    out = np.zeros((M, W, 256), np.int64)
    for m in range(M):
        for w in range(W):
            if m >= M0:
                out[m, w] = 0xFFFFFFFF
            elif W < W0:
                out[m, w] = np.bitwise_or.reduce(u[m, w::W], axis=0)
            else:
                r = (w // W0) * (m + 1) % 32
                v = u[m, w % W0]
                out[m, w] = ((v << r) | (v >> (32 - r))) & 0xFFFFFFFF
    out = out.astype(np.uint32).view(np.int32)
    split = T._class_split(out)
    b2c = np.concatenate([split[0][0], split[0][1]]).astype(np.uint8)
    return out, b2c, split[1]


@pytest.mark.cuda
@pytest.mark.parametrize("W", [1, 3, 4, 5, 8])
@pytest.mark.parametrize("M", range(1, 9))
def test_kconfirm_any_shape_equals_plain(card, M, W):
    """Kernel 4 at every suffix depth and at W in {1, 3, 4, 5, 8} (every
    padded width and vector width), both table kinds, with the groups of
    a real database and with none (G = 0), at a length that is neither a
    multiple of 16 nor of 4 KiB: stage 3 and stages 0-2 equal their
    plain versions."""
    db = ht.compile_multi(KC_PATS, ids=list(range(len(KC_PATS))))
    masks, b2c, cmasks = _reshaped_tables(
        np.ascontiguousarray(db.lit.masks, np.int32), M, W)
    ft = T.filter_tables(torch.from_numpy(masks).to(card),
                         torch.from_numpy(b2c).to(card),
                         torch.from_numpy(cmasks).to(card))
    kt = K.confirm_planes(db.lit, card)
    corpus = torch.from_numpy(_gated_corpus(3 * 65536 + 4099, 7)).to(card)
    for groups in (kt, dataclasses.replace(kt, groups=())):
        for uc in (True, False):
            out_k = K.filter_kconfirm(corpus, ft, groups, use_classes=uc)
            out_p = K.filter_kconfirm_plain(corpus, ft, groups,
                                            use_classes=uc)
            assert torch.equal(out_k[0], out_p[0])
            _same_cells(out_k[2], out_k[1], out_p[2], out_p[1], K.CAPC2)
            _same_cells(out_k[3], out_k[1], out_p[3], out_p[1], K.CAPC2)
            for stage in (0, 1, 2):
                k = K.filter_kconfirm(corpus, ft, groups, use_classes=uc,
                                      stage=stage)
                p = K.filter_kconfirm_stage_plain(corpus, ft, groups,
                                                  use_classes=uc,
                                                  stage=stage)
                for a, b in zip(k, p):
                    assert torch.equal(a, b), (stage, uc)
            if groups is kt:
                assert int(out_p[1].sum()) > 10
            else:
                assert int(out_p[1].sum()) == 0
    assert int(out_p[0].sum()) > 40


@pytest.mark.cuda
@pytest.mark.parametrize("B,L", [(1, 1000), (45, 1100), (16_384, 1000)])
@pytest.mark.parametrize("placement", ["shared", "global"])
def test_dfa_scan_rows_kernel_equals_plain(card, B, L, placement):
    """Kernel C's row mode: one launch a call, equal to the lockstep plain
    version at a length that is not a multiple of the tile, with rows of
    length 0 and per-row entry states, the tables in shared and in global
    memory."""
    eng = _dfa_engine([r"ab[cd]{2,6}ef", r"[0-9]{3}-[0-9]{4}",
                       r"GET /[a-z]{1,12} "])
    rng = np.random.default_rng(B)
    blocks = _engine_blocks(12, [L] * min(B, 64))
    data = np.stack([np.frombuffer(blocks[i % len(blocks)], np.uint8)
                     for i in range(B)])
    lengths = rng.integers(0, L + 1, B).astype(np.int32)
    lengths[:3] = [L, 0, 1][:B]
    tabs = DK.device_tables(eng, card)
    init = torch.from_numpy(rng.integers(0, eng.num_states, B)
                            .astype(np.int32)).to(card)
    d_t = torch.from_numpy(data).to(card)
    l_t = torch.from_numpy(lengths).to(card)
    T.reset_launches()
    a_k, f_k = D.dfa_scan_rows(tabs, init, d_t, l_t, placement=placement)
    assert T.LAUNCHES["dfa_scan_rows"] == 1
    a_p, f_p = D.dfa_scan_batch_plain(tabs.trans.view(tabs.S, tabs.C),
                                      tabs.b2c, tabs.accept, init, d_t, l_t)
    assert torch.equal(a_k, a_p) and torch.equal(f_k, f_p)
    assert int((a_p != 0).sum()) > B // 2


# --- the differential tools and Chimera on the card -------------------------

from hyperscan_tpu_torch import chimera as CH  # noqa: E402
from hyperscan_tpu_torch.tools import fuzz, hscollider  # noqa: E402

TOOL_PATS = ("1:/attack[0-9]+/\n2:/foo(bar|baz)/i\n3:/err(or)?/\n"
             "4:/[ab]+c[de]+/\n5:/gatex(ab|cd)*doorq/\n"
             "6:/num[0-9]{2,4}tail/L\n7:/lead[a-z]*mark7/\n")
LITERAL = ("teddy_filter_compact", "teddy_hash_confirm", "teddy_gate",
           "teddy_rescan_rows", "teddy_kconfirm", "teddy_filter_plane",
           "plane_extract")


@pytest.mark.cuda
def test_hscollider_on_card(card, tmp_path, capsys):
    p = tmp_path / "pats.txt"
    p.write_text(TOOL_PATS)
    T.reset_launches()
    assert hscollider.main([str(p), "--seed", "3", "--device", "cuda"]) == 0
    assert "all consistent" in capsys.readouterr().out
    assert sum(T.LAUNCHES[k] for k in LITERAL) > 0


@pytest.mark.cuda
def test_fuzz_rounds_on_card(card):
    rng = np.random.default_rng(99)
    T.reset_launches()
    for _ in range(2):
        assert fuzz.fuzz_round(rng, 5, 4, device="cuda") == []
    assert sum(T.LAUNCHES[k] for k in LITERAL) > 0


@pytest.mark.cuda
def test_chimera_on_card_equals_cpu(card):
    pats = [r"(\w+)@example\.com", r"attack(\d+)", r"(foo|bar)\1"]
    db = CH.ch_compile_multi(pats, ids=[1, 2, 3])
    data = bytearray(_corpus(300_001, 4).tobytes())
    for off in range(100, 299_000, 7919):
        data[off:off + 24] = b" bob@example.com foofoo "
    data = bytes(data)
    T.reset_launches()
    got, want = [], []
    assert CH.ch_scan(db, data, matches=got) == CH.CH_SUCCESS  # the card
    assert T.LAUNCHES["teddy_filter_compact"] + T.LAUNCHES["teddy_gate"] \
        + T.LAUNCHES["teddy_kconfirm"] + T.LAUNCHES["teddy_filter_plane"] > 0
    assert CH.ch_scan(db, data, matches=want, device="cpu") == CH.CH_SUCCESS
    assert got == want and len(got) >= 37


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["combination", "ext", "singlematch",
                                  "anchored", "fuzzy", "utf8", "bitnfa",
                                  "ranges"])
def test_feature_database_on_card(card, name):
    """tools/features.py's databases on the card at a small size: plants
    found, the prefix equal to the host route, the round trip equal, the
    StreamSet's streams equal to the host route."""
    from hyperscan_tpu_torch.tools import features as FT

    r = FT.run_feature(name, FT.base_corpus(4 << 20, 13), device="cuda",
                       block=1 << 20, prefix=1 << 20, spacing=8192,
                       streams=64, write=8192, rounds=3, check_streams=64,
                       sync=torch.cuda.synchronize)
    assert r["plants"] > 0 and r["matches"] >= r["plants"]


@pytest.mark.cuda
def test_dropped_database_frees_card_memory(card):
    """A database dropped after scans on the card gives back every byte
    its tables took: the device tables hang on the database's own objects
    and no module keeps them."""
    import gc

    from hyperscan_tpu_torch.tools import features as FT

    data = FT.planted(FT.base_corpus(1 << 22, 3),
                      FT.FEATURES["bitnfa"].plant,
                      FT.plant_offsets(1 << 22, 8192)).tobytes()
    for name in ("anchored", "bitnfa", "utf8"):
        gc.collect()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        db = FT.compile_feature(name, host_scan_limit=0)
        ht.scan(db, data)
        assert torch.cuda.memory_allocated() > before
        del db
        gc.collect()
        torch.cuda.synchronize()
        assert torch.cuda.memory_allocated() - before <= 512, name


@pytest.mark.cuda
def test_graft_entry_on_card_equals_cpu(card):
    """graft_entry.entry(): the block-scan step on the card (kernel C's row
    mode) gives the five outputs of the same step on the CPU."""
    from hyperscan_tpu_torch import graft_entry as GE
    from hyperscan_tpu_torch.ops._build import LAUNCHES

    fn, args = GE.entry()
    assert all(a.device.type == "cuda" for a in args)
    before = LAUNCHES["dfa_scan_rows"]
    got = fn(*args)
    assert LAUNCHES["dfa_scan_rows"] == before + 1
    cfn, cargs = GE.entry("cpu")
    for g, w in zip(got, cfn(*cargs)):
        assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 4])
def test_graft_dryrun_on_card(card, n):
    """dryrun_multichip on the card: n cards where visible, else n shards
    of card 0; its product path equals the CPU's."""
    from hyperscan_tpu_torch import graft_entry as GE

    r = GE.dryrun_multichip(n)
    assert len(r["devices"]) == n
    want = GE.dryrun_multichip(n, device="cpu")
    assert r["count"] == want["count"]
    assert [sorted(m) for m in r["single"]] == \
        [sorted(m) for m in want["single"]]


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["bounded_dfa", "unbounded_dfa",
                                   "cyclic_nfa", "acyclic_nfa", "dfa_rows",
                                   "compact", "confirm", "plane", "kconfirm",
                                   "gate", "rescan", "words"])
def test_kernel_bench_on_card(card, route):
    """tools/kernel_bench.py on the card at a small size: each kernel
    equal to its plain version and launched by the timed calls; what the
    rows counted (records; candidates, pairs, rows, accepts) positive and
    equal to the CPU's (but the random dense plane's). Each run gets a
    database of its own, as the capacities it learns depend on what the
    database has seen."""
    from hyperscan_tpu_torch.tools import benchdata as BD
    from hyperscan_tpu_torch.tools import kernel_bench as KB

    pats, ids = BD.patterns(600)
    r = KB.run_benches([route], sizes_mb=(4,), reps=2,
                       db=ht.compile_multi(pats, ids=ids))[route]
    assert set(r["err"].values()) == {0}
    assert all(r["launches"][k] > 0 for k in r["err"])
    if route in KB.ENGINE_SETS:  # a warm-up call, 2 timed
        assert r["launches"] == {KB.ENGINE_SETS[route][3]: 3}
    c = KB.run_benches([route], sizes_mb=(4,), reps=1, device="cpu",
                       db=ht.compile_multi(pats, ids=ids))[route]

    def counted(res):
        return [(s["what"], s.get("records", s.get("count")))
                for s in res["rows"] if "dense" not in s["what"]]

    assert counted(r) == counted(c) and r["rows"]
    assert all(n > 0 for _what, n in counted(r))


@pytest.mark.cuda
def test_kconf_bench_on_card(card):
    """tools/kconf_bench.py on the card: the kconfirm and compact families'
    verified pairs equal each other's and the CPU's."""
    from hyperscan_tpu_torch.tools import benchdata as BD
    from hyperscan_tpu_torch.tools import kconf_bench as KC

    pats, ids = BD.patterns(600)
    db = ht.compile_multi(pats, ids=ids)
    r = KC.run(db, mb=8, iters=2)
    c = KC.run(db, mb=8, iters=2, device="cpu")
    for fam in KC.FAMILIES:
        assert r[fam]["pairs"] == c[fam]["pairs"]
