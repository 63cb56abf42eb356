"""Kernel 7's table routes and segment counts, and kernel C's step-table
chain, on the CPU against the JAX package.

- Kernel 7 (`ops/teddy_words.py`) reads class tables where the alphabet
  compresses to 128 classes: on the 10k bench ruleset's masks they give
  the byte tables' words bit for bit (every table column, and the words
  over bench corpora, the zero byte before offset 0 included); a ruleset
  of more than 128 classes stays on byte tables.
- Count mode's per-segment counts (plain version) sum to its per-cell
  counts, and a list assembled as list mode assembles it (each nonempty
  segment re-filtered and placed at its exclusive-prefix rank) equals the
  JAX package's `teddy_scan` (after dropping the reference's candidates
  in the zero padding past n, ROADMAP §3 item 4).
- Kernel C (`csrc/dfa_scan.cu`) chains a step table whose (state, class)
  entry packs (4 x next state x C, the next state's accept id) in 16
  bits each, with each byte's class looked up off the chain. That
  formulation, written here
  in numpy, equals `dfa_scan_chunks_plain` on the chunk rows and, put in
  the kernel's place, the JAX package's scans on all three DFA routes
  (the bounded DFA, the unbounded DFA's speculative scan, a cyclic NFA's
  lazy-DFA core), with carried states. Records are compared as sets.
  Which DFAs get such shared tables, in each mode, is `placement_of`'s
  decision alone.

Every value is an integer, so equality is exact."""

import numpy as np
import pytest
import torch

import hyperscan_tpu as hs
import hyperscan_tpu_torch as ht
import torch_ref_native  # noqa: F401 (the reference's native build, locked)
from hyperscan_tpu.database import compile_patterns as ref_compile
from hyperscan_tpu.grey import Grey as RefGrey
from hyperscan_tpu.ops import dfa_kernel as RDK
from hyperscan_tpu.ops import teddy as RT
from hyperscan_tpu_torch.database import compile_patterns as port_compile
from hyperscan_tpu_torch.grey import Grey as PortGrey
from hyperscan_tpu_torch.ops import dfa_kernel as PDK
from hyperscan_tpu_torch.ops import teddy as PT
from hyperscan_tpu_torch.ops import teddy_words as TW
from hyperscan_tpu_torch.tools.benchdata import gen_corpus, patterns


class _Hints:
    """A bare object to learn capacities on."""


@pytest.fixture(scope="module")
def bench_masks():
    """The [M, W, 256] masks of the 10k-pattern bench ruleset (the
    literal main path's; one compile, about a minute on the CPU)."""
    pats, ids = patterns(10_000)
    masks = ht.compile_multi(pats, ids=ids).lit.masks
    assert masks.shape == (5, 4, 256) and (masks < 0).any()
    return masks


def _bench_corpus(n: int, kind: str) -> torch.Tensor:
    c = gen_corpus(max(n, 1 << 14), 3, kind)[:n].copy()
    c[:2] = 0  # zero bytes at the start: the same key as before offset 0
    return torch.from_numpy(c)


# --- kernel 7: class tables -------------------------------------------------


def test_class_tables_equal_byte_tables_on_bench_masks(bench_masks):
    wt = PT.mask_tables(bench_masks, "cpu")
    assert wt.cmasks is not None and wt.cpacked is not None
    b2c = wt.b2c.long()
    assert int(b2c.max()) < 128
    # every column: a byte's class column is the byte's own column
    assert torch.equal(wt.cmasks[:, :, b2c], wt.masks)
    assert torch.equal(wt.cpacked[:, b2c, :], wt.packed)


@pytest.mark.parametrize("kind", ["iid", "structured"])
@pytest.mark.parametrize("start", [0, 11])
def test_class_route_words_equal_byte_route_on_bench_masks(bench_masks,
                                                           kind, start):
    wt = PT.mask_tables(bench_masks, "cpu")
    corpus = _bench_corpus(3 * PT.CELL + 517, kind)
    by_bytes = TW.filter_words_plain(corpus, wt, start)
    by_class = TW.filter_words_plain(corpus, wt, start, use_classes=True)
    for a, b in zip(by_bytes, by_class):
        assert a.dtype == b.dtype == torch.int32
        assert torch.equal(a, b)
    assert by_bytes[1].numel() > (100 if kind == "iid" else 0)
    # the wrappers' default route is the class route, and either route
    # can be forced
    for uc in (None, True, False):
        assert torch.equal(TW.filter_words_count(corpus, wt, start,
                                                 use_classes=uc),
                           by_bytes[0])


def test_wide_alphabet_stays_on_byte_tables():
    """Masks whose 256 byte columns are all distinct (more than 128
    classes): no class tables, the byte route by default, and forcing
    the class route raises."""
    rng = np.random.default_rng(7)
    masks = rng.integers(-(1 << 31), 1 << 31, (3, 2, 256), dtype=np.int64)
    masks = masks.astype(np.int32)
    assert len(np.unique(masks.reshape(6, 256).T, axis=0)) > 128
    wt = PT.mask_tables(masks, "cpu")
    assert wt.cmasks is None and wt.cpacked is None and wt.b2c is None
    corpus = torch.from_numpy(rng.integers(0, 256, 5000).astype(np.uint8))
    cnt, segs = TW.filter_words_count(corpus, wt, segments=True)
    assert int(cnt.sum()) == int(segs.sum()) > 0
    with pytest.raises(ValueError, match="128 classes"):
        TW.filter_words_count(corpus, wt, use_classes=True)
    with pytest.raises(ValueError, match="128 classes"):
        TW.filter_words_list(corpus, wt, segs, 8, use_classes=True)


# --- kernel 7: segment counts and the list built from them ------------------


@pytest.mark.parametrize("n,start", [(3 * PT.CELL + 517, 0),
                                     (2 * PT.CELL, 13), (511, 0), (0, 0)])
def test_segment_counts_sum_to_cell_counts(bench_masks, n, start):
    wt = PT.mask_tables(bench_masks, "cpu")
    corpus = _bench_corpus(n, "iid")
    cnt, segs = TW.filter_words_count(corpus, wt, start, segments=True)
    assert segs.shape == (TW.n_segments(n),) and segs.dtype == torch.int32
    per_cell = PT.CELL // TW.SEG
    padded = torch.zeros(cnt.numel() * per_cell, dtype=torch.int64)
    padded[:segs.numel()] = segs.long()
    assert torch.equal(padded.view(-1, per_cell).sum(1), cnt.long())
    if start:  # the look-back head's segment counts only positions >= start
        assert int(segs[0]) == int(TW.filter_words_count(
            corpus[:TW.SEG], wt, start)[0])
    assert n < 1000 or int(cnt.sum()) > 50


def _list_by_segments(corpus, wt, start, cap):
    """List mode's placement, in plain torch: every segment with a
    nonzero count re-filtered on its own and its candidates written from
    the segment's exclusive-prefix rank, up to cap."""
    n = corpus.numel()
    _cnt, segs = TW.filter_words_count(corpus, wt, start, segments=True)
    first = torch.cumsum(segs.long(), 0) - segs.long()
    pos = torch.zeros(cap, dtype=torch.int32)
    words = torch.zeros((wt.W, cap), dtype=torch.int32)
    for s in torch.nonzero(segs).squeeze(1).tolist():
        lo, hi = max(s * TW.SEG, start), min(n, (s + 1) * TW.SEG)
        w = TW._words_plain(corpus, wt.cmasks, wt.b2c, lo, hi)
        nz = torch.nonzero((w != 0).any(0)).squeeze(1)
        assert nz.numel() == int(segs[s])
        r = int(first[s]) + torch.arange(nz.numel())
        keep = r < cap
        pos[r[keep]] = (nz[keep] + lo - start).int()
        words[:, r[keep]] = w[:, nz[keep]]
    return int(segs.long().sum()), pos, words


@pytest.mark.parametrize("n", [70_144, 70_003])
def test_list_from_segment_ranks_equals_reference(bench_masks, n):
    corpus = gen_corpus(n, 4, "iid")
    corpus[:3] = np.frombuffer(b"\x00\x00\x00", np.uint8)
    r_tot, r_pos, r_words = RT.teddy_scan(corpus, bench_masks, 1 << 12,
                                          hint_obj=_Hints())
    r_pos, r_words = np.asarray(r_pos), np.asarray(r_words)
    keep = r_pos < n  # the reference's padding candidates past n dropped
    wt = PT.mask_tables(bench_masks, "cpu")
    total, pos, words = _list_by_segments(torch.from_numpy(corpus), wt, 0,
                                          int(keep.sum()) + 4)
    assert total == int(keep.sum()) > 20
    if n % 256 == 0:
        assert total == r_tot
    assert np.array_equal(pos[:total].numpy(), r_pos[keep])
    assert np.array_equal(words[:, :total].numpy(), r_words[:, keep])
    assert not pos[total:].any() and not words[:, total:].any()
    # the port's own teddy_scan (count with segments, then list) agrees
    p_tot, p_pos, p_words = TW.teddy_scan(corpus, bench_masks, 8,
                                          device="cpu")
    assert p_tot == total and np.array_equal(p_pos, r_pos[keep])
    assert np.array_equal(p_words, r_words[:, keep])


# --- kernel C: the step-table chain -----------------------------------------


def _step_table_scan(corpus_u8, tables, meta, H, capacity):
    """Kernel C's chain as the kernel runs it with shared tables, in
    numpy: each byte's class looked up apart from the chain, a step
    table whose entry packs 4 x next state x C in its low 16 bits and
    the next state's accept id in its high 16, the state carried as 4 x
    state x C (a byte offset into the table); the contract of
    `dfa_scan_chunks` (records ordered by (t, chunk))."""
    S, C = tables.S, tables.C
    trans = tables.trans.numpy().reshape(S, C).astype(np.int64)
    accept = tables.accept.numpy().astype(np.int64)
    assert 4 * S * C <= 1 << 16 and accept.max() < 1 << 16
    step = (4 * trans * C | accept[trans] << 16).reshape(-1)
    b2c = tables.b2c.numpy().astype(np.int64)
    data = corpus_u8.numpy()
    classes = b2c[data] if data.size else np.zeros(1, np.int64)
    m = meta.numpy().astype(np.int64)
    start, vfrom, vto, entry = m.T
    st = 4 * entry * C
    recs = []
    for t in range(PDK.CHUNK):
        p = start + t
        inside = (p >= 0) & (p < data.size)
        cls = np.where(inside, classes[np.clip(p, 0, max(data.size - 1, 0))],
                       b2c[0])
        live = (vfrom <= t) & (t < vto)
        e = step[(st + 4 * cls) // 4]
        aid = np.where(live & (t >= H), e >> 16, 0)
        st = np.where(live, e & 0xFFFF, st)
        for c in np.nonzero(aid)[0]:
            recs.append((c, t, aid[c]))
    total = len(recs)
    out = torch.zeros((capacity, 3), dtype=torch.int32)
    if recs:
        k = min(total, capacity)
        out[:k] = torch.tensor(recs[:k], dtype=torch.int32)
    return (out, torch.tensor([total], dtype=torch.int32),
            torch.from_numpy((st // 4 // C).astype(np.int32)))


ROUTES = {
    "bounded": ([r"ab[cd]{2,6}ef", r"[0-9]{3}-[0-9]{4}",
                 r"GET /[a-z]{1,12} "], [0, 0, 0], {}),
    "spec_dfa": ([r"\d+[a-z]{3,}\d+"], [hs.HS_FLAG_DOTALL], {}),
    "spec_nfa": ([r"(ax|by|cz|dw)+[!]"], [0], {"max_dfa_states": 8}),
}
ALPHA = np.frombuffer(b"aabxyz0123456789-cdefGET /!axbycz\x00\xff", np.uint8)
PLANTS = [b"abcdef", b"abddddef", b"555-1212", b"GET /index ", b"12abc34",
          b"9zzzzzzzz8", b"axby!", b"dwcz!", b"axaxbycz!"]


def _engines(route):
    pats, flags, g = ROUTES[route]
    g = dict(g, allow_teddy=False, host_scan_limit=0)
    ids = list(range(len(pats)))
    ref = ref_compile(pats, flags, ids, grey=RefGrey(**g)).engines[0]
    port = port_compile(pats, flags, ids, grey=PortGrey(**g)).engines[0]
    return ref, port


def _blocks(seed: int, sizes=(2600, 0, 1501, 7, 1700, 513)):
    rng = np.random.default_rng(seed)
    out = []
    for n in sizes:
        b = rng.choice(ALPHA, size=n).astype(np.uint8)
        for _ in range(n // 90):
            p = np.frombuffer(PLANTS[int(rng.integers(len(PLANTS)))],
                              np.uint8)
            off = int(rng.integers(0, max(1, n - len(p))))
            b[off:off + len(p)] = p[:n - off]
        out.append(b.tobytes())
    return out


def _recs(recs):
    return set(zip(*[np.asarray(a, np.int64).tolist() for a in recs]))


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_step_table_chain_equals_plain(route):
    _ref, eng = _engines(route)
    d = eng.spec_dfa if route == "spec_nfa" else eng
    H, CS = PDK.chunk_shape(d) if route == "bounded" else (0, PDK.SPEC_CS)
    blocks = _blocks(5)
    corpus, starts, lens = PT.flatten_blocks(blocks)
    entry = np.random.default_rng(6).integers(0, d.trans.shape[0],
                                              len(blocks))
    plan = PDK.plan_chunks(starts, lens, H, CS, entry, d.float_state)
    ct = torch.from_numpy(corpus)
    meta = torch.from_numpy(plan.meta)
    tabs = PDK.device_tables(d, "cpu")
    for cap in (1 << 16, 5):  # roomy, and past the cap (total exact)
        r_s, t_s, f_s = _step_table_scan(ct, tabs, meta, H, cap)
        r_p, t_p, f_p = PDK.dfa_scan_chunks_plain(ct, tabs, meta, H, cap)
        assert int(t_s) == int(t_p) > 5 and torch.equal(f_s, f_p)
        k = min(cap, int(t_p))
        if cap > int(t_p):
            assert set(map(tuple, r_s[:k].tolist())) == \
                set(map(tuple, r_p[:k].tolist()))


@pytest.mark.parametrize("route,carried", [("bounded", False),
                                           ("bounded", True),
                                           ("spec_dfa", True),
                                           ("spec_nfa", False)])
def test_step_table_chain_equals_reference(route, carried, monkeypatch):
    """The step-table chain in the kernel's place under the port's route
    functions equals the JAX package's scans (the DFA chunk kernel in
    Pallas interpret mode and its host chains)."""
    ref, eng = _engines(route)
    monkeypatch.setattr(PDK, "dfa_scan_chunks", _step_table_scan)
    blocks = _blocks(8)
    anch = np.asarray([True, False, True, False, True, False])
    init = (np.random.default_rng(9).integers(0, eng.num_states,
                                              len(blocks)).astype(np.int32)
            if carried else None)
    if route == "bounded":
        want, wfin = RDK.dfa_scan_corpus_device(ref, blocks, anch, 1 << 14,
                                                init)
        got, gfin = PDK.dfa_scan_corpus_device(eng, blocks, anch, 1 << 14,
                                               init, device="cpu")
    elif route == "spec_dfa":
        want, wfin = RDK.dfa_scan_corpus_device_speculative(
            ref, blocks, anch, 1 << 14, init)
        got, gfin = PDK.dfa_scan_corpus_device_speculative(
            eng, blocks, anch, 1 << 14, init, device="cpu")
    else:
        want, wh, wfin = RDK.nfa_scan_corpus_device_speculative(ref, blocks,
                                                                anch)
        got, gh, gfin = PDK.nfa_scan_corpus_device_speculative(
            eng, blocks, anch, device="cpu")

        def host(recs):
            return {(b, int(p), int(v)) for (b, pp, vv) in recs
                    for p, v in zip(pp, vv)}

        assert host(gh) == host(wh)
    assert _recs(got) == _recs(want) and len(_recs(want)) >= 10
    assert [int(f) for f in gfin] == [int(f) for f in np.asarray(wfin)]


def _tables(S: int, C: int, max_accept: int = 1) -> PDK.DfaTables:
    accept = torch.zeros(S, dtype=torch.int32)
    accept[-1] = max_accept
    return PDK.DfaTables(torch.zeros(S * C, dtype=torch.int32),
                         torch.zeros(256, dtype=torch.int32), accept, S, C)


@pytest.mark.parametrize("mode", ["chunks", "rows"])
@pytest.mark.parametrize("over", [False, True])
def test_placement_follows_each_mode_limit(mode, over):
    """By default a mode's tables go to shared memory up to that mode's
    limit (4-byte entries in the chunk scan, 8-byte in the row mode) and
    to global memory past it; asked for, either placement is taken."""
    C = 4
    S = PDK.TABLE_LIMITS[mode] // (PDK.ENTRY_BYTES[mode] * C) + int(over)
    tabs = _tables(S, C)
    assert tabs.step_bytes(mode) == PDK.ENTRY_BYTES[mode] * S * C
    want = "global" if over else "shared"
    assert PDK.placement_of(tabs, None, mode) == want
    assert PDK.placement_of(tabs, "global", mode) == "global"
    if mode == "rows" or 4 * S * C <= 1 << 16:
        assert PDK.placement_of(tabs, "shared", mode) == "shared"


@pytest.mark.parametrize("S,C,max_accept", [(8193, 2, 1), (4, 3, 1 << 16)])
def test_placement_past_the_chunk_packing(S, C, max_accept):
    """The chunk scan's shared entry holds 4 x next state x C and the
    accept id in 16 bits each: a DFA past either runs on global tables,
    asking it for shared ones raises, and the row mode is unaffected."""
    tabs = _tables(S, C, max_accept)
    assert PDK.placement_of(tabs, None, "chunks") == "global"
    with pytest.raises(ValueError):
        PDK.placement_of(tabs, "shared", "chunks")
    assert PDK.placement_of(tabs, "shared", "rows") == "shared"
    with pytest.raises(ValueError):
        PDK.placement_of(tabs, "texture", "rows")
