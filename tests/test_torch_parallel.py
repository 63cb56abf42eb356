"""The port's multi-device path against the JAX package's
(hyperscan_tpu_torch.parallel / ops.dfa / ops.match / ops.teddy_words vs
hyperscan_tpu.parallel / ops.dfa / ops.match / ops.teddy).

The JAX side runs as tests/test_parallel.py runs it: on the virtual
8-device CPU mesh of tests/conftest.py, its Pallas kernels in interpret
mode. The port runs on `make_mesh(8, device="cpu")`, where every wrapper
takes its kernel's plain PyTorch version. Inputs come from numpy seeds;
every value is an integer, so equality is exact.
"""

import numpy as np
import pytest
import torch

import hyperscan_tpu as hs
import hyperscan_tpu_torch as ht
import torch_ref_native  # noqa: F401 (the reference's native build, locked)
import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JMesh

from hyperscan_tpu import parallel as RP
from hyperscan_tpu.ops import dfa as RD
from hyperscan_tpu.ops import match as RM
from hyperscan_tpu.ops import teddy as RT
from hyperscan_tpu_torch import parallel as PP
from hyperscan_tpu_torch.errors import InvalidError
from hyperscan_tpu_torch.ops import dfa as PD
from hyperscan_tpu_torch.ops import dfa_kernel as DK
from hyperscan_tpu_torch.ops import match as PM
from hyperscan_tpu_torch.ops import teddy as PT
from hyperscan_tpu_torch.ops import teddy_families as PF
from hyperscan_tpu_torch.ops import teddy_words as TW
from hyperscan_tpu_torch.parallel import sharded as PS

ENGINE_PATS = [r"f[o0]+[a-z]+bar", r"x[0-9]+y", r"er+or"]
BLOCKS = [b"xx fooqqbar yy x123y", b"error and errors",
          b"nothing in here at all", b"fooabar" * 3, b"", b"x88y erroor"]


@pytest.fixture(scope="module")
def engine_dbs():
    ids = [10, 20, 30]
    ref = hs.compile_multi(ENGINE_PATS, ids=ids)
    port = ht.compile_multi(ENGINE_PATS, ids=ids)
    assert len(ref.engines) == len(port.engines) == 1
    return ref, port


def _meshes():
    rmesh = RP.make_mesh()
    assert rmesh.devices.size == 8
    return rmesh, PP.make_mesh(8, device="cpu")


def test_make_mesh_and_multihost():
    m = PP.make_mesh(3, device="cpu")
    assert m.devices.shape == (3,) and m.axis_names == (PP.SHARD_AXIS,)
    assert all(d == torch.device("cpu") for d in m.devices.flat)
    flat = PS._as_shard_mesh(PP.Mesh(np.array(["cpu"] * 8).reshape(2, 4),
                                     ("x", "y")))
    assert flat.devices.shape == (8,) and flat.axis_names == ("shards",)
    if torch.cuda.is_available():
        n = torch.cuda.device_count()
        assert PP.make_mesh().devices.size == n
        with pytest.raises(RuntimeError):
            PP.make_mesh(n + 1)
    else:
        with pytest.raises(RuntimeError):
            PP.make_mesh()
        with pytest.raises(RuntimeError):
            PP.make_multihost_mesh()
    # the multi-process form's argument errors raise before any init
    # (tests/test_torch_multihost.py runs two processes)
    for kw in ({"coordinator_address": "localhost:1234"},
               {"coordinator_address": "localhost:1234", "num_processes": 2},
               {"num_processes": 2, "process_id": 0},
               {"coordinator_address": "localhost:1234", "num_processes": 2,
                "process_id": 2},
               {"num_processes": 0}):
        with pytest.raises(ValueError):
            PP.make_multihost_mesh(device="cpu", **kw)
    one = PP.make_multihost_mesh(device="cpu", n_local=3)
    assert one.devices.size == 3 and one.local == [0, 1, 2]
    assert not one.distributed and one.backend is None
    # entries owned by another process are not this process's
    owned = PP.Mesh(["cpu"] * 4, ("s",), ranks=[1, 1, 0, 0])
    assert owned.local == [2, 3] and owned.first == torch.device("cpu")
    with pytest.raises(ValueError):
        PP.Mesh(["cpu"] * 2, ("s",), ranks=[1, 1])


def test_pad_batch_equals_reference():
    rmesh, pmesh = _meshes()
    a = RP.pad_batch_for_mesh(BLOCKS, rmesh, pad_len=128)
    b = PP.pad_batch_for_mesh(BLOCKS, pmesh, pad_len=128)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    sizes = [len(b) for b in BLOCKS] * 3 + [70_000, 1]
    blocks = [b"z" * s for s in sizes]
    assert PS.partition_blocks(blocks, 8) == \
        RP.sharded.partition_blocks(blocks, 8)


def test_sharded_counts_equal_reference(engine_dbs):
    """tests/test_parallel.py:51, on both packages."""
    ref, port = engine_dbs
    rmesh, pmesh = _meshes()
    data, lengths = RP.pad_batch_for_mesh(BLOCKS, rmesh, pad_len=128)
    want = RP.sharded_scan_counts(ref.engines[0], data, lengths, rmesh)
    got = PP.sharded_scan_counts(port.engines[0], data, lengths, pmesh)
    assert got == want > 0


def test_sharded_matches_equal_reference(engine_dbs):
    """tests/test_parallel.py:77: the gathered per-shard buffers are
    equal, and they hold the unsharded scan_batch's matches."""
    ref, port = engine_dbs
    rmesh, pmesh = _meshes()
    data, lengths = RP.pad_batch_for_mesh(BLOCKS, rmesh, pad_len=128)
    want = RP.sharded_scan_matches(ref.engines[0], data, lengths, rmesh,
                                   capacity=64)
    got = PP.sharded_scan_matches(port.engines[0], data, lengths, pmesh,
                                  capacity=64)
    for w, g in zip(want, got):
        assert g.device == torch.device("cpu")
        assert np.array_equal(np.asarray(w), g.numpy())
    totals, set_ids, rows, tos, _eod = (g.numpy() for g in got)
    e = port.engines[0]
    per = data.shape[0] // totals.shape[0]
    found = set()
    for chip in range(totals.shape[0]):
        for j in range(int(totals[chip])):
            for (eidx, adj) in e.expand_set(int(set_ids[chip, j])):
                found.add((chip * per + int(rows[chip, j]),
                           port.patterns[eidx].external_id,
                           int(tos[chip, j]) + adj))
    expect = {(bi, mid, to)
              for bi, ms in enumerate(ht.scan_batch(port, BLOCKS,
                                                    device="cpu"))
              for (mid, _f, to) in ms}
    assert found == expect and len(found) >= 6


def _lit_corpus(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    c = rng.integers(32, 127, n, dtype=np.uint8)
    # plants across both packages' shard edges and at the ends
    edges = {PS.segments(n, 8)[d][0] for d in range(1, 8)}
    edges |= {65536 * d for d in range(1, 8)}
    for off in sorted({0, 100, n - 10} | {e - 3 for e in edges}):
        if 0 <= off <= n - 6:
            c[off:off + 6] = np.frombuffer(b"attack", np.uint8)
    return c


@pytest.mark.parametrize("n", [
    3 * 65536 + 777,      # tests/test_parallel.py:121's length
    2 * 65536,            # on an edge of the reference's 64 KiB segments
    2 * 65536 + 1,        # just past it
    8 * 2048,             # on an edge of the port's segments
    8 * 2048 + 1,         # just past it
    100,                  # 16-byte port segments, the last one empty
])
def test_sharded_teddy_count_equals_reference(n):
    ref = hs.compile_multi([r"attack", r"needle", r"hayst"], ids=[1, 2, 3])
    port = ht.compile_multi([r"attack", r"needle", r"hayst"], ids=[1, 2, 3])
    assert np.array_equal(ref.lit.masks, port.lit.masks)
    rmesh, pmesh = _meshes()
    corpus = _lit_corpus(n, 5)
    want = RP.sharded_teddy_count(corpus, ref.lit.masks, rmesh)
    got = PP.sharded_teddy_count(corpus, port.lit.masks, pmesh)
    total, _pos, _w = TW.teddy_scan(corpus, port.lit.masks, device="cpu")
    assert got == want == total >= 2


def _product_db(pkg):
    pats = ["attack" + str(i) if i % 2 else rf"q{i}h[a-f0-9]{{4}}"
            for i in range(120)]
    return pkg.compile_multi(pats, ids=list(range(120)))


def test_sharded_scan_batch_product_path():
    """tests/test_parallel.py:143: scan_batch(mesh=) runs the literal
    pipeline sharded; the port's lists equal its unsharded scan and the
    reference's sharded scan."""
    ref, port = _product_db(hs), _product_db(ht)
    rng = np.random.default_rng(3)
    blocks = []
    for _b in range(19):
        c = (32 + rng.integers(
            0, 95, size=int(rng.integers(3000, 50000)))).astype(np.uint8)
        i = int(rng.integers(0, len(c) - 20))
        c[i:i + 8] = np.frombuffer(b"attack1 ", np.uint8)
        blocks.append(c.tobytes())
    rmesh, pmesh = _meshes()
    want = hs.scan_batch(ref, blocks, mesh=rmesh)
    single = ht.scan_batch(port, blocks, device="cpu")
    sharded = ht.scan_batch(port, blocks, mesh=pmesh)
    assert sharded == single
    assert [sorted(a) for a in sharded] == [sorted(b) for b in want]
    assert sum(len(x) for x in single) >= 19
    # the sharded literal path ran the port's family dispatcher on its
    # shards and learned its loads in the port's own state
    st = PF.family_state(port.lit)
    assert sum(st.dispatches.values()) >= 8 and st.obs
    assert "_cap_hints" not in port.lit.__dict__


def test_sharded_arbitrary_mesh_and_bucket_boundaries():
    """tests/test_parallel.py:169: a mesh of any shape and axis names
    flattens to the shard axis; blocks at the reference's bucket edges."""
    pats, ids = [r"foo\d+", r"\bbar", r"mark(ab|cd)*end"], [1, 2, 3]
    ref, port = hs.compile_multi(pats, ids=ids), \
        ht.compile_multi(pats, ids=ids)
    rng = np.random.default_rng(7)
    sizes = [100, 5000, 120000, 999, 1, 70000, 131072, 42]
    blocks = [(32 + rng.integers(0, 95, size=s)).astype(np.uint8).tobytes()
              + b" foo77 bar markcdabend" for s in sizes]
    want = [sorted(hs.scan(ref, b)) for b in blocks]
    rmesh = JMesh(np.array(jax.devices()).reshape(2, 4), ("x", "y"))
    assert [sorted(r) for r in hs.scan_batch(ref, blocks, mesh=rmesh)] \
        == want
    cpu8 = np.array([torch.device("cpu")] * 8, dtype=object)
    for shape, names in [((8,), ("d",)), ((2, 4), ("x", "y"))]:
        mesh = PP.Mesh(cpu8.reshape(shape), names)
        got = ht.scan_batch(port, blocks, mesh=mesh)
        assert [sorted(r) for r in got] == want
    assert sum(len(r) for r in want) >= 3 * len(blocks)


def test_threads_with_mesh_raise():
    """tests/test_api.py:287-290, on the port."""
    db = ht.compile_multi([r"attack\d"], ids=[1])
    with pytest.raises(InvalidError):
        ht.scan_batch(db, [b"attack1", b"x"], mesh=PP.make_mesh(2, "cpu"),
                      threads=2)


@pytest.mark.parametrize("device", ["cuda", "cuda:0", "meta"])
def test_mesh_with_other_device_raises(device):
    """A mesh decides where a scan runs: an explicit device other than
    the mesh's first raises, the same device or none is taken."""
    db = ht.compile_multi([r"attack\d"], ids=[1])
    mesh = PP.make_mesh(2, "cpu")
    with pytest.raises(InvalidError, match="mesh"):
        ht.scan_batch(db, [b"attack1", b"x"], mesh=mesh, device=device)
    want = [[(1, 0, 7)], []]
    assert ht.scan_batch(db, [b"attack1", b"x"], mesh=mesh) == want
    assert ht.scan_batch(db, [b"attack1", b"x"], mesh=mesh,
                         device="cpu") == want


class _Hints:
    """A bare object to learn capacities on."""


TEDDY_PATS = (["attack%d" % i for i in range(300)]  # W = 2 words
              + [r"payload%d[0-9]{2,4}z" % i for i in range(20)]
              + [r"\x00\x00ab%d" % i for i in range(5)]
              + [r"\xff\xfezz%d" % i for i in range(5)])


@pytest.fixture(scope="module")
def teddy_masks():
    ids = list(range(len(TEDDY_PATS)))
    masks = hs.compile_multi(TEDDY_PATS, ids=ids).lit.masks
    assert np.array_equal(masks, ht.compile_multi(TEDDY_PATS, ids=ids)
                          .lit.masks)
    assert masks.shape[1] > 1 and (masks < 0).any()  # words, sign bits
    return masks


@pytest.mark.parametrize("n", [70_144, 70_003])
def test_teddy_scan_equals_reference(teddy_masks, n):
    """Port teddy_scan against JAX teddy_scan: (total, pos, words) equal,
    across a capacity overflow that both learn. The reference's total
    also counts candidates in the zero padding past n inside the last
    256-byte chunk (stragglers its callers bounds-check), so at an
    unaligned n those are dropped from its lists first."""
    masks = teddy_masks
    rng = np.random.default_rng(11)
    corpus = rng.integers(0, 256, n).astype(np.uint8)
    corpus[rng.random(n) < 0.3] = ord("a")
    for off in range(0, n - 16, 997):
        corpus[off:off + 5] = np.frombuffer(b"\x00\x00ab3", np.uint8)
    corpus[:3] = np.frombuffer(b"ab3", np.uint8)  # zero bytes before 0
    rh, ph = _Hints(), _Hints()
    for _rep in range(2):  # overflow and learn, then reuse the hint
        r_tot, r_pos, r_words = RT.teddy_scan(corpus, masks, 8, hint_obj=rh)
        r_pos, r_words = np.asarray(r_pos), np.asarray(r_words)
        keep = r_pos < n
        p_tot, p_pos, p_words = TW.teddy_scan(corpus, masks, 8,
                                              hint_obj=ph, device="cpu")
        assert p_tot == int(keep.sum()) > 8
        if n % 256 == 0:
            assert p_tot == r_tot
        assert np.array_equal(p_pos, r_pos[keep])
        assert np.array_equal(p_words, r_words[:, keep])
        assert p_pos[0] == 2 and p_words.dtype == np.int32
        assert PT.get_capacity_hint(ph, TW.HINT_KEY) == \
            rh._cap_hints["teddy"][0]


def test_teddy_words_modes_and_lookback(teddy_masks):
    """Count mode over a tail after a look-back head equals the list's
    count; list mode clamps at cap but never loses the count."""
    masks = PT.mask_tables(teddy_masks, "cpu")
    rng = np.random.default_rng(2)
    c = rng.integers(0, 256, 3 * PT.CELL + 5).astype(np.uint8)
    for off in range(0, len(c) - 9, 1001):
        c[off:off + 8] = np.frombuffer(b"attack%02d" % (off % 97), np.uint8)
    c = torch.from_numpy(c)
    counts, pos, words = TW.filter_words_plain(c, masks)
    assert counts.sum() == pos.numel() > 100
    for start in (0, 7, PT.CELL + 3):
        cnt, segs = TW.filter_words_count(c, masks, start, segments=True)
        keep = pos >= start
        assert int(cnt.sum()) == int(segs.sum()) == int(keep.sum()) > 5
        p, w = TW.filter_words_list(c, masks, segs, 5, start)
        assert torch.equal(p, (pos[keep] - start)[:5].int())
        assert torch.equal(w, words[:, keep][:, :5])
    segs = TW.filter_words_count(c, masks, segments=True)[1]
    p, w = TW.filter_words_list(c, masks, segs, pos.numel() + 3)
    assert torch.equal(p[:-3], pos) and torch.equal(w[:, :-3], words)
    assert not p[-3:].any() and not w[:, -3:].any()  # 0 past the total


@pytest.fixture(scope="module")
def dfa_engines():
    sets = [ENGINE_PATS, [r"ab[cd]{2,6}ef", r"[0-9]{3}-[0-9]{4}$",
                          r"GET /[a-z]{1,12} "]]
    out = []
    for pats in sets:
        ref = hs.compile_multi(pats, ids=list(range(len(pats))))
        port = ht.compile_multi(pats, ids=list(range(len(pats))))
        out.append((ref.engines[0], port.engines[0]))
    return out


def _dfa_batch(B: int, L: int, seed: int):
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"abcdef0123456789-GET /xyfoobarerr\n",
                          np.uint8)
    data = alpha[rng.integers(0, len(alpha), (B, L))]
    plant = np.frombuffer(b"fooqqbar x123y erroor abccef 555-1212\n"
                          b"GET /abc ", np.uint8)
    for b in range(B):  # some across a 512-byte chunk edge
        for off in (int(rng.integers(0, L - 50)), 490, 1010):
            data[b, off:off + len(plant)] = plant
    lengths = rng.integers(0, L + 1, B).astype(np.int32)
    lengths[:3] = [L, 0, 1]
    return data, lengths


@pytest.mark.parametrize("which", [0, 1])
@pytest.mark.parametrize("init", ["scalar", "rows"])
def test_dfa_scan_batch_and_matches_equal_reference(dfa_engines, which,
                                                    init):
    """dfa_scan_batch (the lockstep loop, and kernel C's row mode over
    the engine's device tables, whose CPU branch is the plain version),
    extract_matches and count_matches against the reference, with rows
    shorter than L."""
    r_eng, p_eng = dfa_engines[which]
    B, L = 12, 1100  # rows of length 0, 1 and L among them
    data, lengths = _dfa_batch(B, L, 3 + which)
    S = r_eng.trans.shape[0]
    init_state = (int(r_eng.start_state) if init == "scalar" else
                  np.random.default_rng(9).integers(0, S, B)
                  .astype(np.int32))
    ra, rf = RD.dfa_scan_batch(
        jnp.asarray(r_eng.trans),
        jnp.asarray(r_eng.byte_to_class.astype(np.int32)),
        jnp.asarray(r_eng.accept_id), jnp.asarray(init_state),
        jnp.asarray(data), jnp.asarray(lengths))
    ra, rf = np.asarray(ra), np.asarray(rf)
    tabs = DK.device_tables(p_eng, "cpu")
    d_t, l_t = torch.from_numpy(data), torch.from_numpy(lengths)
    i_t = torch.as_tensor(init_state)
    pa, pf = PD.dfa_scan_batch(tabs.trans.view(tabs.S, tabs.C), tabs.b2c,
                               tabs.accept, i_t, d_t, l_t)
    ca, cf = PD.dfa_scan_rows(tabs, i_t, d_t, l_t)
    for a, f in ((pa, pf), (ca, cf)):
        assert a.dtype == torch.int32 and f.dtype == torch.int32
        assert np.array_equal(a.numpy(), ra)
        assert np.array_equal(f.numpy(), rf)
    n_acc = int((ra != 0).sum())
    assert n_acc > 4
    assert int(PM.count_matches(pa)) == int(RM.count_matches(jnp.asarray(ra)))
    for cap in (n_acc + 7, n_acc // 2):
        want = RM.extract_matches(jnp.asarray(ra), cap)
        got = PM.extract_matches(pa, cap)
        for w, g in zip(want, got):
            assert np.array_equal(np.asarray(w), g.numpy())


def test_sharded_scan_batch_engine_half_scans_every_block():
    """With the literal half sharded the engine prefilter hits are not
    collected, so a prefilter-gated engine scans every block
    (reference: hyperscan_tpu/runtime/scan.py:266): the port's sharded
    lists equal its unsharded ones and the reference's sharded ones."""
    from hyperscan_tpu.database import compile_patterns as ref_compile
    from hyperscan_tpu.grey import Grey as RefGrey
    from hyperscan_tpu_torch.database import compile_patterns
    from hyperscan_tpu_torch.grey import Grey

    alts = "|".join(f"token{i:03d}" for i in range(80))  # > 510 positions
    pats = [f"headmagic({alts})*tailmagic", "plainword1"]
    ref = ref_compile(pats, ids=[1, 2], grey=RefGrey(host_scan_limit=1 << 10))
    port = compile_patterns(pats, ids=[1, 2],
                            grey=Grey(host_scan_limit=1 << 10))
    assert port.engines and port.lit is not None
    filler = b"." * 30_000
    hit = b"." * 500 + b"headmagictoken007token042tailmagic" + b"." * 466
    blocks = [filler, hit, filler, b"." * 1000 + b"plainword1", filler + hit]
    rmesh, pmesh = _meshes()
    single = ht.scan_batch(port, blocks, device="cpu")
    assert ht.scan_batch(port, blocks, mesh=pmesh) == single
    assert single == hs.scan_batch(ref, blocks, mesh=rmesh)
    assert [len(x) for x in single] == [0, 1, 0, 1, 1]
