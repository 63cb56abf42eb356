"""The port's four literal families against the JAX package's
(hyperscan_tpu_torch.ops.teddy_families and the kernel modules below it
vs hyperscan_tpu.ops.teddy): gated
two-stage, ungated compact, kconfirm (in-kernel confirm) and dense
extraction, and the choice between them.

The same numpy-seeded inputs go through both packages: the JAX side as
its own tests run it (Pallas in interpret mode on the CPU, its family
forced with its own knobs), the port on its plain PyTorch versions (what
a CPU tensor takes), its family forced with `force_family`. Every value
is an integer, so every comparison is exact, as integers and as sets.
"""

import numpy as np
import pytest
import torch

import hyperscan_tpu as hs
import hyperscan_tpu_torch as ht
import torch_ref_native  # noqa: F401 (the reference's native build, locked)
import jax.numpy as jnp

from hyperscan_tpu.database import compile_patterns as ref_compile
from hyperscan_tpu.grey import Grey as RefGrey
from hyperscan_tpu.ops import teddy as RT
from hyperscan_tpu.runtime.lit_runtime import verify_pairs as ref_verify
from hyperscan_tpu_torch.database import compile_patterns as port_compile
from hyperscan_tpu_torch.grey import Grey as PortGrey
from hyperscan_tpu_torch.ops import extract as PX
from hyperscan_tpu_torch.ops import teddy as PT
from hyperscan_tpu_torch.ops import teddy_families as PF
from hyperscan_tpu_torch.ops import teddy_gate as PG
from hyperscan_tpu_torch.ops import teddy_kconfirm as PK
from hyperscan_tpu_torch.runtime.lit_runtime import verify_pairs

Z = np.zeros(1, np.int64)
WORDS = ["attack", "payload", "shell", "admin", "select", "union"]
# a multi-word plan (W >= 2): the compiler builds the gate tables for it
GATED_PATS = [WORDS[i % 6] + str(i) + "zq" for i in range(600)]
# the JAX package's kconfirm test ruleset (tests/test_kconfirm.py:17)
KC_PATS = (["attack%d" % i for i in range(40)]
           + [r"payload%d[0-9]{2,4}z" % i for i in range(30)]
           + [r"q%dh[a-f0-9]{8}" % i for i in range(30)])


def _both(pats, flags=None, grey=None):
    ids = list(range(len(pats)))
    flags = [0] * len(pats) if flags is None else flags
    ref = ref_compile(pats, flags, ids, grey=RefGrey(**(grey or {})))
    port = port_compile(pats, flags, ids, grey=PortGrey(**(grey or {})))
    return ref, port


@pytest.fixture(scope="module")
def gated():
    ref, port = _both(GATED_PATS)
    assert ref.lit.gate_masks is not None
    assert np.array_equal(ref.lit.gate_masks, port.lit.gate_masks)
    return ref, port


@pytest.fixture(scope="module")
def kc():
    return _both(KC_PATS)


def _printable(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (32 + rng.integers(0, 95, size=n)).astype(np.uint8)


def _plant(corpus, plants, offs):
    for k, off in enumerate(offs):
        p = plants[k % len(plants)]
        corpus[off:off + len(p)] = np.frombuffer(p, np.uint8)
    return corpus


def _rows(corpus):
    return jnp.asarray(RT.corpus_to_rows(corpus))


def _set(f, p) -> set:
    return set(zip(np.asarray(f).tolist(), np.asarray(p).tolist()))


def _ref_run(lit, corpus, rows=None):
    """Reference start + finish: (handle, hash-matched set, verified)."""
    h = RT.teddy_confirm_start(_rows(corpus) if rows is None else rows, lit,
                               len(corpus))
    f, p = RT.teddy_confirm_finish(h)
    f, p = np.asarray(f), np.asarray(p)
    return h, _set(f, p), _set(*ref_verify(lit, corpus, Z, f, p))


def _port_run(lit, corpus, family):
    """Port start + finish with `family` forced: (family that ran first,
    hash-matched set, verified set)."""
    PF.force_family(lit, family)
    h = PF.confirm_start(torch.from_numpy(corpus), lit, len(corpus))
    f, p = PF.confirm_finish(h)
    return h.family, _set(f, p), _set(*verify_pairs(lit, corpus, Z, f, p))


def _gate_numpy(lit, corpus) -> np.ndarray:
    """Row flags of the byte-level gate: AND_m gate_masks[m, 0, byte p-m]
    over positions p < n, zero bytes before offset 0."""
    M = lit.gate_masks.shape[0]
    g = lit.gate_masks[:, 0, :].view(np.uint32)
    pad = np.concatenate([np.zeros(M - 1, np.uint8), corpus])
    n = len(corpus)
    acc = np.full(n, 0xFFFFFFFF, np.uint32)
    for m in range(M):
        acc &= g[m][pad[M - 1 - m:M - 1 - m + n]]
    hit = np.concatenate([acc != 0, np.zeros(-n % 128, bool)])
    return hit.reshape(-1, 128).any(1)


# --- gated ------------------------------------------------------------------


@pytest.mark.parametrize("n", [1 << 18, (1 << 17) + 77])
def test_gate_rows_equal_reference(gated, n):
    """Port row flags == the byte-level gate over lit.gate_masks; a row
    whose flag is 0 holds no full-filter candidate; port K == reference K.
    The reference's last partial row also sees the zero padding past
    n_valid, so K is compared only where n is a multiple of 128."""
    ref, port = gated
    corpus = _plant(_printable(n, 1), [b"attack0zq ", b"union5zq"],
                    [0, 126, 5000, n - 20])
    ct = torch.from_numpy(corpus)
    gt = PG.device_gate_table(port.lit, "cpu")
    flags, counts = PG.gate_rows(ct, gt)
    want = _gate_numpy(port.lit, corpus)
    n_rows = len(want)
    assert flags.shape == (PT._n_cells(n) * 512,)
    assert np.array_equal(flags[:n_rows].numpy() != 0, want)
    assert int(flags[n_rows:].sum()) == 0
    assert int(counts.sum()) == int(want.sum()) > 0
    ft, _ct = PT.device_tables(port.lit, "cpu")
    pos, cnt = PT.filter_compact(ct, ft, 4096, use_classes=True)
    cand = np.concatenate([pos[c, :int(cnt[c])].numpy()
                           for c in range(len(cnt))])
    assert len(cand) and want[cand // 128].all()  # the gate is a superset
    if n % 128 == 0:
        h = RT.teddy_confirm_start(_rows(corpus), ref.lit, n)
        assert h[7] is True
        assert int(np.asarray(h[4])[4]) == int(counts.sum())


def test_gated_equals_ungated_and_reference(gated):
    """Mirror of tests/test_literal_path.py:357: plants straddle 128-byte
    rows; port gated == port compact == reference gated, hash-matched and
    verified."""
    ref, port = gated
    corpus = _plant(_printable(300_000, 4),
                    [b"attack0zq ", b"payload13zq!", b"union5zq"],
                    [0, 122, 250, 384, 6000, 131_070, 299_980])
    h, r_hash, r_ver = _ref_run(ref.lit, corpus)
    assert h[7] is True
    fam, g_hash, g_ver = _port_run(port.lit, corpus, None)
    assert fam == "gated"
    _fam, u_hash, u_ver = _port_run(port.lit, corpus, "compact")
    assert g_hash == u_hash == r_hash
    assert g_ver == u_ver == r_ver and len(r_ver) >= 7
    # the survivor-row rescan equals the full filter, cell by cell
    ct = torch.from_numpy(corpus)
    ft, _ct = PT.device_tables(port.lit, "cpu")
    flags, _k = PG.gate_rows(ct, PG.device_gate_table(port.lit, "cpu"))
    a = PG.rescan_rows(ct, ft, flags, 64)
    b = PT.filter_compact(ct, ft, 64, use_classes=True)
    assert torch.equal(a[1], b[1]) and torch.equal(a[0], b[0])


def _row_flood():
    """A plant every 128-byte row for 1024 rows of 2^18 bytes."""
    corpus = np.full(1 << 18, ord("."), dtype=np.uint8)
    return _plant(corpus, [b"attack0zq"],
                  [r * 128 + 40 for r in range(1024)])


def test_gated_overflow_grows(monkeypatch):
    """Mirror of tests/test_literal_path.py:400 (the gate switch off):
    the gated dispatch overflows its capacities, dispatches again on the
    device at learned sizes and loses nothing."""
    monkeypatch.setattr(PF, "GATE_ROW_FRAC", 1.0)
    port = ht.compile_multi(GATED_PATS, ids=list(range(600)))
    corpus = _row_flood()
    fam, _hash, ver = _port_run(port.lit, corpus, None)
    assert fam == "gated"
    assert len(ver) == 1024
    t1, h1, t2 = PF.family_state(port.lit).obs["gated"]
    cap1, capc, cap2 = PF._caps_for(port.lit, 1 << 14, "gated")
    assert h1 == 512 and capc >= h1 and cap1 >= t1 >= 1024 and cap2 >= t2


def test_gate_switch_follows_reference():
    """Mirror of tests/test_literal_path.py:429: the same corpus sequence
    flips both packages from gated to ungated after the same scan."""
    ref = hs.compile_multi(GATED_PATS, ids=list(range(600)))
    port = ht.compile_multi(GATED_PATS, ids=list(range(600)))
    corpus = _row_flood()
    rows = _rows(corpus)
    seq_r, seq_p, sets = [], [], []
    for _ in range(2):
        h, _r_hash, r_ver = _ref_run(ref.lit, corpus, rows)
        seq_r.append("gated" if h[7] else "ungated")
        fam, _p_hash, p_ver = _port_run(port.lit, corpus, None)
        seq_p.append("gated" if fam == "gated" else "ungated")
        sets += [r_ver, p_ver]
    assert seq_r == seq_p == ["gated", "ungated"]
    assert PF.family_state(port.lit).gate_rate > PF.GATE_ROW_FRAC
    assert all(s == sets[0] for s in sets) and len(sets[0]) == 1024


def test_ungated_follows_reference_without_gate():
    """The "ungated" knob against the reference with its gate tables
    cleared (tests/test_literal_path.py:386): a gated database takes the
    reference's rules without the gated family, so the same families in
    the same order (compact, then kconfirm once the mean cell load
    reaches KCONF_MIN_MEAN) and the verified pairs of the gated family."""
    ref, port = _both(GATED_PATS)
    corpus = _plant(_printable(1 << 17, 12), [b"attack0zq ", b"union5zq "],
                    range(0, 1 << 17, 2048))
    fam, _h, want = _port_run(port.lit, corpus, "gated")
    assert fam == "gated" and len(want) == 64
    ref.lit.gate_masks = None
    ref.lit._dev_gate = None
    rows = _rows(corpus)
    seq_r, seq_p = [], []
    for _ in range(2):
        h, _r_hash, r_ver = _ref_run(ref.lit, corpus, rows)
        assert h[7] is False
        seq_r.append("kconfirm" if h[8] else "compact")
        fam, _p_hash, p_ver = _port_run(port.lit, corpus, "ungated")
        seq_p.append(fam)
        assert p_ver == r_ver == want
    assert seq_r == seq_p == ["compact", "kconfirm"]


def test_load_reference_keeps_gate(gated):
    """Mirror of tests/test_literal_path.py:467: a gated database
    serialized by the JAX package keeps its gate tables in the port and
    takes the gated family."""
    ref, _port = gated
    db = ht.load_reference(ref.serialize())
    assert np.array_equal(db.lit.gate_masks, ref.lit.gate_masks)
    corpus = _plant(_printable(1 << 17, 6), [b"attack0zq"], [500, 70_000])
    fam, _h, ver = _port_run(db.lit, corpus, None)
    assert fam == "gated"
    assert {p for (_f, p) in ver} == {508, 70_008}


# --- dense ------------------------------------------------------------------


@pytest.mark.parametrize("cap1", [64, 4096])
def test_plane_extract_equals_sparse_extract(cap1):
    rng = np.random.default_rng(2)
    N = 256 * 700
    plane = (rng.random(N) < 0.004).astype(np.uint8)
    plane[20_000:20_600] = rng.integers(0, 3, 600)  # a dense stretch
    n_valid = N - 1000  # chunks wholly past it are not counted
    meta_r, packed_r = RT.sparse_extract([], n_valid, cap1, 700,
                                         nz=jnp.asarray(plane), chunk=256)
    meta_p, pos_p = PX.plane_extract(torch.from_numpy(plane), n_valid, cap1)
    meta_r = np.asarray(meta_r).tolist()
    assert meta_p.tolist() == meta_r
    k = min(meta_r[0], cap1)
    assert pos_p[:k].tolist() == np.asarray(packed_r)[0, :k].tolist()
    assert (pos_p[k:] == -1).all()


def test_filter_plane_equals_reference_candidates(gated):
    ref, port = gated
    n = 70_001
    corpus = _plant(_printable(n, 8), [b"shell2zq", b"admin3zq"], [0, 3000])
    total, pos, _w = RT.teddy_scan_rows(_rows(corpus),
                                        jnp.asarray(ref.lit.masks), n)
    pos = np.asarray(pos)[:min(int(total), len(pos))]
    want = sorted(int(p) for p in pos if p < n)
    ft, _ct = PT.device_tables(port.lit, "cpu")
    plane = PT.filter_plane(torch.from_numpy(corpus), ft, use_classes=True)
    assert plane.numel() == PT.plane_len(n) and plane.numel() % 256 == 0
    assert torch.nonzero(plane).squeeze(1).tolist() == want


def test_dense_equals_compact_and_reference():
    """Mirror of tests/test_literal_path.py:483."""
    ref, port = _both(["needleZ", "probeQ"])
    corpus = _plant(_printable(200_000, 11), [b"probeQ", b"needleZ"],
                    [0, 120, 127, 65_520, 65_533, 131_000, 199_990])
    ref.lit._dense_extract = True
    h, r_hash, r_ver = _ref_run(ref.lit, corpus)
    assert h[6] is True
    fam, d_hash, d_ver = _port_run(port.lit, corpus, "dense")
    assert fam == "dense"
    _f, c_hash, c_ver = _port_run(port.lit, corpus, "compact")
    assert d_hash == c_hash == r_hash
    assert d_ver == c_ver == r_ver and len(r_ver) >= 7


def test_flood_demotes_to_dense():
    """Mirror of tests/test_literal_path.py:516: every position a
    candidate; both packages demote to dense and find n - 3 matches."""
    ref, port = _both(["aaaa"])
    corpus = np.full(1 << 17, ord("a"), dtype=np.uint8)
    _h, _r_hash, r_ver = _ref_run(ref.lit, corpus)
    assert getattr(ref.lit, "_dense_extract", False) is True
    fam, _p_hash, p_ver = _port_run(port.lit, corpus, None)
    assert fam == "compact" and PF.family_state(port.lit).dense
    assert p_ver == r_ver and len(p_ver) == len(corpus) - 3
    fam2, _h2, again = _port_run(port.lit, corpus, None)
    assert fam2 == "dense" and again == p_ver


# --- kconfirm ---------------------------------------------------------------


def _ref_kconfirm(lit, corpus, mean=None):
    lit._kconfirm_off = False
    lit._kconfirm_force = True
    lit.__dict__.pop("_kc_force_capc", None)
    if mean is None:
        lit.__dict__.pop("_kc_mean", None)
    else:
        lit._kc_mean = mean
    try:
        h, r_hash, r_ver = _ref_run(lit, corpus)
    finally:
        lit._kconfirm_force = False
    assert h[8]
    sidecar = int(np.asarray(h[4])[4])  # candidates re-confirmed outside
    return sidecar, r_hash, r_ver


def test_kconfirm_hash_matched_equals_reference(kc):
    """Mirror of tests/test_kconfirm.py:47. No cell passes the
    reference's capc (its sidecar stays idle), so the hash-matched sets
    are equal; the verified sets are equal across all four families."""
    ref, port = kc
    n = (1 << 18) + 333
    corpus = _plant(_printable(n, 11),
                    [b" attack7 payload12345z q3hdeadbeef attack39 "],
                    [0, 5000, 70000, n - 46])
    sidecar, r_hash, r_ver = _ref_kconfirm(ref.lit, corpus)
    assert sidecar == 0
    fam, k_hash, k_ver = _port_run(port.lit, corpus, "kconfirm")
    assert fam == "kconfirm"
    assert k_hash == r_hash and k_ver == r_ver and len(r_ver) >= 8
    for family in ("compact", "dense"):
        assert _port_run(port.lit, corpus, family)[2] == k_ver


def test_kconfirm_hot_cell(kc):
    """Mirror of tests/test_kconfirm.py:76: one dense cell; the
    reference re-confirms it through its sidecar (other false positives),
    so the verified sets are compared."""
    ref, port = kc
    n = 1 << 19
    corpus = _printable(n, 5)
    hot = b" attack7 payload3 55z q9hbeef01 " * 40
    corpus[70000:70000 + len(hot)] = np.frombuffer(hot, np.uint8)
    sidecar, _r_hash, r_ver = _ref_kconfirm(ref.lit, corpus, mean=1.0)
    assert sidecar > 0
    fam, _k_hash, k_ver = _port_run(port.lit, corpus, "kconfirm")
    assert fam == "kconfirm"
    assert k_ver == r_ver and len(k_ver) >= 100


def test_kconfirm_capc2_flood_demotes():
    """Mirror of tests/test_kconfirm.py:128: a flood of real matches (a
    cell with more than CAPC2 of them, and more than CAPC_MAX candidates)
    demotes kconfirm; the re-dispatched scan loses nothing, and the next
    start takes the same family in both packages (dense), kconfirm still
    forced."""
    ref, port = _both(KC_PATS)
    corpus = np.frombuffer(b" attack7 " * 12000, np.uint8).copy()
    _sc, _r_hash, r_ver = _ref_kconfirm(ref.lit, corpus)
    ref.lit._kconfirm_force = True
    h2 = RT.teddy_confirm_start(_rows(corpus), ref.lit, len(corpus))
    assert not h2[8] and h2[6]
    fam, _h, ver = _port_run(port.lit, corpus, "kconfirm")
    st = PF.family_state(port.lit)
    assert fam == "kconfirm" and st.kconfirm_off and st.dense
    fam2, _h2, ver2 = _port_run(port.lit, corpus, "kconfirm")
    assert fam2 == "dense"
    assert ver == ver2 == r_ver and len(ver) >= 10000


def test_kconfirm_many_groups():
    """Many confirm groups (tail lengths 1-8, caseless masks) in place
    of the reference's TPU-only per-group probe path (test_kconfirm.py:
    104): hash-matched sets equal the reference kconfirm's."""
    pats = ["x", "qz", "jkq", "wvut", "mnopq", "rstuvw", "abcdefg",
            "hijklmno", "payload77", "zz9", "KqV", "vAx"]
    flags = [0] * 10 + [hs.HS_FLAG_CASELESS] * 2
    ref, port = _both(pats, flags)
    kt = PK.confirm_planes(port.lit, "cpu")
    assert len(kt.groups) >= 6
    rng = np.random.default_rng(17)
    corpus = rng.choice(np.frombuffer(b"abcdefghijklmnopqrstuvwxyzKQVAX9 ",
                                      np.uint8), size=(1 << 17) + 99)
    corpus = _plant(corpus, [b" payload77 ", b"hijklmno", b"KQv", b"rstuvw"],
                    [100, 40000, 90000, 130000])
    sidecar, r_hash, r_ver = _ref_kconfirm(ref.lit, corpus)
    fam, k_hash, k_ver = _port_run(port.lit, corpus, "kconfirm")
    assert fam == "kconfirm" and k_ver == r_ver and len(r_ver) > 50
    if sidecar == 0:
        assert k_hash == r_hash
    assert _port_run(port.lit, corpus, "compact")[2] == k_ver


# --- the choice, fetch_many, the API ----------------------------------------


def test_kconfirm_chosen_by_mean_load():
    """Unforced: a mean cell load of KCONF_MIN_MEAN or more, observed on
    one scan, selects kconfirm from the next start in both packages."""
    ref, port = _both(KC_PATS)
    corpus = _plant(_printable(1 << 17, 3), [b"attack1 "],
                    range(0, 1 << 17, 2048))
    rows = _rows(corpus)
    seq_r, seq_p = [], []
    for _ in range(2):
        h, _r_hash, r_ver = _ref_run(ref.lit, corpus, rows)
        seq_r.append("kconfirm" if h[8] else "compact")
        fam, _p_hash, p_ver = _port_run(port.lit, corpus, None)
        seq_p.append(fam)
        assert p_ver == r_ver and len(p_ver) == 64
    assert PF.family_state(port.lit).kc_mean >= PF.KCONF_MIN_MEAN
    assert seq_r == seq_p == ["compact", "kconfirm"]


def test_fetch_many_equals_per_scan_finish(gated):
    """Mirror of tests/test_literal_path.py:199."""
    _ref, port = gated
    lit = port.lit
    corpora = [_plant(_printable(40_000 + s, 9 + s), [b"attack0zq"],
                      [100 + s]) for s in range(3)]
    for family in ("gated", "kconfirm", "dense"):
        PF.force_family(lit, family)
        handles = [PF.confirm_start(torch.from_numpy(c), lit, len(c))
                   for c in corpora]
        gots = PF.confirm_fetch_many(handles)
        for h, g, c in zip(handles, gots, corpora):
            a = _set(*PF.confirm_finish(h, got=g))
            b = _set(*PF.confirm_scan(torch.from_numpy(c), lit, len(c)))
            assert a == b and len(a) >= 1
    assert PF.confirm_fetch_many([]) == []


_API_PATS = GATED_PATS[:300] + [r"shell%d[0-9]{2,4}zq" % i for i in range(20)]
_API = {}  # som -> (reference db, port db, reference results)


def _api_case(som: bool):
    if som not in _API:
        flags = [hs.HS_FLAG_SOM_LEFTMOST if som else 0] * len(_API_PATS)
        ref, port = _both(_API_PATS, flags, {"host_scan_limit": 0})
        assert port.lit is not None and not port.engines
        assert port.lit.gate_masks is not None
        blocks = [_plant(_printable(70_000, 20 + k),
                         [b"attack0zq ", b"shell3123zq", b"union11zq"],
                         [0, 127, 65_530, 69_980]).tobytes()
                  for k in range(2)]
        _API[som] = (port, blocks, hs.scan(ref, blocks[0]),
                     hs.scan_batch(ref, blocks))
    return _API[som]


@pytest.mark.parametrize("som", [False, True])
@pytest.mark.parametrize("family", list(PF.FAMILIES))
def test_api_scan_each_family_equals_reference(family, som):
    port, blocks, want1, want = _api_case(som)
    PF.force_family(port.lit, family)
    assert ht.scan(port, blocks[0], device="cpu") == want1
    assert ht.scan_batch(port, blocks, device="cpu") == want
    assert len(want1) >= 4
    if som:
        assert any(f > 0 for (_e, f, _t) in want1)


def test_force_family_rejects_unknown_and_missing_tables():
    port = ht.compile_multi(["needleZ"], ids=[1])
    with pytest.raises(ValueError, match="unknown"):
        PF.force_family(port.lit, "sparse")
    PF.force_family(port.lit, "gated")  # no gate tables for one word
    with pytest.raises(ValueError, match="gate"):
        PF.confirm_start(torch.zeros(100, dtype=torch.uint8), port.lit, 100)
