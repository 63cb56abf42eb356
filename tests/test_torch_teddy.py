"""The port's Teddy filter, compaction and hash confirm against the JAX
package (hyperscan_tpu_torch.ops.teddy vs hyperscan_tpu.ops.teddy).

Both packages compile the same rulesets; inputs come from a numpy seed.
The JAX side runs as its own tests run it: Pallas in interpret mode on
the CPU. Both packages have the literal family forced to ungated compact
+ hash confirm (tests/test_torch_families.py covers the other three).
The port runs its plain PyTorch versions, which is what a CPU tensor
takes. Every value is an integer, so equality is exact.

Two known differences are not faults: the reference's raw candidate
totals count candidates in the zero padding past n_valid, so candidate
SETS over p < n_valid are compared; and pairs are compared as sets.
"""

import numpy as np
import pytest
import torch

import hyperscan_tpu as hs
import hyperscan_tpu_torch as ht
import torch_ref_native  # noqa: F401 (the reference's native build, locked)
import jax.numpy as jnp

from hyperscan_tpu.ops import teddy as RT
from hyperscan_tpu.runtime.lit_runtime import verify_pairs as ref_verify
from hyperscan_tpu_torch.ops import teddy as PT
from hyperscan_tpu_torch.ops import teddy_families as PF
from hyperscan_tpu_torch.runtime.lit_runtime import verify_pairs

# literal vocabulary + NUL/0xFF bytes inside factors, so the zero bytes
# before offset 0 and high bytes reach the tables
PATS = (["attack%d" % i for i in range(30)]
        + [r"payload%d[0-9]{2,4}z" % i for i in range(20)]
        + [r"q%dh[a-f0-9]{8}" % i for i in range(20)]
        + [r"\x00\x00ab%d" % i for i in range(5)]
        + [r"\xff\xfezz%d" % i for i in range(5)]
        + [r"x%d(GET|POST) /[a-z]{1,9}" % i for i in range(10)])
PLANT = (b" attack7 payload12345z q3hdeadbeef attack29 \x00\x00ab3"
         b" \xff\xfezz4 x5GET /abc ")


def force_ungated_compact(lit) -> None:
    """Pin the reference to the ungated compact + hash-confirm family."""
    lit._gate_rate = 1.0
    lit._kconfirm_off = True
    lit._dense_extract = False


@pytest.fixture(scope="module")
def dbs():
    ids = list(range(len(PATS)))
    ref = hs.compile_multi(PATS, ids=ids)
    port = ht.compile_multi(PATS, ids=ids)
    force_ungated_compact(ref.lit)
    PF.force_family(port.lit, "compact")
    return ref, port


def _corpus(seed: int, n: int, kind: str) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "printable":
        c = (32 + rng.integers(0, 95, size=n)).astype(np.uint8)
    else:  # binary: NUL / 0xFF runs among random bytes
        c = rng.integers(0, 256, size=n).astype(np.uint8)
        c[rng.random(n) < 0.2] = 0
        c[rng.random(n) < 0.1] = 0xFF
    p = np.frombuffer(PLANT, np.uint8)
    for off in (0, 1, 127, 65_530, n - len(p)):
        if 0 <= off <= n - len(p):
            c[off:off + len(p)] = p
    return c


def _ref_candidates(lit, corpus: np.ndarray) -> set:
    n = len(corpus)
    total, pos, _w = RT.teddy_scan_rows(
        jnp.asarray(RT.corpus_to_rows(corpus)), jnp.asarray(lit.masks), n)
    pos = np.asarray(pos)[:min(total, len(pos))]
    return set(int(p) for p in pos if p < n)


@pytest.mark.parametrize("use_classes", [True, False])
@pytest.mark.parametrize("kind,n", [("printable", 140_001),
                                    ("binary", 70_003)])
def test_filter_compact_equals_reference_filter(dbs, use_classes, kind, n):
    ref, port = dbs
    corpus = _corpus(3, n, kind)
    want = _ref_candidates(ref.lit, corpus)
    ft, _ct = PT.device_tables(port.lit, "cpu")
    assert ft.cmasks is not None
    capc = 4
    pos, counts = PT.filter_compact(torch.from_numpy(corpus), ft, capc,
                                    use_classes=use_classes)
    assert pos.shape == (PT._n_cells(n), capc)
    by_cell = {}
    for p in sorted(want):
        by_cell.setdefault(p // PT.CELL, []).append(p)
    for c in range(pos.shape[0]):
        got_c = by_cell.get(c, [])
        assert int(counts[c]) == len(got_c)  # exact past capc
        k = min(len(got_c), capc)
        assert pos[c, :k].tolist() == got_c[:k]  # first capc, ascending
    assert int(counts.max()) > capc  # some cell overflowed capc


def test_filter_zero_before_offset_zero(dbs):
    """A factor whose leading bytes are NUL fires at p < len-1 under
    the device semantics (zero bytes before offset 0)."""
    ref, port = dbs
    corpus = np.frombuffer(b"ab3" + b"." * 200, np.uint8).copy()
    want = _ref_candidates(ref.lit, corpus)
    assert 2 in want
    ft, _ct = PT.device_tables(port.lit, "cpu")
    for use_classes in (True, False):
        pos, counts = PT.filter_compact(torch.from_numpy(corpus), ft, 16,
                                        use_classes=use_classes)
        assert set(pos[0, :int(counts[0])].tolist()) == want


def test_class_split_equals_reference(dbs):
    ref, port = dbs
    a = RT._class_split(ref.lit.masks)
    b = PT._class_split(port.lit.masks)
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])


def test_compact_combine_matches_cells():
    counts = torch.tensor([3, 0, 5, 1], dtype=torch.int32)
    capc = 4
    pos = torch.arange(16, dtype=torch.int32).reshape(4, 4) * 10
    meta, out = PT.compact_combine(pos, counts, capc, cap1=12)
    assert meta.tolist() == [9, 5]
    assert out.tolist() == [0, 10, 20, 80, 90, 100, 110, 120,
                            -1, -1, -1, -1]


def _mul32_ref(a: int, c: int) -> int:
    return (a * c) & 0xFFFFFFFF


def test_mul32_wraps_like_uint32():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 1 << 32, size=1000, dtype=np.int64)
    a[:4] = [0xFFFFFFFF, 0x80000000, 0xFFFF0000, 0x0000FFFF]
    for c in (0x9E3779B1, 0x85EBCA6B, 0x2C1B3C6D):
        got = PT._mul32(torch.from_numpy(a), c).numpy()
        assert got.tolist() == [_mul32_ref(int(x), c) for x in a]


def test_hash_confirm_tails_with_top_bits(dbs):
    """Tails of 0xFF bytes set every top bit of both words; the plain
    hash confirm must still match the device reference's pairs."""
    ref, port = dbs
    corpus = np.full(70_000, 0xFF, np.uint8)
    corpus[1000:1000 + len(PLANT)] = np.frombuffer(PLANT, np.uint8)
    assert _hash_pairs_port(port.lit, corpus) == \
        _hash_pairs_ref(ref.lit, corpus)


def _ref_start(lit, corpus):
    h = RT.teddy_confirm_start(jnp.asarray(RT.corpus_to_rows(corpus)), lit,
                               len(corpus))
    assert (h[6], h[7], h[8]) == (False, False, False)  # ungated compact
    return h


def _hash_pairs_ref(lit, corpus) -> set:
    f, p = RT.teddy_confirm_finish(_ref_start(lit, corpus))
    return set(zip(np.asarray(f).tolist(), np.asarray(p).tolist()))


def _hash_pairs_port(lit, corpus) -> set:
    f, p = PF.confirm_scan(torch.from_numpy(corpus), lit, len(corpus))
    return set(zip(f.tolist(), p.tolist()))


@pytest.mark.parametrize("kind,n", [("printable", 200_017),
                                    ("binary", 65_537)])
def test_confirm_equals_reference(dbs, kind, n):
    ref, port = dbs
    corpus = _corpus(5, n, kind)
    z = np.zeros(1, np.int64)
    f, p = RT.teddy_confirm_finish(_ref_start(ref.lit, corpus))
    f_r, p_r = np.asarray(f), np.asarray(p)
    f_p, p_p = PF.confirm_scan(torch.from_numpy(corpus), port.lit, n)
    # hash-matched pairs: the same tables and the same device semantics
    assert set(zip(f_p.tolist(), p_p.tolist())) == \
        set(zip(f_r.tolist(), p_r.tolist()))
    vr = ref_verify(ref.lit, corpus, z, f_r, p_r)
    vp = verify_pairs(port.lit, corpus, z, f_p, p_p)
    s_r = set(zip(vr[0].tolist(), vr[1].tolist()))
    assert set(zip(vp[0].tolist(), vp[1].tolist())) == s_r
    assert len(s_r) >= 8  # the plants confirmed


def test_confirm_overflow_keeps_every_pair(dbs, monkeypatch):
    """Tiny forced capc / cap1 / cap2 re-dispatch at learned sizes and
    lose nothing."""
    _ref, port = dbs
    corpus = _corpus(7, 140_000, "printable")
    for off in range(200, 60_000, 300):  # a dense first cell
        corpus[off:off + len(PLANT)] = np.frombuffer(PLANT, np.uint8)
    full = _hash_pairs_port(port.lit, corpus)
    lit = ht.compile_multi(PATS, ids=list(range(len(PATS)))).lit
    PF.force_family(lit, "compact")
    monkeypatch.setattr(PF, "CAPC_FLOOR", 1)
    monkeypatch.setattr(PF, "CAP1_FLOOR", 1)
    monkeypatch.setattr(PF, "CAP2_FLOOR", 1)
    assert PF._caps_for(lit, 1) == (1, 1, 1)
    handle = PF.confirm_start(torch.from_numpy(corpus), lit, len(corpus),
                              capacity=1)
    assert handle.caps == (1, 1, 1) and handle.family == "compact"
    f, p = PF.confirm_finish(handle)
    assert set(zip(f.tolist(), p.tolist())) == full
    t1, h1, t2 = PF.family_state(lit).obs["compact"]
    cap1, capc, cap2 = PF._caps_for(lit, 1)
    assert h1 > 1 and t2 > 1 and capc >= h1 and cap1 >= t1 and cap2 >= t2


def _candidate_list(port, seed: int):
    """A corpus, the compact family's candidate list (candidates first,
    then -1s) and its meta1 (the candidate total first), on the CPU."""
    corpus = torch.from_numpy(_corpus(seed, 70_001, "printable"))
    ft, ct = PT.device_tables(port.lit, "cpu")
    pos_c, cnt = PT.filter_compact(corpus, ft, 256,
                                   use_classes=ft.cmasks is not None)
    total = int(cnt.sum())
    meta1, pos = PT.compact_combine(pos_c, cnt, 256, PT._p2(total + 64))
    return corpus, ct, meta1, pos


@pytest.mark.parametrize("shape", ["combined", "trimmed", "longer_tail",
                                   "only_minus_ones"])
def test_hash_confirm_list_ending_in_minus_ones(dbs, shape):
    """Kernel B reads the whole list and skips its -1 slots: the compact
    list as combined (candidates first, then -1s), the candidates alone,
    the list with cap1 more -1s behind it, and a list of -1s alone give
    the pairs of the candidates alone (none for the last)."""
    _ref, port = dbs
    corpus, ct, meta1, pos = _candidate_list(port, 11)
    total = int(meta1[0])
    cands = pos[:total]
    assert total > 0 and bool((cands >= 0).all())
    assert bool((pos[total:] == -1).all())
    lst = {"combined": pos, "trimmed": cands,
           "longer_tail": torch.cat([pos, torch.full_like(pos, -1)]),
           "only_minus_ones": torch.full_like(pos, -1)}[shape]
    got = PT.hash_confirm(corpus, lst, ct, 4096)
    want = PT.hash_confirm(corpus, cands if shape != "only_minus_ones"
                           else cands[:0], ct, 4096)
    assert int(got[1]) == int(want[1])
    assert torch.equal(got[0], want[0])
    assert (int(got[1]) > 0) == (shape != "only_minus_ones")


def test_hash_confirm_many_groups(dbs):
    """Any number of groups: a table whose groups repeat R times (G past
    the 1,536 records the kernel stages in shared memory) gives every
    pair R times."""
    _ref, port = dbs
    corpus, ct, meta1, pos = _candidate_list(port, 13)
    R = 1536 // len(ct.groups) + 1
    many = PT.ConfirmTables(groups=ct.groups * R, meta=ct.meta.repeat(R, 1),
                            slots=ct.slots)
    assert len(many.groups) > 1536
    cands = pos[:int(meta1[0])][:64]
    one_p, one_t = PT.hash_confirm(corpus, cands, ct, 4096)
    got_p, got_t = PT.hash_confirm(corpus, cands, many, 4096 * R)
    assert int(one_t) > 0 and int(got_t) == R * int(one_t)
    k = int(one_t)
    assert torch.equal(got_p[:R * k].reshape(k, R, 2),
                       one_p[:k, None, :].expand(k, R, 2))


def test_hash_confirm_checks_its_arguments(dbs):
    _ref, port = dbs
    corpus, ct, meta1, pos = _candidate_list(port, 12)
    with pytest.raises(ValueError, match="int32"):
        PT.hash_confirm(corpus, pos.long(), ct, 64)
    with pytest.raises(ValueError, match="cap2"):
        PT.hash_confirm(corpus, pos, ct, 0)
    # a strided list is made contiguous by the wrapper
    two = torch.stack([pos, pos], 1)
    assert torch.equal(PT.hash_confirm(corpus, two[:, 0], ct, 64)[0],
                       PT.hash_confirm(corpus, pos, ct, 64)[0])
    args = PT.confirm_args(corpus, pos, ct)
    assert args[2] == pos.data_ptr() and args[3] == pos.numel()
    assert args[4] == ct.meta.data_ptr() and args[5] == len(ct.groups)
    assert args[6] == ct.slots.data_ptr()
