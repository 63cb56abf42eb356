"""The kernels' table layout and kernel C's row mode, on the CPU.

- The filter kernels read their tables as [M, K, Wp] (`pack_tables`): the
  W words of one (m, key) side by side, zero-padded to Wp. The packing is
  a permutation plus zero padding of the [M, W, K] tables the plain
  versions read, and a plain filter over the packed layout finds exactly
  the candidates of `filter_compact_plain`, for W in {1, 2, 3, 4, 5, 8}
  and both table kinds.
- The device-table functions (`device_tables`, `mask_tables`, the gate's
  filter view) build the packed layout beside the plain one.
- `dfa_scan_rows` (kernel C's row mode; its CPU branch is the plain
  version) equals the JAX package's `dfa_scan_batch` at row lengths that
  are not a multiple of the kernel's tile, rows of length 0 and per-row
  entry states.

Every value is an integer, so equality is exact."""

import numpy as np
import pytest
import torch

import torch_ref_native  # noqa: F401 (the reference's native build, locked)
import jax.numpy as jnp

from hyperscan_tpu.ops import dfa as RD
from hyperscan_tpu_torch.database import compile_patterns
from hyperscan_tpu_torch.grey import Grey
from hyperscan_tpu_torch.ops import dfa as PD
from hyperscan_tpu_torch.ops import dfa_kernel as DK
from hyperscan_tpu_torch.ops import teddy as PT
from hyperscan_tpu_torch.ops import teddy_gate as PG
from hyperscan_tpu_torch.ops import teddy_words as TW

WIDTHS = [1, 2, 3, 4, 5, 8]


def _tables(M: int, W: int, seed: int) -> PT.FilterTables:
    """Random tables whose 256 byte columns take 40 distinct values, so
    the alphabet compresses to class tables; each bit set with the
    density that makes about 2% of positions candidates."""
    rng = np.random.default_rng(seed)
    density = (0.02 / (32 * W)) ** (1 / M)
    cols = (rng.random((40, M * W, 32)) < density).astype(np.int64)
    words = (cols << np.arange(32)).sum(-1).astype(np.uint32).view(np.int32)
    masks = np.ascontiguousarray(
        words[rng.integers(0, 40, 256)].T.reshape(M, W, 256))
    b2c, cmasks = PT._class_split(masks)
    b2c = np.concatenate([b2c[0], b2c[1]]).astype(np.uint8)
    return PT.filter_tables(torch.from_numpy(masks), torch.from_numpy(b2c),
                            torch.from_numpy(cmasks))


def _packed_candidates(corpus: torch.Tensor, ft: PT.FilterTables,
                       use_classes: bool) -> torch.Tensor:
    """The filter read from the packed layout: position p is a candidate
    when some word w < Wp of AND_m packed[m, key(p - m), w] is nonzero."""
    packed = ft.cpacked if use_classes else ft.packed
    M, n = ft.M, corpus.numel()
    seg = torch.cat([corpus.new_zeros(M - 1), corpus]).long()
    key = ft.b2c.long()[seg] if use_classes else seg
    acc = packed[0][key[M - 1:M - 1 + n]]  # [n, Wp]
    for m in range(1, M):
        acc = acc & packed[m][key[M - 1 - m:M - 1 - m + n]]
    return (acc != 0).any(1)


@pytest.mark.parametrize("W", WIDTHS)
def test_pack_tables_is_permutation_plus_zero_padding(W):
    ft = _tables(3, W, W)
    assert ft.cmasks is not None
    for tab, packed in ((ft.masks, ft.packed), (ft.cmasks, ft.cpacked)):
        Wp = PT.padded_width(W)
        assert Wp in (1, 2, 4, 8) and Wp >= W
        assert packed.shape == (3, tab.shape[2], Wp)
        assert packed.dtype == torch.int32 and packed.is_contiguous()
        assert torch.equal(packed[:, :, :W], tab.permute(0, 2, 1))
        assert not packed[:, :, W:].any()


@pytest.mark.parametrize("use_classes", [True, False])
@pytest.mark.parametrize("W", WIDTHS)
def test_packed_layout_filter_equals_plain(W, use_classes):
    M = 2 + W % 5
    ft = _tables(M, W, 10 + W)
    rng = np.random.default_rng(W)
    n = 3 * PT.CELL + 77
    corpus = torch.from_numpy(rng.integers(0, 256, n).astype(np.uint8))
    got = torch.nonzero(_packed_candidates(corpus, ft, use_classes))
    pos, cnt = PT.filter_compact_plain(corpus, ft, PT.CELL,
                                       use_classes=use_classes)
    want = torch.cat([pos[c, :int(cnt[c])] for c in range(cnt.numel())])
    assert 50 < want.numel() < n // 4
    assert torch.equal(got.squeeze(1).int(), want)
    # the wrapper takes the plain version on a CPU tensor
    pos_w, cnt_w = PT.filter_compact(corpus, ft, PT.CELL,
                                     use_classes=use_classes)
    assert torch.equal(pos_w, pos) and torch.equal(cnt_w, cnt)


def test_padded_width_limits():
    assert [PT.padded_width(w) for w in range(1, 9)] == \
        [1, 2, 4, 4, 8, 8, 8, 8]
    for bad in (0, 9):
        with pytest.raises(ValueError):
            PT.padded_width(bad)


def test_device_tables_build_both_layouts():
    pats = ["attack%d" % i for i in range(300)] + ["q%dhzz" % i
                                                   for i in range(40)]
    db = compile_patterns(pats, grey=Grey(host_scan_limit=0))
    lit = db.lit
    ft, _ct = PT.device_tables(lit, "cpu")
    assert torch.equal(ft.packed, PT.pack_tables(ft.masks))
    assert ft.cmasks is not None
    assert torch.equal(ft.cpacked, PT.pack_tables(ft.cmasks))
    wt = PT.mask_tables(lit.masks, "cpu")
    assert torch.equal(wt.masks, ft.masks) and torch.equal(wt.packed,
                                                           ft.packed)
    gt = PG.device_gate_table(lit, "cpu")
    assert gt is not None  # W = 1: the gate table is its own packed layout
    view = gt.as_filter
    assert torch.equal(view.cpacked, PT.pack_tables(view.cmasks))


def _dfa_case(B: int, L: int, seed: int):
    eng = compile_patterns([r"ab[cd]{2,6}ef", r"[0-9]{3}-[0-9]{4}",
                            r"GET /[a-z]{1,12} "],
                           grey=Grey(allow_teddy=False)).engines[0]
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"abcdef0123456789-GET /xyz", np.uint8)
    data = alpha[rng.integers(0, len(alpha), (B, L))]
    plant = np.frombuffer(b"abddef 555-1234 GET /abc ", np.uint8)
    for b in range(B):
        off = int(rng.integers(0, max(1, L - len(plant))))
        data[b, off:off + len(plant)] = plant[:L - off]
    lengths = rng.integers(0, L + 1, B).astype(np.int32)
    lengths[:min(B, 3)] = [L, 0, 1][:min(B, 3)]
    return eng, np.ascontiguousarray(data), lengths


@pytest.mark.parametrize("B,L,init", [(1, 300, "scalar"),
                                      (37, 1000, "rows"),
                                      (40, 129, "scalar")])
def test_dfa_scan_rows_equals_reference(B, L, init):
    eng, data, lengths = _dfa_case(B, L, B + L)
    S = eng.trans.shape[0]
    init_state = (int(eng.start_state) if init == "scalar" else
                  np.random.default_rng(1).integers(0, S, B)
                  .astype(np.int32))
    ra, rf = RD.dfa_scan_batch(
        jnp.asarray(eng.trans), jnp.asarray(eng.byte_to_class.astype(
            np.int32)), jnp.asarray(eng.accept_id),
        jnp.asarray(init_state), jnp.asarray(data), jnp.asarray(lengths))
    tabs = DK.device_tables(eng, "cpu")
    pa, pf = PD.dfa_scan_rows(tabs, torch.as_tensor(init_state),
                              torch.from_numpy(data),
                              torch.from_numpy(lengths))
    assert np.array_equal(pa.numpy(), np.asarray(ra))
    assert np.array_equal(pf.numpy(), np.asarray(rf))
    assert int((pa != 0).sum()) >= B // 2


def test_row_fills_count_every_bucket_entry():
    """The stage probe's fill report covers every confirm group's rows:
    its entries sum to the occupied slots of the bucket-row tables."""
    from hyperscan_tpu_torch.ops import teddy_kconfirm as PK
    from hyperscan_tpu_torch.tools.kconf_probe import row_fills

    pats = ["attack%d" % i for i in range(300)] + ["q%dhzz" % i
                                                   for i in range(40)]
    lit = compile_patterns(pats, grey=Grey(host_scan_limit=0)).lit
    kt = PK.confirm_planes(lit, "cpu")
    fills = row_fills(lit)
    assert [g["rows"] for g in fills] == [g[3] for g in kt.groups]
    assert sum(g["entries"] for g in fills) == int(kt.fills.long().sum()) \
        == int((kt.cls != 0).sum())
    assert all(0 <= g["mean"] <= g["max"] <= 128 for g in fills)
