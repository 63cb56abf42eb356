"""The plain versions of the extraction (`ops.extract.plane_extract_plain`)
and of the survivor rescan (`ops.teddy_gate.rescan_rows` on the CPU)
against the JAX package, at the edges their kernels find hard: a plane
with every byte nonzero, `n_valid` at 0 and inside a chunk, one position
of capacity; a row flood and a corpus with no flagged row, with and
without the gate's row counts. The card tests
(`tests/test_torch_cuda.py`) hold the kernels against these plain
versions. Every value is an integer, so equality is exact."""

import numpy as np
import pytest
import torch

import hyperscan_tpu_torch as ht
import torch_ref_native  # noqa: F401 (the reference's native build, locked)
import jax.numpy as jnp

from hyperscan_tpu.database import compile_patterns as ref_compile
from hyperscan_tpu.ops import teddy as RT
from hyperscan_tpu.runtime.lit_runtime import verify_pairs as ref_verify
from hyperscan_tpu_torch.ops import extract as PX
from hyperscan_tpu_torch.ops import teddy as PT
from hyperscan_tpu_torch.ops import teddy_families as PF
from hyperscan_tpu_torch.ops import teddy_gate as PG
from hyperscan_tpu_torch.runtime.lit_runtime import verify_pairs

Z = np.zeros(1, np.int64)
WORDS = ["attack", "payload", "shell", "admin", "select", "union"]
GATED_PATS = [WORDS[i % 6] + str(i) + "zq" for i in range(600)]


# --- the extraction ---------------------------------------------------------

def _plane(case: str):
    """(plane, n_valid, cap1) of one edge, from a seed."""
    rng = np.random.default_rng(5)
    n = 256 * 300
    plane = ((rng.random(n) < 0.02) * rng.integers(1, 256, n)).astype(
        np.uint8)
    if case == "all_nonzero":
        return np.full(n, 3, np.uint8), n, n // 3
    if case == "n_valid_0":
        return plane, 0, 64
    if case == "n_valid_mid_chunk":
        return plane, 256 * 117 + 45, 4096
    if case == "cap1_1":
        return plane, n, 1
    assert case == "range_edge"  # the kernel's 64 KiB ranges
    return plane, 65536, 1 << 16


@pytest.mark.parametrize("case", ["all_nonzero", "n_valid_0",
                                  "n_valid_mid_chunk", "cap1_1",
                                  "range_edge"])
def test_plane_extract_plain_equals_sparse_extract(case):
    plane, n_valid, cap1 = _plane(case)
    n_chunks = len(plane) // 256
    meta_r, packed_r = RT.sparse_extract([], n_valid, cap1, n_chunks,
                                         nz=jnp.asarray(plane), chunk=256)
    meta_p, pos_p = PX.plane_extract(torch.from_numpy(plane), n_valid, cap1)
    meta_r = np.asarray(meta_r).tolist()
    assert meta_p.tolist() == meta_r
    k = min(meta_r[0], cap1)
    assert pos_p[:k].tolist() == np.asarray(packed_r)[0, :k].tolist()
    assert (pos_p[k:] == -1).all()
    if case == "n_valid_mid_chunk":  # the chunk holding n_valid counts
        assert pos_p[:k].max() >= n_valid


# --- the survivor rescan ----------------------------------------------------

@pytest.fixture
def gated():
    """A fresh pair of databases: each package learns its family choice
    on its database (a row flood turns the gate off after one scan)."""
    ids = list(range(len(GATED_PATS)))
    return (ref_compile(GATED_PATS, [0] * len(ids), ids),
            ht.compile_multi(GATED_PATS, ids=ids))


def _corpus(kind: str) -> np.ndarray:
    corpus = np.full(1 << 18, ord("."), dtype=np.uint8)
    if kind == "row_flood":  # a plant in each of 1,024 128-byte rows
        p = np.frombuffer(b"attack0zq", np.uint8)
        for r in range(1024):
            corpus[r * 128 + 40:r * 128 + 40 + len(p)] = p
    return corpus


def _set(f, p) -> set:
    return set(zip(np.asarray(f).tolist(), np.asarray(p).tolist()))


@pytest.mark.parametrize("with_counts", [True, False])
@pytest.mark.parametrize("kind", ["row_flood", "no_flagged_row"])
def test_rescan_rows_equals_reference(gated, kind, with_counts,
                                      monkeypatch):
    """The rescan's positions equal the reference filter's candidates
    (the gate is a superset), and the gated family built on it gives the
    reference gated family's hash-matched and verified pairs, whether
    the gate's row counts are passed or not."""
    ref, port = gated
    corpus = _corpus(kind)
    n = len(corpus)
    ct = torch.from_numpy(corpus)
    ft, _ct = PT.device_tables(port.lit, "cpu")
    flags, k = PG.gate_rows(ct, PG.device_gate_table(port.lit, "cpu"))
    rc = k if with_counts else None
    pos, cnt = PG.rescan_rows(ct, ft, flags, 4096, row_counts=rc)
    got = np.concatenate([pos[c, :int(cnt[c])].numpy()
                          for c in range(len(cnt))]).tolist()
    total, rpos, _w = RT.teddy_scan_rows(
        jnp.asarray(RT.corpus_to_rows(corpus)), jnp.asarray(ref.lit.masks),
        n)
    want = sorted(int(p) for p in np.asarray(rpos)[:int(total)] if p < n)
    assert got == want
    assert (len(got) >= 1024) == (kind == "row_flood")

    h = RT.teddy_confirm_start(jnp.asarray(RT.corpus_to_rows(corpus)),
                               ref.lit, n)
    assert h[7] is True  # the reference ran its gated family
    f, p = (np.asarray(a) for a in RT.teddy_confirm_finish(h))
    r_hash, r_ver = _set(f, p), _set(*ref_verify(ref.lit, corpus, Z, f, p))
    if not with_counts:  # the gated family, its rescan given no counts
        monkeypatch.setattr(
            PF, "rescan_rows",
            lambda c, t, fl, capc, row_counts=None: PG.rescan_rows(
                c, t, fl, capc))
    PF.force_family(port.lit, "gated")
    hp = PF.confirm_start(ct, port.lit, n)
    assert hp.family == "gated"
    f, p = PF.confirm_finish(hp)
    assert _set(f, p) == r_hash
    assert _set(*verify_pairs(port.lit, corpus, Z, f, p)) == r_ver
    assert len(r_ver) == (1024 if kind == "row_flood" else 0)


def test_rescan_rows_checks_row_counts(gated):
    _ref, port = gated
    ct = torch.from_numpy(_corpus("row_flood"))
    ft, _ct = PT.device_tables(port.lit, "cpu")
    flags, k = PG.gate_rows(ct, PG.device_gate_table(port.lit, "cpu"))
    for bad in (k[:-1], k.long()):
        with pytest.raises(ValueError, match="row_counts"):
            PG.rescan_rows(ct, ft, flags, 64, row_counts=bad)
