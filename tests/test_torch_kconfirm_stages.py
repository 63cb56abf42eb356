"""Kernel 4's stage modes (row 11: the counterpart of the JAX package's
stage-bisect probes) against the JAX package's kconfirm kernel.

The reference kernel runs as tools_probe_kconf_split.py runs it, in
Pallas interpret mode on the CPU at `_KCONF_STAGE = 3`, and gives per
cell its [8, 128] block: row 0 lane 0 the raw candidate count, lane 1
the raw confirmed count. The port's stage plain versions (what a CPU
tensor takes) must equal them: stage 0's candidate counts lane 0 on every
cell, stage 2's match counts lane 1 on the cells within the reference's
capc (past it the reference confirms only the first capc candidates and
the port's kernel confirms them all). Stage 1's checksum is held against
numpy over the reference's own confirm groups and hash. Integers, exact.
"""

import numpy as np
import pytest
import torch

import hyperscan_tpu_torch as ht
import torch_ref_native  # noqa: F401 (the reference's native build, locked)

from hyperscan_tpu.database import compile_patterns as ref_compile
from hyperscan_tpu.ops import teddy as RT
from hyperscan_tpu.runtime.lit_runtime import (_avalanche32,
                                               confirm_device_tables)
from hyperscan_tpu_torch.database import compile_patterns as port_compile
from hyperscan_tpu_torch.ops import teddy as PT
from hyperscan_tpu_torch.ops import teddy_kconfirm as PK

# the JAX package's kconfirm test ruleset (tests/test_kconfirm.py:17)
KC_PATS = (["attack%d" % i for i in range(40)]
           + [r"payload%d[0-9]{2,4}z" % i for i in range(30)]
           + [r"q%dh[a-f0-9]{8}" % i for i in range(30)])
CAPC = 128  # the reference kernel's compaction capacity here
N = 4 * 65536  # four whole cells: no padding inside a cell


@pytest.fixture(scope="module")
def case():
    ids = list(range(len(KC_PATS)))
    ref = ref_compile(KC_PATS, [0] * len(ids), ids)
    port = port_compile(KC_PATS, [0] * len(ids), ids)
    rng = np.random.default_rng(17)
    corpus = (32 + rng.integers(0, 95, size=N)).astype(np.uint8)
    for off in (0, 5000, 70_000, N - 46):
        p = b" attack7 payload12345z q3hdeadbeef attack39 "
        corpus[off:off + len(p)] = np.frombuffer(p, np.uint8)
    # a hot third cell: more candidates than the reference's capc
    hot = b"attack1 attack22 q5hcafef00d " * 200
    corpus[2 * 65536 + 100:2 * 65536 + 100 + len(hot)] = \
        np.frombuffer(hot, np.uint8)
    return ref, port, corpus


def _ref_blocks(lit, corpus: np.ndarray, capc: int) -> np.ndarray:
    """The reference kconfirm kernel's per-cell [8, 128] blocks, the
    pallas_call of tools_probe_kconf_split.py in interpret mode."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    assert RT._KCONF_STAGE == 3
    ftabs, _h, _f = RT.dev_filter_tables(lit)
    M, W = int(lit.masks.shape[0]), int(lit.masks.shape[1])
    use_classes = len(ftabs) == 2
    R = RT.ROWS_PER_CELL
    kconf_meta, planes, _slots = RT.dev_confirm_planes(lit)
    rows = jnp.asarray(RT.corpus_to_rows(corpus))
    n_cells = (rows.shape[0] - 1) // R
    if use_classes:
        kernel = RT._make_kernel_fused_classes(M, W, R, RT._hi_class(lit),
                                               capc, kconf_meta)
        tab_specs = [pl.BlockSpec((8, 128), lambda i: (0, 0),
                                  memory_space=pltpu.VMEM),
                     pl.BlockSpec((M, W, 128), lambda i: (0, 0, 0),
                                  memory_space=pltpu.VMEM)]
    else:
        kernel = RT._make_kernel_fused(M, W, R, capc, kconf_meta)
        tab_specs = [pl.BlockSpec((M, W, 256), lambda i: (0, 0, 0),
                                  memory_space=pltpu.VMEM)]
    tri, eye_c, eye_1 = RT._rank_consts(capc)
    planes = (jnp.asarray(tri, dtype=jnp.bfloat16), jnp.asarray(eye_c),
              jnp.asarray(eye_1)) + tuple(planes)
    for p in planes:
        tab_specs.append(pl.BlockSpec(tuple(p.shape), lambda i: (0, 0),
                                      memory_space=pltpu.VMEM))
    in_specs = [pl.BlockSpec((8, 128), lambda i: (i * (R // 8), 0),
                             memory_space=pltpu.VMEM),
                pl.BlockSpec((R, 128), lambda i: (i, 0),
                             memory_space=pltpu.VMEM)] + tab_specs
    out, _plane = pl.pallas_call(
        kernel, interpret=True, grid=(n_cells,),
        out_shape=[jax.ShapeDtypeStruct((n_cells * 8, 128), jnp.int32),
                   jax.ShapeDtypeStruct((n_cells * R, 128), jnp.uint8)],
        in_specs=in_specs,
        out_specs=[pl.BlockSpec((8, 128), lambda i: (i, 0),
                                memory_space=pltpu.VMEM),
                   pl.BlockSpec((R, 128), lambda i: (i, 0),
                                memory_space=pltpu.VMEM)],
    )(rows, rows[1:], *ftabs, *planes)
    return np.asarray(out).reshape(n_cells, 8, 128)


def _port_stage(lit, corpus: np.ndarray, stage: int):
    ft, _ct = PT.device_tables(lit, "cpu")
    kt = PK.confirm_planes(lit, "cpu")
    return [x.numpy() for x in PK.filter_kconfirm(
        torch.from_numpy(corpus), ft, kt, use_classes=ft.cmasks is not None,
        stage=stage)]


def test_stage_counts_equal_reference_kernel(case):
    ref, port, corpus = case
    block = _ref_blocks(ref.lit, corpus, CAPC)
    n_cells = PT._n_cells(N)
    cand0 = _port_stage(port.lit, corpus, 0)[0]
    cand2, _chk, conf2 = _port_stage(port.lit, corpus, 2)
    lane0, lane1 = block[:n_cells, 0, 0], block[:n_cells, 0, 1]
    assert np.array_equal(cand0, lane0) and np.array_equal(cand2, lane0)
    within = lane0 <= CAPC
    assert np.array_equal(conf2[within], lane1[within])
    # the hot cell passes the reference's capc: there the port confirms
    # every candidate, the reference only its first capc
    assert not within[2] and within[[0, 1, 3]].all()
    assert conf2[2] >= lane1[2] > 0 and conf2[within].sum() >= 4
    # stage 3's counts (the family's kernel) agree with the stages
    cand3, conf3, _pos, _cls = _port_stage(port.lit, corpus, 3)
    assert np.array_equal(cand3, cand0) and np.array_equal(conf3, conf2)


def test_stage1_checksum_equals_reference_hash(case):
    """Stage 1's per-cell checksum: the sum mod 2^32 of the reference's
    avalanche hash over each candidate's 8 tail bytes (zero before offset
    0) and each of the reference's confirm groups (cl, mlo, mhi) that it
    reaches (p >= cl - 1). Stages 0 and 2 keep the counts they share."""
    ref, port, corpus = case
    ft, _ct = PT.device_tables(port.lit, "cpu")
    cand = torch.nonzero(PT._candidates_plain(
        torch.from_numpy(corpus), ft, ft.cmasks is not None, 0, N)
    ).squeeze(1).numpy()
    pad = np.concatenate([np.zeros(7, np.uint8), corpus])
    tail = np.stack([pad[cand + k] for k in range(8)], 1).astype(np.uint64)
    v = (tail << (8 * np.arange(8, dtype=np.uint64))).sum(1)
    lo = (v & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (v >> np.uint64(32)).astype(np.uint32)
    want = np.zeros(PT._n_cells(N), np.uint64)
    for (cl, mlo, mhi, *_rest) in confirm_device_tables(ref.lit):
        h = _avalanche32(((lo & np.uint32(mlo)) * np.uint32(0x9E3779B1))
                         ^ ((hi & np.uint32(mhi)) * np.uint32(0x85EBCA6B)))
        ok = cand >= cl - 1
        np.add.at(want, cand[ok] // 65536, h[ok].astype(np.uint64))
    want &= np.uint64(0xFFFFFFFF)
    c1, chk1, conf1 = _port_stage(port.lit, corpus, 1)
    assert np.array_equal(chk1.view(np.uint32), want.astype(np.uint32))
    c2, chk2, _conf2 = _port_stage(port.lit, corpus, 2)
    assert np.array_equal(chk1, chk2) and not conf1.any()
    c0, chk0, conf0 = _port_stage(port.lit, corpus, 0)
    assert np.array_equal(c0, c1) and np.array_equal(c1, c2)
    assert not chk0.any() and not conf0.any() and want.any()


def test_stage_argument_rules(case):
    _ref, port, corpus = case
    ft, _ct = PT.device_tables(port.lit, "cpu")
    kt = PK.confirm_planes(port.lit, "cpu")
    t = torch.from_numpy(corpus[:1000])
    for bad in (-1, 4):
        with pytest.raises(ValueError):
            PK.filter_kconfirm(t, ft, kt, use_classes=True, stage=bad)
    with pytest.raises(ValueError):
        PK.filter_kconfirm_stage_plain(t, ft, kt, use_classes=True, stage=3)
    # no scan path takes a stage: the family dispatch has no such knob
    assert "stage" not in ht.scan.__code__.co_varnames
