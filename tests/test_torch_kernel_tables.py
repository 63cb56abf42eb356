"""The host-built tables of kernels D and 5 against the tables their plain
versions read.

Kernel D (`csrc/nfa_layered.cu`) reads a byte -> class-membership table
(`membership_words`) and a program of one record a position
(`kernel_program`); its plain version reads the class bitmaps `plan.lut`
and the predecessor lists `plan.preds`. The gate (`csrc/teddy_gate.cu`)
reads each byte's vector of M gate words (`gate_vectors`); its plain
version reads `gcm` through `b2c`. Every value is an integer, so the
comparisons are exact."""

import numpy as np
import pytest
import torch

import hyperscan_tpu_torch as ht
from hyperscan_tpu_torch.database import compile_patterns
from hyperscan_tpu_torch.grey import Grey
from hyperscan_tpu_torch.ops import nfa_kernel as NK
from hyperscan_tpu_torch.ops import teddy_gate as G
from hyperscan_tpu_torch.tools.benchdata import NFA_ENGINES

ENGINES = {
    "bench": (r".*a.{18}b", {}),
    "eod": (r".*x.{8}(y|z)$", dict(max_dfa_states=8, allow_teddy=False)),
    **NFA_ENGINES,
}


def _plan(name):
    pat, grey = ENGINES[name]
    eng = compile_patterns([pat], grey=Grey(**grey)).engines[0]
    assert NK.nfa_device_eligible(eng)
    return NK.device_plan(eng, "cpu")


def _random_dag(seed: int):
    """(info, preds) of a random layered plan: up to four
    predecessors a position, some the position before, several accept
    and EOD accept sets."""
    rng = np.random.default_rng(seed)
    P, K = int(rng.integers(5, 90)), int(rng.integers(1, 70))
    info = np.zeros(P, np.int64)
    preds = []
    for r in range(P):
        q = set(rng.integers(0, r, size=int(rng.integers(0, 5))).tolist()) \
            if r else set()
        if r and rng.random() < 0.5:
            q.add(r - 1)
        preds.append(sorted(q))
        v = int(rng.integers(K))
        if not q or rng.random() < 0.1:
            v |= NK._FLOAT
        if rng.random() < 0.2:
            v |= NK._ANCH
        if rng.random() < 0.3:
            v |= int(rng.integers(1, 32)) << NK._GID_SHIFT
        if rng.random() < 0.3:
            v |= int(rng.integers(1, 32)) << NK._EOD_SHIFT
        info[r] = v
    return info, preds


def _check_membership(mem: np.ndarray, lut: np.ndarray) -> None:
    K = lut.shape[0]
    words = mem.view(np.uint32).astype(np.int64)
    assert words.shape == (max(1, -(-K // 32)), 256)
    c = np.arange(words.shape[0] * 32)
    bits = (words[c // 32] >> (c % 32)[:, None]) & 1  # [32 KW, 256]
    assert np.array_equal(bits[:K], lut.astype(np.int64))
    assert not bits[K:].any()


def _check_program(info, preds, prog, extra, gvals, n_slots, groups):
    """Walk the program as the kernel does, with each slot holding the
    position whose word it keeps: every position reads exactly its
    predecessors, keeps its class and entry flags, and names its accept
    and EOD accept sets through the group values."""
    prog = prog.view(np.uint32).astype(np.int64)
    slots = [None] * max(n_slots, 1)
    for r, (x, y, z, w) in enumerate(prog):
        read = []
        if x & NK._P_PREV:
            read.append(r - 1)
        ns = y >> 16
        sl = [z & 0xFFFF, z >> 16][:ns] + [int(e) for e in
                                           extra[w:w + max(0, ns - 2)]]
        read += [slots[s] for s in sl]
        assert sorted(read) == preds[r], r
        v = int(info[r])
        keep = NK._CLASS_MASK | NK._FLOAT | NK._ANCH
        assert x & keep == v & keep
        for shift, gshift, off in ((NK._P_ACC_SHIFT, NK._GID_SHIFT, 0),
                                   (NK._P_EOD_SHIFT, NK._EOD_SHIFT,
                                    NK.MAX_DEVICE_SETS)):
            q, g = (x >> shift) & 31, (v >> gshift) & 31
            assert (q == 0) == (g == 0)
            if g:
                assert int(gvals[off + q - 1]) == 1 << (g - 1)
        if x & NK._P_OUT:
            assert (y & 0xFFFF) < n_slots
            slots[y & 0xFFFF] = r
        # the short path: r - 1 alone, no flag, slot or EOD accept, and an
        # accept only where there is at most one accept set
        rest = x & ~(NK._CLASS_MASK | 31 << NK._P_ACC_SHIFT | NK._P_PLAIN)
        assert bool(x & NK._P_PLAIN) == (rest == NK._P_PREV and ns == 0
                                         and groups[0] <= 1), r
    assert groups == (
        len({(int(v) >> NK._GID_SHIFT) & 31 for v in info} - {0}),
        len({(int(v) >> NK._EOD_SHIFT) & 31 for v in info} - {0}))


@pytest.mark.parametrize("name", list(ENGINES))
def test_nfa_membership_table_equals_lut(name):
    plan = _plan(name)
    _check_membership(plan.mem.numpy(), plan.lut.numpy())


@pytest.mark.parametrize("K", [1, 8, 31, 32, 33, 64, 70])
def test_nfa_membership_table_any_width(K):
    lut = np.random.default_rng(K).random((K, 256)) < 0.4
    _check_membership(NK.membership_words(lut), lut)


@pytest.mark.parametrize("name", list(ENGINES))
def test_nfa_program_equals_plan(name):
    plan = _plan(name)
    _check_program(plan.info_np, plan.preds, plan.prog.numpy(),
                   plan.extra.numpy(), plan.gvals.numpy(), plan.slots,
                   plan.groups)
    if name != "eod":  # a chain: every predecessor in the register
        assert plan.slots == 0
    # most of each takes the short path, also with only EOD accepts
    plain = (plan.prog.numpy()[:, 0] & NK._P_PLAIN) != 0
    assert plain.sum() >= plan.P // 2


@pytest.mark.parametrize("seed", range(6))
def test_nfa_program_random_plans(seed):
    info, preds = _random_dag(seed)
    prog, extra, gvals, n_slots, groups = NK.kernel_program(info, preds)
    _check_program(info, preds, prog, extra, gvals, n_slots, groups)


@pytest.mark.parametrize("M", range(1, 9))
def test_gate_vectors_equal_gate_words(M):
    rng = np.random.default_rng(M)
    b2c = rng.integers(0, 128, 256).astype(np.uint8)
    gcm = rng.integers(-(1 << 31), 1 << 31, (M, 128)).astype(np.int32)
    vec = G.gate_vectors(b2c, gcm)
    want = np.array([[gcm[m][b2c[b]] for m in range(M)]
                     for b in range(256)], np.int32)
    assert vec.shape == (256, M) and np.array_equal(vec, want)
    gt = G.gate_tables(torch.from_numpy(b2c), gcm)
    assert gt.M == M and np.array_equal(gt.vec.numpy(), want)
    assert np.array_equal(gt.gcm.numpy(), gcm)


def test_gate_vectors_of_a_database():
    pats = ["attack%dzq" % i for i in range(300)] + \
        ["union%dzq" % i for i in range(300)]
    db = ht.compile_multi(pats, ids=list(range(len(pats))))
    gt = G.device_gate_table(db.lit, "cpu")
    assert gt is not None
    b2c, gcm = gt.b2c.numpy().astype(np.int64), gt.gcm.numpy()
    assert np.array_equal(gt.vec.numpy(), gcm[:, b2c].T)
