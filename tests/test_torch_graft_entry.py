"""The port's graft entry points (hyperscan_tpu_torch/graft_entry.py)
against the JAX package's (__graft_entry__.py), on the CPU.

- `entry(device="cpu")`: the same tables and example batch as the
  reference's `entry()`, and the step's five outputs exactly equal to
  `jax.jit(fn)(*args)` of the reference (imported as
  tests/test_parallel.py imports it).
- `dryrun_multichip(n, device="cpu")` passes on a CPU mesh of n shards;
  its DFA count, filter count and product-path match lists equal the
  reference's sharded functions and `scan_batch` on the same seeded
  inputs (the reference on the virtual 8-device CPU mesh of
  tests/conftest.py). A mesh of another size than asked for raises.
"""

import jax
import numpy as np
import pytest
import torch

import hyperscan_tpu as hs
import torch_ref_native  # noqa: F401 (the reference's native build, locked)
from hyperscan_tpu import parallel as RP
from hyperscan_tpu_torch import graft_entry as GE
from hyperscan_tpu_torch.parallel import make_mesh

CPU = "cpu"


def test_entry_args_equal_reference():
    import __graft_entry__ as ge

    _fn, rargs = ge.entry()
    _pfn, pargs = GE.entry(device=CPU)
    assert len(rargs) == len(pargs) == 7
    for r, p in zip(rargs, pargs):
        assert p.device == torch.device(CPU)
        np.testing.assert_array_equal(np.asarray(r), p.numpy())


def test_entry_equals_reference_step():
    import __graft_entry__ as ge

    fn, args = ge.entry()
    want = jax.jit(fn)(*args)
    pfn, pargs = GE.entry(device=CPU)
    got = pfn(*pargs)
    assert len(want) == len(got) == 5
    for w, g in zip(want, got):
        w = np.asarray(w)
        assert g.shape == w.shape
        np.testing.assert_array_equal(w, g.numpy().astype(w.dtype))
    assert int(got[0]) > 0  # the planted 012-3456


def test_entry_on_missing_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="cuda"):
        GE.entry()
    with pytest.raises(RuntimeError, match="cuda"):
        GE.dryrun_multichip(2)


@pytest.mark.parametrize("n", [1, 3, 8])
def test_dryrun_multichip_cpu_equals_reference(n, capsys):
    r = GE.dryrun_multichip(n, device=CPU)
    assert "scaling proxy" in capsys.readouterr().out
    assert r["devices"] == [CPU] * n
    # the reference's sharded DFA count and filter count on its mesh
    rmesh = RP.make_mesh(n)
    eng = hs.compile_multi(GE.PATTERNS,
                           ids=list(range(len(GE.PATTERNS)))).engines[0]
    data, lengths = RP.pad_batch_for_mesh(GE.dfa_blocks(n), rmesh,
                                          pad_len=128)
    assert r["count"] == RP.sharded_scan_counts(eng, data, lengths, rmesh)
    ldb = hs.compile_multi(["attack", "error|warning"], ids=[1, 2])
    assert r["teddy_count"] == RP.sharded_teddy_count(
        GE.literal_corpus(n), ldb.lit.masks, rmesh)
    # the product path: the reference's scan_batch on the same blocks
    pdb = hs.compile_multi(GE.PRODUCT_PATTERNS, ids=list(range(80)))
    want = [sorted(tuple(m) for m in ms)
            for ms in hs.scan_batch(pdb, GE.product_blocks(n))]
    for got in (r["single"], r["sharded"]):
        assert [sorted(tuple(m) for m in ms) for ms in got] == want
    assert sum(map(len, want)) >= 6 * n


def test_dryrun_on_fewer_shards_raises():
    with pytest.raises(ValueError, match="mesh of 4"):
        GE.dryrun_multichip(8, device=CPU, mesh=make_mesh(4, device=CPU))
    with pytest.raises(ValueError, match="at least one shard"):
        GE.dryrun_mesh(0, device=CPU)
    assert GE.dryrun_mesh(5, device=CPU).devices.size == 5


def test_main_on_cpu(capsys):
    assert GE.main(["--device", CPU, "--devices", "2"]) == 0
    out = capsys.readouterr().out
    assert "[entry] cpu:" in out and "sharded == unsharded" in out
