"""The port's multi-process mesh against one process: two
`torch.distributed` processes of four CPU shards each, on gloo over
127.0.0.1 (tests/torch_multihost_worker.py), the counterpart of
tests/test_multihost.py's two `jax.distributed` processes, and four
processes of one shard each, as the four-card benchmark cell runs.

Each process's results must equal the single-process ones, computed here
through the JAX package and the port:
- the reference test's 16 x 700 B batch, which stays below the 64 KiB at
  which scan_batch shards the literal path, so it checks the group and
  each process's unsharded scan;
- 96 x 1,400 B, above it, where `sharded_literal_scan` takes each
  process's shards through the literal path and its host stages and
  exchanges their finished matches over the group;
- on four processes, a bulk1m-shaped batch of the bench formula's rules:
  each process's host stages see its own shard's bytes and no other's,
  and without the exchange the other shards' matches are lost;
- sharded_teddy_count, sharded_scan_counts and sharded_scan_matches, the
  last two over each process's own rows.
"""

import os
import sys
import zlib

import numpy as np
import pytest

import hyperscan_tpu as hs
import hyperscan_tpu_torch as ht
import torch_ref_native  # noqa: F401 (the reference's native build, locked)
from hyperscan_tpu import parallel as RP
from hyperscan_tpu_torch import parallel as PP
from hyperscan_tpu_torch.parallel import sharded as PS

sys.path.insert(0, os.path.dirname(__file__))
import torch_multihost_worker as W  # noqa: E402


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Both workers' results, after each exited 0."""
    res = W.spawn("mesh2", str(tmp_path_factory.mktemp("torch_mh") / "mh"))
    for r in res:
        assert r["process_count"] == 2
        assert r["global_shards"] == 8
        assert r["local_shards"] == 4
        assert r["backend"] == "gloo"
    return res


@pytest.fixture(scope="module")
def bulk(tmp_path_factory):
    """The four workers of mode "bulk4" (one shard each, as the four-card
    benchmark cell), after each exited 0."""
    res = W.spawn("bulk4", str(tmp_path_factory.mktemp("torch_mh4") / "mh"))
    for r in res:
        assert (r["process_count"], r["global_shards"], r["local_shards"],
                r["backend"]) == (4, 4, 1, "gloo")
    return res


@pytest.fixture(scope="module")
def bulk_ref():
    """The JAX package's database of the bulk rules."""
    pats, ids = W.bulk_patterns()
    return hs.compile_multi(pats, ids=ids)


@pytest.fixture(scope="module")
def bulk_want(bulk_ref):
    """The bulk batch's lists from the JAX package's single-process
    scan_batch, held equal to the port's unsharded one."""
    blocks = W.bulk_blocks()
    want = hs.scan_batch(bulk_ref, blocks)
    pats, ids = W.bulk_patterns()
    assert ht.scan_batch(ht.compile_multi(pats, ids=ids), blocks,
                         device="cpu") == want
    return want


def _lists(ms):
    return [[tuple(m) for m in b] for b in ms]


def test_reference_batch_equals_single_process(results):
    """tests/test_multihost.py's input: every process's lists equal the
    JAX package's single-process scan_batch."""
    blocks = W.corpus_blocks()
    want = hs.scan_batch(W.build_db(hs), blocks)
    assert sum(len(m) for m in want) >= len(blocks)
    assert ht.scan_batch(W.build_db(ht), blocks, device="cpu") == want
    for r in results:
        assert r["small_sharded"] == 0  # 11,200 B: below the shard limit
        assert _lists(r["small"]) == want, f"process {r['process_id']}"


def test_sharded_batch_equals_single_process(results):
    """Above 64 KiB: the literal path sharded across both processes, each
    scanning its own four shards; the lists equal the JAX package's and
    the port's single-process scan_batch."""
    blocks = W.big_blocks()
    assert sum(map(len, blocks)) > 1 << 16
    want = hs.scan_batch(W.build_db(hs), blocks)
    assert sum(len(m) for m in want) >= len(blocks)
    assert ht.scan_batch(W.build_db(ht), blocks, device="cpu") == want
    for r in results:
        assert _lists(r["big"]) == want, f"process {r['process_id']}"
        # one sharded scan, over both processes' shards; this process
        # dispatched only its own four, and got the other's matches
        (seen,) = r["big_confirm"]
        assert seen["process_count"] == 2
        assert seen["ranks"] == [0] * 4 + [1] * 4
        assert r["dispatches"] == 4
        other = [n for n, rank in zip(seen["matches"], seen["ranks"])
                 if rank != r["process_id"]]
        assert sum(other) > 0
    assert results[0]["big_confirm"] == results[1]["big_confirm"]


def test_process_without_blocks_joins_the_gather(results):
    """Two blocks of 40,000 B fill shards 0 and 1, both of process 0:
    process 1 scans nothing, still joins the gather, and returns the same
    lists."""
    blocks = W.lopsided_blocks()
    want = hs.scan_batch(W.build_db(hs), blocks)
    assert [len(m) for m in want] == [1, 1]
    for r in results:
        assert _lists(r["lopsided"]) == want, f"process {r['process_id']}"
        (seen,) = r["lopsided_confirm"]
        assert seen["matches"][2:] == [0] * 6 \
            and min(seen["matches"][:2]) > 0


def test_engine_functions_equal_single_process(results):
    """sharded_teddy_count over a replicated corpus, and
    sharded_scan_counts / sharded_scan_matches over each process's half
    of the batch, equal one process's over the whole, and the JAX
    package's count."""
    mesh = PP.make_mesh(8, device="cpu")
    tdb = ht.compile_multi(W.TEDDY_PATS, ids=[1, 2, 3])
    corpus = W.teddy_corpus()
    count = PP.sharded_teddy_count(corpus, tdb.lit.masks, mesh)
    rdb = hs.compile_multi(W.TEDDY_PATS, ids=[1, 2, 3])
    assert count == RP.sharded_teddy_count(corpus, rdb.lit.masks,
                                           RP.make_mesh()) >= 12
    edb = ht.compile_multi(W.ENGINE_PATS, ids=[10, 20, 30])
    data, lengths = W.engine_batch(8)
    dfa_count = PP.sharded_scan_counts(edb.engines[0], data, lengths, mesh)
    dfa_matches = PP.sharded_scan_matches(edb.engines[0], data, lengths,
                                          mesh, capacity=64)
    assert dfa_count > 0
    for r in results:
        assert r["teddy_count"] == count
        assert r["dfa_count"] == dfa_count
        for got, want in zip(r["dfa_matches"], dfa_matches):
            assert np.array_equal(np.asarray(got), want.numpy())


def _shard_stages(blocks, group):
    """What a process's host stages see of one shard: its blocks' bytes
    flattened, uploaded, verified and window-validated, as the worker's
    spy records them."""
    data = b"".join(blocks[i] for i in group)
    key = (len(group), len(data), zlib.crc32(data))
    return [["flatten", *key], ["upload", 0, *key[1:]], ["verify", *key],
            ["windows", *key]]


def test_bulk_batch_equals_single_process(bulk, bulk_want):
    """Four processes of one shard each over the bench formula's first
    300 rules and a bulk1m-shaped batch (64 x 64 KiB, 2-8 rule plants a
    block): every process's lists equal the JAX package's and the port's
    single-process scan_batch."""
    assert all(bulk_want) and sum(map(len, bulk_want)) >= 5 * 64
    for r in bulk:
        assert _lists(r["bulk"]) == bulk_want, f"process {r['process_id']}"


def test_host_stages_run_on_own_shards_only(bulk):
    """Each process flattened, uploaded, confirmed and ran verify_pairs
    and finish_confirmed over its own shard's blocks and nothing else."""
    blocks = W.bulk_blocks()
    groups = PS.partition_blocks(blocks, 4)
    assert all(len(g) == 16 for g in groups)
    for r in bulk:
        assert r["bulk_stages"] == _shard_stages(
            blocks, groups[r["process_id"]]), f"process {r['process_id']}"


def test_exchange_carries_the_foreign_shards(bulk, bulk_want):
    """With `_gather_pairs` keeping each process's own shard only, a
    process keeps its own blocks' matches and loses every other's."""
    groups = PS.partition_blocks(W.bulk_blocks(), 4)
    for r in bulk:
        own = set(groups[r["process_id"]])
        got = _lists(r["own_only"])
        for i, want in enumerate(bulk_want):
            assert got[i] == (want if i in own else []), (r["process_id"], i)


def test_bulk_process_without_blocks_joins_the_exchange(bulk, bulk_ref):
    """Two 64 KiB blocks fill the shards of processes 0 and 1: processes
    2 and 3 flatten, upload and verify nothing, still join the exchange,
    and return the same lists."""
    blocks = W.bulk_blocks()[:2]
    want = hs.scan_batch(bulk_ref, blocks)
    assert all(want)
    for r in bulk:
        assert _lists(r["lopsided"]) == want, f"process {r['process_id']}"
        pid = r["process_id"]
        assert r["lopsided_stages"] == (
            _shard_stages(blocks, [pid]) if pid < 2 else [])
