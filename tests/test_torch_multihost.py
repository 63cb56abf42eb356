"""The port's multi-process mesh against one process: two
`torch.distributed` processes of four CPU shards each, on gloo over
127.0.0.1 (tests/torch_multihost_worker.py), the counterpart of
tests/test_multihost.py's two `jax.distributed` processes.

Each process's results must equal the single-process ones, computed here
through the JAX package and the port:
- the reference test's 16 x 700 B batch, which stays below the 64 KiB at
  which scan_batch shards the literal path, so it checks the group and
  each process's unsharded scan;
- 96 x 1,400 B, above it, where `sharded_literal_confirm` scans each
  process's shards and gathers every shard's pairs over the group;
- sharded_teddy_count, sharded_scan_counts and sharded_scan_matches, the
  last two over each process's own rows.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

import hyperscan_tpu as hs
import hyperscan_tpu_torch as ht
import torch_ref_native  # noqa: F401 (the reference's native build, locked)
from hyperscan_tpu import parallel as RP
from hyperscan_tpu_torch import parallel as PP

sys.path.insert(0, os.path.dirname(__file__))
import torch_multihost_worker as W  # noqa: E402

WORKER = os.path.join(os.path.dirname(__file__), "torch_multihost_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Both workers' results, after each exited 0."""
    out = str(tmp_path_factory.mktemp("torch_mh") / "mh")
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
                        "LOCAL_RANK", "LOCAL_WORLD_SIZE")}
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, WORKER, str(pid), port, out],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE)
             for pid in range(W.PROCESSES)]
    try:
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, (so.decode()[-2000:], se.decode()[-2000:])
    res = []
    for pid in range(W.PROCESSES):
        with open(f"{out}.{pid}") as f:
            res.append(json.load(f))
    for r in res:
        assert r["process_count"] == 2
        assert r["global_shards"] == 8
        assert r["local_shards"] == 4
        assert r["backend"] == "gloo"
    return res


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
        # one sharded confirm, over both processes' shards; this process
        # dispatched only its own four, and got the other's pairs
        (seen,) = r["big_confirm"]
        assert seen["process_count"] == 2
        assert seen["ranks"] == [0] * 4 + [1] * 4
        assert r["dispatches"] == 4
        other = [n for n, rank in zip(seen["pairs"], seen["ranks"])
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
        assert seen["pairs"][2:] == [0] * 6 and min(seen["pairs"][:2]) > 0


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
