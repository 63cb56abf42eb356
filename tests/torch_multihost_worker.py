"""Worker process for tests/test_torch_multihost.py: one of two
`torch.distributed` processes of the port, each holding four CPU shards
of one global mesh (gloo over 127.0.0.1), running the port's sharded
paths. Imports only the port.

    python tests/torch_multihost_worker.py <process_id> <port> <out_path>

Writes `<out_path>.<process_id>` (JSON) with what the process returned:
- `small`: scan_batch(mesh=) over the reference test's 16 x 700 B blocks
  (tests/multihost_worker.py), below the 64 KiB at which the literal
  path shards;
- `big`: scan_batch(mesh=) over 96 x 1,400 B blocks, above it, with what
  `sharded_literal_confirm` saw and this process's family dispatches;
- `lopsided`: scan_batch(mesh=) over two blocks that fill process 0's
  shards only;
- `teddy_count`, `dfa_count`, `dfa_matches`: sharded_teddy_count over a
  replicated corpus, and sharded_scan_counts / sharded_scan_matches over
  this process's half of a global block batch.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

PROCESSES = 2
LOCAL_SHARDS = 4
ENGINE_PATS = [r"f[o0]+[a-z]+bar", r"x[0-9]+y", r"er+or"]
ENGINE_BLOCKS = [b"xx fooqqbar yy x123y", b"error and errors",
                 b"nothing in here at all", b"fooabar" * 3, b"",
                 b"x88y erroor"] * 5
TEDDY_PATS = [r"attack", r"needle", r"hayst"]


def corpus_blocks(n_blocks: int = 16, size: int = 700):
    """tests/multihost_worker.py's corpus (its defaults), and the same
    plants over more or longer blocks."""
    import numpy as np

    rng = np.random.default_rng(123)
    blocks = []
    plants = [b"attack7 ", b"payload3x99z", b"sig5hit "]
    for b in range(n_blocks):
        blob = bytearray(
            (32 + rng.integers(0, 95, size)).astype(np.uint8).tobytes())
        p = plants[b % len(plants)]
        off = 37 + 11 * b
        blob[off:off + len(p)] = p
        blocks.append(bytes(blob))
    return blocks


def big_blocks():
    """96 x 1,400 B = 134,400 B: past the 64 KiB above which scan_batch
    shards the literal path across the mesh."""
    return corpus_blocks(96, 1400)


def lopsided_blocks():
    """Two blocks of 40,000 B, each with a plant: past 64 KiB, and they
    fill shards 0 and 1, so process 1's shards hold no block."""
    a, b = corpus_blocks(2, 40_000)
    return [a, b]


def build_db(pkg):
    """tests/multihost_worker.py's database, in either package."""
    pats = ["attack7", r"payload3x[0-9]{2}z", "sig5hit", r"q9(ab|cd)*end9"]
    return pkg.compile_multi(pats, ids=[1, 2, 3, 4])


def teddy_corpus():
    """A replicated corpus for sharded_teddy_count, with each of
    TEDDY_PATS planted."""
    import numpy as np

    rng = np.random.default_rng(5)
    c = (32 + rng.integers(0, 95, 3 * 65536 + 777)).astype(np.uint8)
    for k, w in enumerate((b"attack", b"needle", b"hayst") * 4):
        at = 1000 + k * 16_001
        c[at:at + len(w)] = np.frombuffer(w, np.uint8)
    return c


def engine_batch(n_shards: int):
    """The global [B, 128] batch of the engine functions and its
    lengths, padded to a multiple of the global shard count."""
    from hyperscan_tpu_torch import parallel as P

    return P.pad_batch_for_mesh(ENGINE_BLOCKS,
                                P.make_mesh(n_shards, device="cpu"), 128)


def main() -> None:
    pid, port, out_path = int(sys.argv[1]), sys.argv[2], sys.argv[3]

    import torch

    torch.set_num_threads(2)
    import hyperscan_tpu_torch as ht
    from hyperscan_tpu_torch import parallel as P
    from hyperscan_tpu_torch.ops import teddy_families as F
    from hyperscan_tpu_torch.parallel import sharded as PS

    mesh = P.make_multihost_mesh(
        coordinator_address=f"127.0.0.1:{port}", num_processes=PROCESSES,
        process_id=pid, device="cpu", n_local=LOCAL_SHARDS)

    # what scan_batch's sharded literal path saw: the mesh, and each
    # shard's hash-matched pairs after the gather
    seen = []
    confirm = PS.sharded_literal_confirm

    def spy(lit, blocks, m, *args, **kw):
        out = confirm(lit, blocks, m, *args, **kw)
        seen.append({"process_count": m.process_count,
                     "ranks": m.ranks.reshape(-1).tolist(),
                     "pairs": [len(fid) for (_g, fid, *_r) in out]})
        return out

    PS.sharded_literal_confirm = spy
    db = build_db(ht)
    small = ht.scan_batch(db, corpus_blocks(), mesh=mesh)
    small_seen = len(seen)
    big = ht.scan_batch(db, big_blocks(), mesh=mesh)
    dispatches = sum(F.family_state(db.lit).dispatches.values())
    big_seen = seen[small_seen:]
    lopsided = ht.scan_batch(db, lopsided_blocks(), mesh=mesh)
    lopsided_seen = seen[small_seen + len(big_seen):]

    tdb = ht.compile_multi(TEDDY_PATS, ids=[1, 2, 3])
    teddy = P.sharded_teddy_count(teddy_corpus(), tdb.lit.masks, mesh)
    edb = ht.compile_multi(ENGINE_PATS, ids=[10, 20, 30])
    data, lengths = engine_batch(mesh.devices.size)
    half = data.shape[0] // PROCESSES
    rows = slice(pid * half, (pid + 1) * half)
    dfa_count = P.sharded_scan_counts(edb.engines[0], data[rows],
                                      lengths[rows], mesh)
    dfa_matches = P.sharded_scan_matches(edb.engines[0], data[rows],
                                         lengths[rows], mesh, capacity=64)
    result = {
        "process_id": pid,
        "process_count": mesh.process_count,
        "global_shards": int(mesh.devices.size),
        "local_shards": len(mesh.local),
        "backend": mesh.backend,
        "small": [[list(m) for m in ms] for ms in small],
        "small_sharded": small_seen,
        "big": [[list(m) for m in ms] for ms in big],
        "big_confirm": big_seen,
        "dispatches": dispatches,
        "lopsided": [[list(m) for m in ms] for ms in lopsided],
        "lopsided_confirm": lopsided_seen,
        "teddy_count": teddy,
        "dfa_count": dfa_count,
        "dfa_matches": [t.tolist() for t in dfa_matches],
    }
    P.close_multihost_mesh()
    with open(f"{out_path}.{pid}", "w") as f:
        json.dump(result, f)
    print(f"[worker {pid}] done", flush=True)


if __name__ == "__main__":
    main()
