"""Worker process for tests/test_torch_multihost.py and
tests/test_torch_trace.py: one of several `torch.distributed` processes
of the port holding shards of one global mesh on the CPU (gloo over
127.0.0.1), running the port's sharded paths. Imports only the port.

    python tests/torch_multihost_worker.py <process_id> <port> <out_path>
        [mode]

Writes `<out_path>.<process_id>` (JSON) with what the process returned.
Mode "mesh2" (the default; two processes of four shards):
- `small`: scan_batch(mesh=) over the reference test's 16 x 700 B blocks
  (tests/multihost_worker.py), below the 64 KiB at which the literal
  path shards;
- `big`: scan_batch(mesh=) over 96 x 1,400 B blocks, above it, with what
  `sharded_literal_scan` returned and this process's family dispatches;
- `lopsided`: scan_batch(mesh=) over two blocks that fill process 0's
  shards only;
- `teddy_count`, `dfa_count`, `dfa_matches`: sharded_teddy_count over a
  replicated corpus, and sharded_scan_counts / sharded_scan_matches over
  this process's half of a global block batch.

Mode "bulk4" (four processes of one shard, as the four-card benchmark
cell runs): scan_batch(mesh=) over `bulk_blocks()` with the bench
formula's first BULK_PATTERNS rules, with what the host stages saw (a
spy on `verify_pairs`, `finish_confirmed`, `flatten_blocks` and
`corpus_tensor`); the same batch with `_gather_pairs` replaced by one
that keeps this process's own shards only; and `lopsided_blocks()`, which
leaves processes 2 and 3 without a block.

Mode "trace2" (two processes of two shards): one scan_batch(mesh=) over
`trace_blocks()` under torch.profiler: its `hs.*` events, the spans and
counters `trace.PROFILED` summed, the counters' rise and the pairs handed
to `_gather_pairs`.
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


BULK_PATTERNS = 300
BULK_BLOCKS = 64
VERBS, EXTS = ("GET", "POST", "PUT"), ("exe", "dll", "bat")


def bulk_patterns():
    """The bench formula's first BULK_PATTERNS rules and their ids."""
    from hyperscan_tpu_torch.tools import benchdata as BD

    return BD.patterns(BULK_PATTERNS)


def _rule_plant(rng, shape: int) -> bytes:
    """A string that matches a rule of `shape` (id % 6) among the first
    BULK_PATTERNS, the rule and its free parts drawn from `rng`."""
    from hyperscan_tpu_torch.tools import benchdata as BD

    i = shape + 6 * int(rng.integers(0, (BULK_PATTERNS - 1 - shape) // 6 + 1))
    w = BD.WORDS[i % len(BD.WORDS)]

    def pick(chars, n):
        return "".join(chars[j] for j in rng.integers(0, len(chars), n))

    if shape == 0:
        s = f"{w}{i}"
    elif shape == 1:
        s = f"{w}{i}{pick('0123456789', int(rng.integers(2, 5)))}z"
    elif shape == 2:
        s = (f"x{i}{VERBS[int(rng.integers(0, 3))]} /"
             f"{pick('abcdefghijklmnopqrstuvwxyz', int(rng.integers(1, 21)))}")
    elif shape == 3:
        s = f"q{i}h{pick('0123456789abcdef', 8)}"
    elif shape == 4:
        s = f"v{i}.{EXTS[int(rng.integers(0, 3))]}"
    else:
        s = f"gate{i}x{pick(('ab', 'cd'), int(rng.integers(0, 25)))}{w}{i}end"
    return s.encode()


def bulk_blocks():
    """The four-card cell's traffic cut to the CPU: BULK_BLOCKS blocks of
    64 KiB of the formula's iid noise, one salt a block, each with 2, 4, 6
    or 8 rule plants of the six shapes in turn, one in each equal slot,
    the last ending at the block's end."""
    import numpy as np

    from hyperscan_tpu_torch.tools import benchdata as BD

    rng = np.random.default_rng(2**31 + 19)
    counts = rng.permutation(np.repeat([2, 4, 6, 8], BULK_BLOCKS // 4))
    blocks = []
    for b, c in enumerate(counts):
        arr = BD.gen_corpus(1 << 16, 1000 + b, "iid")
        slot, s0 = len(arr) // c, int(rng.integers(0, 6))
        for j in range(c):
            p = _rule_plant(rng, (s0 + j) % 6)
            at = len(arr) - len(p) if j == c - 1 else \
                j * slot + int(rng.integers(0, slot - len(p) + 1))
            arr[at:at + len(p)] = np.frombuffer(p, np.uint8)
        blocks.append(arr.tobytes())
    return blocks


# tests/test_torch_trace.py's PATTERNS: three chain rules and a literal
TRACE_PATTERNS = [r"lead\d{4,}tail", r"alpha[a-z]{2,}omega",
                  r"gamma\s+delta", "attack"]


def trace_blocks():
    """Eight 40 KiB blocks, each holding matches of the three chain rules
    of tests/test_torch_trace.py's PATTERNS and its literal: two blocks a
    shard of a four-shard mesh."""
    head = b"x lead1234tail y alpha%02dzzomega attack gamma  delta "
    return [(head % i + b"." * (40 << 10))[:40 << 10] for i in range(8)]


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


def _lists(ms):
    return [[list(m) for m in b] for b in ms]


def _spy(mod, name: str, seen: list, what):
    """Wrap `mod.name` so that each call appends what(args) to seen."""
    orig = getattr(mod, name)

    def spy(*args, **kw):
        seen.append(what(*args))
        return orig(*args, **kw)

    setattr(mod, name, spy)
    return orig


def _crc(a) -> int:
    import zlib

    import numpy as np

    return zlib.crc32(np.ascontiguousarray(a, dtype=np.uint8).tobytes())


def run_mesh2(pid: int, mesh) -> dict:
    import numpy as np

    import hyperscan_tpu_torch as ht
    from hyperscan_tpu_torch import parallel as P
    from hyperscan_tpu_torch.ops import teddy_families as F
    from hyperscan_tpu_torch.parallel import sharded as PS

    # what scan_batch's sharded literal path saw: the mesh, and each
    # shard's matches (records and ranges) after the exchange
    seen = []
    scan = PS.sharded_literal_scan

    def spy(db, blocks, m, *args, **kw):
        recs, rng = scan(db, blocks, m, *args, **kw)
        n = m.devices.size
        shard = np.zeros(len(blocks), np.int64)
        for d, g in enumerate(PS.partition_blocks(blocks, n)):
            shard[g] = d
        seen.append({"process_count": m.process_count,
                     "ranks": m.ranks.reshape(-1).tolist(),
                     "matches": np.bincount(
                         shard[np.concatenate([recs[:, 0], rng[:, 0]])],
                         minlength=n).tolist()})
        return recs, rng

    PS.sharded_literal_scan = spy
    db = build_db(ht)
    small = ht.scan_batch(db, corpus_blocks(), mesh=mesh)
    small_seen = len(seen)
    big = ht.scan_batch(db, big_blocks(), mesh=mesh)
    dispatches = sum(F.family_state(db.lit).dispatches.values())
    big_seen = seen[small_seen:]
    lopsided = ht.scan_batch(db, lopsided_blocks(), mesh=mesh)
    lopsided_seen = seen[small_seen + len(big_seen):]
    PS.sharded_literal_scan = scan

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
    return {
        "small": _lists(small),
        "small_sharded": small_seen,
        "big": _lists(big),
        "big_confirm": big_seen,
        "dispatches": dispatches,
        "lopsided": _lists(lopsided),
        "lopsided_confirm": lopsided_seen,
        "teddy_count": teddy,
        "dfa_count": dfa_count,
        "dfa_matches": [t.tolist() for t in dfa_matches],
    }


def run_bulk4(pid: int, mesh) -> dict:
    """Mode "bulk4": see the module's docstring. `*_stages` lists the
    host stages' calls as (stage, blocks, bytes, crc32 of the bytes)."""
    import numpy as np

    import hyperscan_tpu_torch as ht
    from hyperscan_tpu_torch.ops import teddy as TD
    from hyperscan_tpu_torch.parallel import sharded as PS
    from hyperscan_tpu_torch.runtime import lit_runtime as LR

    pats, ids = bulk_patterns()
    db = ht.compile_multi(pats, ids=ids)
    seen = []
    spies = {
        (LR, "verify_pairs"): lambda lit, c, s, *a: ("verify", c, len(s)),
        (LR, "finish_confirmed"): lambda d, c, s, *a: ("windows", c, len(s)),
        (TD, "flatten_blocks"): lambda bl: (
            "flatten", np.frombuffer(b"".join(bl), np.uint8), len(bl)),
        (TD, "corpus_tensor"): lambda c, dev: ("upload", c, 0),
    }
    origs = {k: _spy(*k, seen, fn) for k, fn in spies.items()}

    def stages(batch):
        del seen[:]
        out = _lists(ht.scan_batch(db, batch, mesh=mesh))
        return out, [(name, nb, len(c), _crc(c)) for name, c, nb in seen]

    bulk = bulk_blocks()
    out = {}
    out["bulk"], out["bulk_stages"] = stages(bulk)
    out["lopsided"], out["lopsided_stages"] = stages(bulk[:2])
    for (mod, name), orig in origs.items():
        setattr(mod, name, orig)

    def own_only(local, m):
        empty = (np.zeros(0, np.int64), np.zeros(0, np.int64))
        got = [empty] * m.ranks.size
        for j, d in enumerate(m.local):
            got[d] = local[j]
        return got

    gather, PS._gather_pairs = PS._gather_pairs, own_only
    try:
        out["own_only"] = _lists(ht.scan_batch(db, bulk, mesh=mesh))
    finally:
        PS._gather_pairs = gather
    return out


def run_trace2(pid: int, mesh, out_path: str) -> dict:
    """Mode "trace2": see the module's docstring."""
    import numpy as np
    import torch

    import hyperscan_tpu_torch as ht
    from hyperscan_tpu_torch import trace as T
    from hyperscan_tpu_torch.parallel import sharded as PS

    db = ht.compile_multi(TRACE_PATTERNS, ids=[1, 2, 3, 4])
    blocks = trace_blocks()
    want = ht.scan_batch(db, blocks, mesh=mesh)  # learns the capacities
    handed = []
    gather = _spy(PS, "_gather_pairs", handed, lambda local, m: sum(
        np.asarray(a, np.int64).nbytes + np.asarray(b, np.int64).nbytes
        for a, b in local))
    before = dict(T.COUNTS)
    T.reset_profiled()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        got = ht.scan_batch(db, blocks, mesh=mesh)
    PS._gather_pairs = gather
    path = f"{out_path}.{pid}.trace.json"
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.remove(path)
    return {
        "equal": got == want and all(got),
        "events": [{k: e[k] for k in ("name", "ts", "dur", "tid")}
                   for e in events if e.get("ph") == "X"
                   and str(e.get("name", "")).startswith("hs.")],
        "spans": dict(T.PROFILED.spans),
        "counts": dict(T.PROFILED.counts),
        "rise": {k: T.COUNTS[k] - before[k] for k in T.COUNTS},
        "handed": handed,
    }


MODES = {"mesh2": (PROCESSES, LOCAL_SHARDS), "bulk4": (4, 1),
         "trace2": (2, 2)}


def spawn(mode: str, out_path: str, timeout: float = 240) -> list:
    """Run the mode's processes to their end, each exited 0, on a free
    port of 127.0.0.1; their results in process order."""
    import socket
    import subprocess

    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
                        "LOCAL_RANK", "LOCAL_WORLD_SIZE")}
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = str(sock.getsockname()[1])
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               str(pid), port, out_path, mode],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE)
             for pid in range(MODES[mode][0])]
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, (so.decode()[-2000:], se.decode()[-2000:])
    res = []
    for pid in range(len(procs)):
        with open(f"{out_path}.{pid}") as f:
            res.append(json.load(f))
    return res


def main() -> None:
    pid, port, out_path = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    mode = sys.argv[4] if len(sys.argv) > 4 else "mesh2"

    import torch

    torch.set_num_threads(2)
    from hyperscan_tpu_torch import parallel as P

    processes, n_local = MODES[mode]
    mesh = P.make_multihost_mesh(
        coordinator_address=f"127.0.0.1:{port}", num_processes=processes,
        process_id=pid, device="cpu", n_local=n_local)
    if mode == "mesh2":
        result = run_mesh2(pid, mesh)
    elif mode == "bulk4":
        result = run_bulk4(pid, mesh)
    else:
        result = run_trace2(pid, mesh, out_path)
    result.update({
        "process_id": pid,
        "process_count": mesh.process_count,
        "global_shards": int(mesh.devices.size),
        "local_shards": len(mesh.local),
        "backend": mesh.backend,
    })
    P.close_multihost_mesh()
    with open(f"{out_path}.{pid}", "w") as f:
        json.dump(result, f)
    print(f"[worker {pid}] done", flush=True)


if __name__ == "__main__":
    main()
