"""Graft entry points of the port: a one-device block-scan step and a
dry run of the sharded scan over an n-shard mesh.

The counterpart of the JAX package's `__graft_entry__.py`, with the same
names, patterns and example batch:

- `entry(device)` returns `(fn, args)`: `fn` is a plain function on
  tensors (torch has no jit to hand it to) that runs the batched DFA scan
  (`ops.dfa.dfa_scan_batch`: kernel C's row mode on the card), the match
  extraction and the EOD accept lookup; `args` are the engine's tables and
  the example batch on `device`.
- `dryrun_multichip(n, device)` runs the reference's five steps on the
  port's `parallel.sharded`: the batch padded for the mesh, the sharded
  DFA counts against the gathered matches, the sharded literal filter
  count (kernel 7's count mode), the product path `scan_batch(mesh=)`
  against the unsharded `scan_batch`, and a scaling-proxy line. Every
  check raises.

On the CPU the mesh is `make_mesh(n, device="cpu")`; on the card it is n
cards where that many are visible, else n shards of card 0. A mesh of
another size than n raises.

Usage:

    python -m hyperscan_tpu_torch.graft_entry [--devices N] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

PATTERNS = [
    r"foo[a-z]+bar",
    r"(abc|def)+x",
    r"[0-9]{3}-[0-9]{4}",
    r"GET /[^ ]* HTTP/1\.[01]",
    r"error|warning|fatal",
]
BATCH, LENGTH = 8, 1024  # the example batch
CAPACITY = 1024  # match slots of the step's extraction
PRODUCT_BLOCK = 40_000  # the product path's blocks: 3n of 40,000 bytes
PRODUCT_PATTERNS = (["attack" + str(i) for i in range(40)]
                    + [rf"q{i}h[a-f0-9]{{4}}" for i in range(40)])


def build_engine():
    """The first engine of the five patterns' database (the bounded group,
    which holds [0-9]{3}-[0-9]{4})."""
    from . import compile_multi

    db = compile_multi(PATTERNS, ids=list(range(len(PATTERNS))))
    return db.engines[0]


def example_batch(batch: int = BATCH, length: int = LENGTH):
    """(data [batch, length] uint8, lengths [batch] int32): printable bytes
    from seed 0, with 012-3456 planted at the start of block 0."""
    rng = np.random.default_rng(0)
    data = rng.integers(32, 127, size=(batch, length), dtype=np.uint8)
    data[0, :10] = np.frombuffer(b"012-3456  ", dtype=np.uint8)
    lengths = np.full((batch,), length, dtype=np.int32)
    return data, lengths


def scan_step(trans, b2c, accept_id, accept_eod_id, start_state, data,
              lengths):
    """One block-scan step: (total, set_ids, blocks, tos, eod_sets)."""
    from .ops.dfa import dfa_scan_batch
    from .ops.match import extract_matches

    accepts, finals = dfa_scan_batch(trans, b2c, accept_id, start_state,
                                     data, lengths)
    total, set_ids, blocks, tos = extract_matches(accepts, CAPACITY)
    return total, set_ids, blocks, tos, accept_eod_id[finals.long()]


def entry(device="cuda"):
    """(fn, args): the block-scan step and its inputs on `device` (the
    card unless the caller asks for "cpu"; a missing card raises)."""
    from .runtime.scan import resolve_device

    dev = resolve_device(device)
    e = build_engine()
    data, lengths = example_batch()

    def on(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a).astype(dtype)).to(dev)

    args = (on(e.trans, np.int32), on(e.byte_to_class, np.int32),
            on(e.accept_id, np.int32), on(e.accept_eod_id, np.int32),
            torch.tensor(int(e.start_state), dtype=torch.int32, device=dev),
            on(data, np.uint8), on(lengths, np.int32))
    return scan_step, args


def dfa_blocks(n: int) -> list:
    """The dry run's DFA batch: three blocks a shard."""
    return [b"xx fooaabar yy" * 4, b"012-3456 hello", b"no match here"] * n


def literal_corpus(n: int) -> np.ndarray:
    """The sharded filter's corpus: one attack and one warning a shard."""
    return np.frombuffer(
        (b"x" * 700 + b"attack" + b"y" * 600 + b"warning") * n,
        dtype=np.uint8)


def product_blocks(n: int) -> list:
    """The product path's 3n blocks of PRODUCT_BLOCK printable bytes from
    seed 1, each with attack3 at 100 and q5hbeef at 20,000."""
    rng = np.random.default_rng(1)
    out = []
    for _b in range(3 * n):
        c = (32 + rng.integers(0, 95, size=PRODUCT_BLOCK)).astype(np.uint8)
        c[100:108] = np.frombuffer(b"attack3 ", np.uint8)
        c[20_000:20_008] = np.frombuffer(b"q5hbeef ", np.uint8)
        out.append(c.tobytes())
    return out


def dryrun_mesh(n_devices: int, device="cuda"):
    """The dry run's mesh of `n_devices` shards: on the CPU, CPU shards;
    on the card, the first n cards where that many are visible, else n
    shards of card 0."""
    from .parallel.sharded import SHARD_AXIS, Mesh, make_mesh
    from .runtime.scan import resolve_device

    if int(n_devices) < 1:
        raise ValueError("a dry run needs at least one shard")
    dev = resolve_device(device)
    if dev.type != "cuda" or torch.cuda.device_count() >= n_devices:
        return make_mesh(n_devices, device=dev.type)
    return Mesh([torch.device("cuda", 0)] * int(n_devices), (SHARD_AXIS,))


def dryrun_multichip(n_devices: int, device="cuda", mesh=None) -> dict:
    """The sharded scan step over an n-shard mesh (`mesh`, or
    `dryrun_mesh(n_devices, device)`): the database on every shard, the
    block batch split along the batch axis, counts summed and match
    buffers gathered. Raises on any disagreement, and where the mesh
    has another number of shards than `n_devices`. Returns what it
    measured: the DFA count, the literal filter count, the product
    path's unsharded and sharded match lists, and the scaling proxy's
    seconds; and what its steps scanned with (the DFA engine, the
    literal database, the product database and blocks), so that a
    caller can hold the kernels to their plain versions there."""
    from . import compile_multi, scan_batch
    from .parallel.sharded import (SHARD_AXIS, Mesh, _as_shard_mesh,
                                   pad_batch_for_mesh, sharded_scan_counts,
                                   sharded_scan_matches, sharded_teddy_count)

    n = int(n_devices)
    mesh = dryrun_mesh(n, device) if mesh is None else mesh
    shards = _as_shard_mesh(mesh).devices.size
    if shards != n:
        raise ValueError(f"dry run of {n} shards on a mesh of {shards}")
    first = _as_shard_mesh(mesh).first

    # the DFA step: psum'd counts against the all_gather'd buffers
    e = build_engine()
    data, lengths = pad_batch_for_mesh(dfa_blocks(n), mesh, pad_len=128)
    count = sharded_scan_counts(e, data, lengths, mesh)
    totals, _set_ids, _rows, _tos, _eod = sharded_scan_matches(
        e, data, lengths, mesh, capacity=64)
    got = int(totals.sum())
    if got != count:
        raise RuntimeError(f"gathered {got} != psum {count}")
    if count <= 0:
        raise RuntimeError("dry run produced no matches")

    # the literal filter sharded over the mesh (kernel 7's count mode)
    ldb = compile_multi(["attack", "error|warning"], ids=[1, 2])
    lc = sharded_teddy_count(literal_corpus(n), ldb.lit.masks, mesh)
    if lc < 2 * n:
        raise RuntimeError(f"teddy dry run found {lc} candidates")

    # the product path: scan_batch with the mesh equals the unsharded
    # scan, block by block
    pdb = compile_multi(PRODUCT_PATTERNS, ids=list(range(80)))
    pblocks = product_blocks(n)
    single = scan_batch(pdb, pblocks, device=first)
    sharded = scan_batch(pdb, pblocks, mesh=mesh)
    if len(single) != len(sharded) or not all(
            sorted(a) == sorted(b) for a, b in zip(single, sharded)):
        raise RuntimeError("sharded scan_batch diverged from the unsharded")
    if sum(len(x) for x in single) < 2 * 3 * n:
        raise RuntimeError("the product path missed its plants")

    # scaling proxy on the product path: a one-shard mesh on the first
    # device against the n-shard mesh, each warmed first
    mesh1 = Mesh([first], (SHARD_AXIS,))
    secs = []
    for m in (mesh1, mesh):
        scan_batch(pdb, pblocks, mesh=m)
        if first.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        scan_batch(pdb, pblocks, mesh=m)
        if first.type == "cuda":
            torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    where = sorted({str(d) for d in mesh.devices.flat})
    print(f"[dryrun] scaling proxy (product scan_batch, {len(pblocks)} "
          f"blocks x {PRODUCT_BLOCK // 1000}KB): 1 shard {secs[0]:.3f}s -> "
          f"{n} shards {secs[1]:.3f}s (x{secs[0] / max(secs[1], 1e-9):.2f} "
          f"wall; shards on {', '.join(where)})", flush=True)
    return {"count": count, "teddy_count": lc, "single": single,
            "sharded": sharded, "proxy_s": tuple(secs),
            "devices": [str(d) for d in mesh.devices.flat], "mesh": mesh,
            "engine": e, "literal_db": ldb, "product_db": pdb,
            "product_blocks": pblocks}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="The port's graft entry points: the block-scan step "
                    "and the multi-shard dry run.")
    ap.add_argument("--devices", type=int, default=8,
                    help="shards of the dry run's mesh (default 8)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    fn, fargs = entry(args.device)
    total, _s, _b, _t, eod = fn(*fargs)
    print(f"[entry] {args.device}: {int(total)} matches over "
          f"{BATCH} x {LENGTH} bytes, {int((eod != 0).sum())} EOD sets",
          flush=True)
    if int(total) <= 0:
        raise RuntimeError("the block-scan step found no match")
    r = dryrun_multichip(args.devices, args.device)
    print(f"[dryrun] {args.devices} shards on {sorted(set(r['devices']))}: "
          f"DFA count {r['count']}, teddy candidates {r['teddy_count']}, "
          f"product path {sum(map(len, r['single']))} matches, sharded == "
          f"unsharded", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
