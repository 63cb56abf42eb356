"""Multi-device scanning: corpus shards data-parallel over a device mesh.

Port of `hyperscan_tpu/parallel/sharded.py`:

- the pattern database (DFA tables, literal tables) is uploaded once to
  every device and cached per device;
- the corpus blocks or segments are split across the mesh's entries, one
  shard each, and each shard's work is launched on its device's current
  stream;
- the collectives are explicit: `psum` sums the per-shard results and
  `all_gather` stacks them, on this process's first device. The host
  reads once, at the end.

A `Mesh` holds an array of `torch.device`s of any shape with its axis
names; an entry is one shard, and a mesh built by hand may name one
device more than once (several shards on one card, which exercises the
shard boundaries on one card). `make_mesh(n, device="cpu")` is the
counterpart of the reference tests' virtual 8-device CPU mesh.

One process drives every entry of a mesh from `make_mesh` (the
reference's single-controller `shard_map`). `make_multihost_mesh` is the
counterpart of `jax.distributed`: it starts `torch.distributed`, one
process per card, and builds the same global mesh on every process, each
entry marked with the rank that owns it (`Mesh.ranks`). A process
launches work only on its own entries (`Mesh.local`), and `psum` /
`all_gather` then reduce and gather over the group, so every process
returns the same global result. The input contracts are the reference's:

- the literal path (`scan_batch(mesh=)` through `sharded_literal_scan`,
  `scan_streams(mesh=)` through `sharded_literal_confirm`) and
  `sharded_teddy_count` take the same global input on every process. A
  block scan runs the host stages of its own shards and exchanges their
  finished matches; a stream scan exchanges the shards' confirmed pairs;
- `sharded_scan_counts` and `sharded_scan_matches` take each process's
  own rows, padded to a multiple of its shard count
  (`global_shard_arrays`).
"""

from __future__ import annotations

import contextlib
import datetime
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.dfa import dfa_scan_batch
from ..ops.match import count_matches, extract_matches
from ..trace import count, span

SHARD_AXIS = "shards"
LOOKBACK = 8  # bytes before a segment that its first positions read
# (the filter's suffix depth M is at most 8, so at most 7 are needed)
GROUP_TIMEOUT_S = 60  # a lost peer fails the init or a collective after
# this long instead of hanging it


class Mesh:
    """Devices of a mesh: `devices` is a numpy object array of
    `torch.device`s whose number of dimensions equals that of
    `axis_names`. `ranks` (same shape) is the process that owns each
    entry; by default this process owns every entry. A mesh with
    `process_count` > 1 comes from `make_multihost_mesh`, and its
    collectives run over the `torch.distributed` group on `backend`."""

    def __init__(self, devices, axis_names: Sequence[str], ranks=None,
                 process_id: int = 0, process_count: int = 1,
                 backend: Optional[str] = None):
        given = np.asarray(devices, dtype=object)
        devs = np.empty(given.shape, dtype=object)
        for idx in np.ndindex(given.shape):
            devs[idx] = torch.device(given[idx])
        if devs.ndim != len(tuple(axis_names)) or devs.size == 0:
            raise ValueError("a mesh needs one axis name per dimension and "
                             "at least one device")
        ranks = np.full(devs.shape, process_id, np.int64) if ranks is None \
            else np.asarray(ranks, dtype=np.int64)
        if ranks.shape != devs.shape or not (ranks == process_id).any():
            raise ValueError("ranks must have the devices' shape and give "
                             "this process at least one entry")
        self.devices = devs
        self.axis_names = tuple(axis_names)
        self.ranks = ranks
        self.process_id = int(process_id)
        self.process_count = int(process_count)
        self.backend = backend

    @property
    def local(self) -> List[int]:
        """Flat indices of this process's entries, in mesh order."""
        return np.flatnonzero(self.ranks.reshape(-1)
                              == self.process_id).tolist()

    @property
    def first(self) -> torch.device:
        """This process's first device: the unsharded half of a scan runs
        there, and the collectives gather there."""
        return self.devices.flat[self.local[0]]

    @property
    def distributed(self) -> bool:
        """Whether the mesh spans several processes."""
        return self.process_count > 1

    def __repr__(self) -> str:
        procs = (f", process {self.process_id} of {self.process_count} on "
                 f"{self.backend}" if self.distributed else "")
        return (f"Mesh({[str(d) for d in self.devices.flat]}, shape "
                f"{self.devices.shape}, axes {self.axis_names}{procs})")


def make_mesh(n_devices: Optional[int] = None, device="cuda") -> Mesh:
    """1-D mesh over the first `n_devices` visible cards (all by
    default); with device="cpu", `n_devices` shards (1 by default) on the
    CPU. Raises where there are fewer cards than asked for, or none."""
    kind = torch.device(device).type
    if kind == "cpu":
        n = 1 if n_devices is None else int(n_devices)
        if n < 1:
            raise ValueError("a mesh needs at least one shard")
        return Mesh([torch.device("cpu")] * n, (SHARD_AXIS,))
    if kind != "cuda":
        raise ValueError(f"unsupported device {device!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("make_mesh: torch.cuda.is_available() is False; "
                           "pass device='cpu' for a CPU mesh")
    have = torch.cuda.device_count()
    n = have if n_devices is None else int(n_devices)
    if not 1 <= n <= have:
        raise RuntimeError(f"make_mesh: {n} cards asked for, {have} "
                           "visible")
    return Mesh([torch.device("cuda", i) for i in range(n)], (SHARD_AXIS,))


def _as_shard_mesh(mesh: Mesh) -> Mesh:
    """Any mesh flattens to a 1-D mesh named SHARD_AXIS over the same
    entries: the scan is pure data-parallel (reference:
    hyperscan_tpu/parallel/sharded.py:42)."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a hyperscan_tpu_torch.parallel.Mesh, "
                        f"not {type(mesh).__name__}")
    if mesh.axis_names == (SHARD_AXIS,):
        return mesh
    return Mesh(mesh.devices.reshape(-1), (SHARD_AXIS,),
                mesh.ranks.reshape(-1), mesh.process_id, mesh.process_count,
                mesh.backend)


_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR")


def _local_card(rank: int) -> torch.device:
    """This process's card: `LOCAL_RANK` where torchrun set it, else the
    rank modulo the visible cards."""
    if not torch.cuda.is_available():
        raise RuntimeError("make_multihost_mesh: torch.cuda.is_available() "
                           "is False; pass device='cpu' for CPU shards")
    k = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", k % torch.cuda.device_count())


def _backend(kind: str, world: int) -> str:
    """NCCL where every process of this host has a card of its own; gloo
    on the CPU and where processes share a card (NCCL refuses two ranks
    on one device)."""
    import torch.distributed as dist

    here = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if kind == "cuda" and dist.is_nccl_available() and \
            torch.cuda.device_count() >= here:
        return "nccl"
    return "gloo"


def make_multihost_mesh(coordinator_address: Optional[str] = None,
                        num_processes: Optional[int] = None,
                        process_id: Optional[int] = None, *,
                        device="cuda", n_local: Optional[int] = None
                        ) -> Mesh:
    """1-D mesh over the shards of every process of the job.

    Starts `torch.distributed` when a coordinator ("host:port") is given
    or torchrun's environment (RANK, WORLD_SIZE, MASTER_ADDR) is set, and
    joins a group that is already up (reference:
    hyperscan_tpu/parallel/sharded.py:53-97). Each process holds `n_local`
    shards (1 by default): on its card (`cuda:LOCAL_RANK`, else the rank
    modulo the visible cards), or on the CPU with device="cpu". The
    processes exchange their shard lists, so every process builds the
    same mesh, rank 0's entries first. The group uses NCCL where every
    process has a card of its own and gloo otherwise (`Mesh.backend`); a
    collective that waits past GROUP_TIMEOUT_S raises. A failed init
    raises: there is no fallback to one process.

    Without a coordinator, the environment or a group, and with one
    process: `make_mesh(n_local, device)`. `close_multihost_mesh` tears
    the group down."""
    import torch.distributed as dist

    if coordinator_address is not None and (num_processes is None
                                            or process_id is None):
        raise ValueError("a coordinator_address needs num_processes and "
                         "process_id")
    if num_processes is not None and int(num_processes) < 1:
        raise ValueError(f"num_processes {num_processes} < 1")
    if process_id is not None and not \
            0 <= int(process_id) < int(num_processes or 1):
        raise ValueError(f"process_id {process_id} is not a rank of "
                         f"{num_processes or 1} processes")
    kind = torch.device(device).type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device!r}")
    n = 1 if n_local is None else int(n_local)
    if n < 1:
        raise ValueError("a process needs at least one shard")
    env = all(k in os.environ for k in _TORCHRUN_ENV)
    up = dist.is_available() and dist.is_initialized()
    if coordinator_address is None and not env and not up:
        if int(num_processes or 1) > 1:
            raise ValueError("more than one process needs a "
                             "coordinator_address or torchrun's environment")
        return make_mesh(n_local, device)
    if not up:
        if coordinator_address is not None:
            init = f"tcp://{coordinator_address}"
            world, rank = int(num_processes), int(process_id)
        else:
            init = "env://"
            world, rank = int(os.environ["WORLD_SIZE"]), \
                int(os.environ["RANK"])
        if kind == "cuda":
            torch.cuda.set_device(_local_card(rank))
        dist.init_process_group(
            _backend(kind, world), init_method=init, world_size=world,
            rank=rank, timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    world, rank = dist.get_world_size(), dist.get_rank()
    own = [torch.device("cpu")] * n if kind == "cpu" else \
        [_local_card(rank)] * n
    if kind == "cuda":
        torch.cuda.set_device(own[0])
    shards = [None] * world
    dist.all_gather_object(shards, [str(d) for d in own])
    devices = [d for r in range(world) for d in
               (own if r == rank else shards[r])]
    ranks = [r for r in range(world) for _ in shards[r]]
    return Mesh(np.array(devices, dtype=object), (SHARD_AXIS,), ranks,
                process_id=rank, process_count=world,
                backend=dist.get_backend())


def close_multihost_mesh() -> None:
    """Tear down the `torch.distributed` group (a no-op where none is
    up), so that a script of several processes exits cleanly."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def _on(device):
    """Make `device` the current CUDA device while a shard's work is
    launched: a kernel launches on the current device, and a stream of
    another card is refused. A no-op for a CPU device."""
    if torch.device(device).type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _stage(mesh: Mesh) -> torch.device:
    """Where the group's collectives take their tensors: the host under
    gloo (whose all_gather takes only CPU tensors), this process's card
    under NCCL."""
    return torch.device("cpu") if mesh.backend == "gloo" else mesh.first


def _gather_processes(t: torch.Tensor, mesh: Mesh) -> List[torch.Tensor]:
    """Every process's `t`, in rank order, on this process's first
    device. The first dimension may differ between the processes (each
    is padded to the largest for the exchange, then trimmed); the others
    may not. Every process of the mesh must call it."""
    import torch.distributed as dist

    stage = _stage(mesh)
    shape = torch.tensor(list(t.shape), dtype=torch.int64, device=stage)
    shapes = [torch.empty_like(shape) for _ in range(mesh.process_count)]
    dist.all_gather(shapes, shape)
    shapes = [tuple(s.tolist()) for s in shapes]
    if any(s[1:] != tuple(t.shape[1:]) for s in shapes):
        raise ValueError(f"the processes' tensors differ past their first "
                         f"dimension: {shapes}")
    pad = torch.zeros((max(1, *(s[0] for s in shapes)), *t.shape[1:]),
                      dtype=t.dtype, device=stage)
    pad[:t.shape[0]] = t
    parts = [torch.empty_like(pad) for _ in shapes]
    dist.all_gather(parts, pad)
    return [p[:s[0]].to(mesh.first) for p, s in zip(parts, shapes)]


def _rank_order(mesh: Mesh) -> torch.Tensor:
    """The permutation that takes the entries in rank order (rank 0's,
    then rank 1's, ...) to mesh order."""
    flat = mesh.ranks.reshape(-1)
    order = np.concatenate([np.flatnonzero(flat == r)
                            for r in range(mesh.process_count)])
    return torch.from_numpy(np.argsort(order, kind="stable"))


def psum(values: Sequence[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """Sum of one tensor per shard of this process, over every shard of
    the mesh, on this process's first device."""
    dev = mesh.first
    out = values[0].to(dev)
    for v in values[1:]:
        out = out + v.to(dev)
    if mesh.distributed:
        import torch.distributed as dist

        t = out.to(_stage(mesh), copy=True)
        dist.all_reduce(t)
        out = t.to(dev)
    return out


def all_gather(values: Sequence[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """One tensor per shard of this process, stacked over every shard of
    the mesh in mesh order, on this process's first device."""
    dev = mesh.first
    out = torch.stack([v.to(dev) for v in values])
    if mesh.distributed:
        out = torch.cat(_gather_processes(out, mesh))[
            _rank_order(mesh).to(dev)]
    return out


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:
        a = a.copy()
    return torch.from_numpy(a).to(device)


def global_shard_arrays(mesh: Mesh, data: np.ndarray, lengths: np.ndarray
                        ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Split a [B, L] batch and its [B] lengths into one equal run of
    rows per shard of this process, each uploaded to its shard's device
    (reference: hyperscan_tpu/parallel/sharded.py:100-115). On a mesh of
    several processes each passes only its own rows, which address the
    global batch in rank order. B must be a multiple of this process's
    shard count (`pad_batch_for_mesh`)."""
    devs = [mesh.devices.flat[d] for d in mesh.local]
    B = data.shape[0]
    if B % len(devs):
        raise ValueError(f"{B} rows do not split over {len(devs)} shards")
    r = B // len(devs)
    lengths = np.asarray(lengths, dtype=np.int32)
    return [(_tensor(data[d * r:(d + 1) * r], dev),
             _tensor(lengths[d * r:(d + 1) * r], dev))
            for d, dev in enumerate(devs)]


def pad_batch_for_mesh(blocks: Sequence[bytes], mesh: Mesh, pad_len: int
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Pack blocks into [B, L] uint8 + [B] lengths, padding the batch to a
    multiple of the mesh size (empty rows scan as no-ops)."""
    n = mesh.devices.size
    B = max(((len(blocks) + n - 1) // n) * n, n)
    data = np.zeros((B, pad_len), dtype=np.uint8)
    lengths = np.zeros((B,), dtype=np.int32)
    for i, blk in enumerate(blocks):
        a = np.frombuffer(blk, dtype=np.uint8)
        data[i, : len(a)] = a
        lengths[i] = len(a)
    return data, lengths


def _engine_tables(engine, device):
    """(trans [S, C], b2c, accept_id, accept_eod_id) on `device`, cached
    on the engine per device."""
    from ..ops.dfa_kernel import device_tables

    t = device_tables(engine, device)
    cache = engine.__dict__.setdefault("_torch_eod_ids", {})
    key = str(torch.device(device))
    if key not in cache:
        cache[key] = _tensor(np.asarray(engine.accept_eod_id, np.int32),
                             device)
    return t.trans.view(t.S, t.C), t.b2c, t.accept, cache[key]


def _scan_shards(engine, data, lengths, mesh):
    """dfa_scan_batch on every shard of this process: [(accepts, finals,
    eod table)]."""
    out = []
    for (d_t, l_t) in global_shard_arrays(mesh, data, lengths):
        with _on(d_t.device):
            trans, b2c, acc, eod = _engine_tables(engine, d_t.device)
            accepts, finals = dfa_scan_batch(trans, b2c, acc,
                                             int(engine.start_state), d_t,
                                             l_t)
        out.append((accepts, finals, eod))
    return out


def sharded_scan_counts(engine, data: np.ndarray, lengths: np.ndarray,
                        mesh: Mesh) -> int:
    """Global match count of one engine over a sharded block batch (on a
    mesh of several processes, each passes its own rows)."""
    mesh = _as_shard_mesh(mesh)
    local = [count_matches(a) for (a, _f, _e) in
             _scan_shards(engine, data, lengths, mesh)]
    return int(psum(local, mesh))


def sharded_scan_matches(engine, data: np.ndarray, lengths: np.ndarray,
                         mesh: Mesh, capacity: int = 4096):
    """Match tuples of one engine over a sharded block batch.

    Returns tensors on this process's first device, gathered over every
    shard of the mesh: (total_per_shard [n], set_ids [n, cap], blocks
    [n, cap] local row index, tos [n, cap], eod_sets [n, rows/shard]).
    Callers translate local rows to global rows with shard *
    rows_per_shard + row. On a mesh of several processes each passes its
    own rows, the same number on every process."""
    mesh = _as_shard_mesh(mesh)
    parts = []
    for (accepts, finals, eod) in _scan_shards(engine, data, lengths, mesh):
        with _on(accepts.device):
            total, set_ids, blocks, tos = extract_matches(accepts, capacity)
            parts.append((total, set_ids, blocks, tos, eod[finals.long()]))
    return tuple(all_gather([p[i] for p in parts], mesh) for i in range(5))


def segments(n: int, n_shards: int) -> List[Tuple[int, int]]:
    """[lo, hi) of each shard's segment of an n-byte corpus: equal
    segments, 16-byte multiples, in order (trailing ones may be empty)."""
    per = -(-n // n_shards)
    seg = max(16, -(-per // 16) * 16)
    return [(min(n, d * seg), min(n, (d + 1) * seg))
            for d in range(n_shards)]


def sharded_teddy_count(corpus: np.ndarray, masks: np.ndarray,
                        mesh: Mesh) -> int:
    """Literal-filter candidate count over a corpus sharded across the
    mesh: masks uploaded to every device, corpus segments data-parallel,
    each with the LOOKBACK bytes before it (the reference's halo row),
    counted by kernel 7's count mode and summed. Shard 0 sees zero bytes
    before offset 0, so the count equals kernel 7's over the whole
    corpus, whatever the segmentation. On a mesh of several processes
    every process passes the whole corpus and counts its own shards'
    segments."""
    from ..ops.teddy import mask_tables
    from ..ops.teddy_words import filter_words_count

    mesh = _as_shard_mesh(mesh)
    devs = list(mesh.devices.flat)
    n = int(corpus.shape[0])
    segs = segments(n, len(devs))
    local = [torch.zeros((), dtype=torch.int64, device=mesh.first)]
    tabs = {}
    for d in mesh.local:
        dev, (lo, hi) = devs[d], segs[d]
        if hi <= lo:
            continue
        back = min(lo, LOOKBACK)
        key = str(dev)
        with _on(dev):
            if key not in tabs:
                tabs[key] = mask_tables(masks, dev)
            part = _tensor(corpus[lo - back:hi], dev)
            local.append(filter_words_count(part, tabs[key], back).long()
                         .sum())
    return int(psum(local, mesh))


def partition_blocks(blocks, n_shards: int):
    """Contiguous block partition balancing total bytes per shard."""
    total = sum(len(b) for b in blocks)
    target = max(1, -(-total // n_shards))
    groups = []
    cur = []
    acc = 0
    for i, b in enumerate(blocks):
        cur.append(i)
        acc += len(b)
        if acc >= target and len(groups) < n_shards - 1:
            groups.append(cur)
            cur, acc = [], 0
    groups.append(cur)
    while len(groups) < n_shards:
        groups.append([])
    return groups


def _confirm_local(lit, blocks, mesh: Mesh, capacity: int, flat=None):
    """Filter + hash confirm of this process's shards of a block batch.

    Blocks partition contiguously across the mesh's entries
    (`partition_blocks`, which reads only their lengths). Each of this
    process's shards is uploaded to its device and scanned there by the
    literal path's own dispatcher (`ops.teddy_families`), so a shard runs
    the family that the unsharded scan would run and learns the same
    capacities. Every shard's meta and pairs are read back in one copy; a
    shard whose outputs overflowed is dispatched again on its device.

    `flat` is `ops.teddy.flatten_blocks(blocks)`, when the caller has it,
    and every shard's bytes are sliced from it; without it only this
    process's shards' blocks are flattened, shard by shard.

    Returns per shard of the mesh, in mesh order, (block_indices,
    corpus_array, starts, ends, fid_array, flat_pos_array); a shard of
    another process has no pairs, and where `flat` is None neither it nor
    an empty shard has bytes (None)."""
    from ..ops.teddy import corpus_tensor, flatten_blocks
    from ..ops.teddy_families import (confirm_fetch_many, confirm_finish,
                                      confirm_start)

    devs = list(mesh.devices.flat)
    mine = set(mesh.local)
    corpus, starts, lens = flat if flat is not None else (None,) * 3
    shards = []  # (g, corpus_d, starts_d, ends_d, handle or None)
    for d, g in enumerate(partition_blocks(blocks, len(devs))):
        if flat is not None:
            gi = np.asarray(g, dtype=np.int64)
            lo = int(starts[g[0]]) if len(g) else 0
            hi = int(starts[g[-1]] + lens[g[-1]]) if len(g) else 0
            corpus_d, starts_d, lens_d = corpus[lo:hi], starts[gi] - lo, \
                lens[gi]
        elif d in mine and g:
            corpus_d, starts_d, lens_d = flatten_blocks(
                [blocks[i] for i in g])
        else:
            shards.append((g, None, None, None, None))
            continue
        h = None
        if d in mine and len(corpus_d):
            with _on(devs[d]):
                h = confirm_start(corpus_tensor(corpus_d, devs[d]), lit,
                                  len(corpus_d), capacity)
        shards.append((g, corpus_d, starts_d, starts_d + lens_d, h))
    got = iter(confirm_fetch_many([sh[4] for sh in shards
                                   if sh[4] is not None]))
    out = []
    for (g, corpus_d, starts_d, ends_d, h) in shards:
        fid = pos = np.zeros(0, np.int64)
        if h is not None:
            with _on(h.corpus.device):
                fid, pos = confirm_finish(h, next(got))
        out.append((g, corpus_d, starts_d, ends_d, fid, pos))
    return out


def sharded_literal_confirm(lit, blocks, mesh: Mesh, capacity: int,
                            flat=None):
    """Filter + hash confirm of a block batch sharded across the mesh
    (`_confirm_local`), to every shard's hash-matched pairs.

    On a mesh of several processes every process passes the same global
    block list, scans only its own shards, and the shards' pairs are then
    gathered over the group (`_exchange`), so every process returns every
    shard's (reference: hyperscan_tpu/parallel/sharded.py:426-444) and
    runs the host stages over all of them. The stream path takes this
    form: its chain state crosses shards. A block scan takes
    `sharded_literal_scan`, which exchanges finished matches instead.

    Returns per shard (block_indices, fid_array, flat_pos_array,
    corpus_array, starts, ends): hash-matched pairs, to be exact-verified
    and window-validated by the host stages per shard group.
    """
    from ..ops.teddy import flatten_blocks

    mesh = _as_shard_mesh(mesh)
    if flat is None:
        flat = flatten_blocks(blocks)
    shards = _confirm_local(lit, blocks, mesh, capacity, flat)
    pairs = [(fid, pos) for (*_rest, fid, pos) in shards]
    if mesh.distributed:
        pairs = _exchange([pairs[d] for d in mesh.local], mesh)
    return [(g, fid, pos, corpus_d, starts_d, ends_d)
            for (g, corpus_d, starts_d, ends_d, _f, _p), (fid, pos)
            in zip(shards, pairs)]


def sharded_literal_scan(db, blocks, mesh: Mesh, capacity: int, flat=None):
    """The literal path of a block batch sharded across the mesh, to
    finished match records.

    Each process takes its own shards (`Mesh.local`) through the whole
    literal path: `_confirm_local` flattens (or, given `flat`, slices)
    and uploads only their blocks and confirms them on their devices,
    and the host stages `verify_pairs` and `finish_confirmed` (windows,
    chains) run on each of them with shard-local block indices. No
    process runs a host stage over another's shard. On a mesh of several
    processes the shards' finished records and ranges then cross the
    group (`_exchange`, as two int64 columns a shard) and nothing else
    does, so every process returns every shard's.

    Returns (records, ranges): int64 arrays [n, 4] of (block, expr_index,
    to, from) and [m, 4] of (block, expr_index, lo, hi), a range standing
    for every `to` in [lo, hi] with from 0; blocks are indices into
    `blocks`, and the shards' rows follow one another in mesh order."""
    from ..runtime.lit_runtime import finish_confirmed, verify_pairs

    mesh = _as_shard_mesh(mesh)
    shards = _confirm_local(db.lit, blocks, mesh, capacity, flat)
    local = []
    for d in mesh.local:
        g, corpus_d, starts_d, ends_d, fid, pos = shards[d]
        recs, rng = (), []
        if len(g):
            fid, pos = verify_pairs(db.lit, corpus_d, starts_d, fid, pos)
            recs = finish_confirmed(db, corpus_d, starts_d, ends_d, fid,
                                    pos, ranges_out=rng)
        local.append(_encode_records(g, recs, rng))
    if mesh.distributed:
        local = _exchange(local, mesh)
    rows = np.concatenate([np.concatenate(
        [np.asarray(a, np.int64).reshape(-1, 2),
         np.asarray(b, np.int64).reshape(-1, 2)], 1) for a, b in local])
    is_range = (rows[:, 0] & 1).astype(bool)
    rows[:, 0] >>= 1
    return rows[~is_range], rows[is_range]


def _encode_records(g, recs, rng) -> Tuple[np.ndarray, np.ndarray]:
    """One shard's records (block_local, expr_index, to, from) and ranges
    (block_local, expr_index, lo, hi) as the exchange's pair of
    equal-length int64 arrays: a row (block << 1 | is_range, expr_index,
    to or lo, from or hi) a match, its first two values in the first
    array and its last two in the second, global block indices."""
    rows = np.asarray(list(recs) + list(rng), np.int64).reshape(-1, 4)
    rows[:, 0] = np.asarray(g, np.int64)[rows[:, 0]] << 1
    rows[len(recs):, 0] |= 1
    return rows[:, :2].reshape(-1), rows[:, 2:].reshape(-1)


def _exchange(local, mesh: Mesh):
    """`_gather_pairs` of this process's shards' `local` pairs, as one
    exchange over the group: inside the span `hs.exchange`, counting the
    exchange (`exchanges`) and the bytes of the pairs this process hands
    to it (`exchange_bytes`, 16 a pair as int64)."""
    with span("hs.exchange"):
        count("exchanges")
        count("exchange_bytes", 16 * sum(len(f) for f, _p in local))
        return _gather_pairs(local, mesh)


def _gather_pairs(local, mesh: Mesh):
    """A pair of equal-length int64 arrays for every shard of the mesh,
    in mesh order, from this process's shards' `local` pairs (in
    `mesh.local` order): each process's lengths, then its pairs, gathered
    over the group. The pairs are a shard's (fid, pos) or its encoded
    matches (`_encode_records`)."""
    lens = torch.tensor([len(f) for f, _p in local], dtype=torch.int64)
    vals = torch.from_numpy(np.stack([
        np.concatenate([np.asarray(f, np.int64) for f, _p in local]),
        np.concatenate([np.asarray(p, np.int64) for _f, p in local])], 1))
    flat = mesh.ranks.reshape(-1)
    out = [None] * flat.size
    for r, (n_r, v_r) in enumerate(zip(_gather_processes(lens, mesh),
                                       _gather_processes(vals, mesh))):
        v_r = v_r.cpu().numpy()
        offs = np.concatenate([[0], np.cumsum(n_r.cpu().numpy())])
        for j, d in enumerate(np.flatnonzero(flat == r)):
            out[d] = (v_r[offs[j]:offs[j + 1], 0], v_r[offs[j]:offs[j + 1], 1])
    return out
