"""Multi-device scanning: corpus shards data-parallel over a device mesh.

Port of `hyperscan_tpu/parallel/sharded.py`. The reference is
single-controller (`shard_map`: one process drives every device of a
mesh), and so is this module:

- the pattern database (DFA tables, literal tables) is uploaded once to
  every device and cached per device;
- the corpus blocks or segments are split across the mesh's entries, one
  shard each, and each shard's work is launched on its device's current
  stream;
- the collectives are explicit: `psum` sums the per-shard results on the
  mesh's first device and `all_gather` stacks them there. The host reads
  once, at the end.

A `Mesh` holds an array of `torch.device`s of any shape with its axis
names; an entry is one shard, and a mesh built by hand may name one
device more than once (several shards on one card, which exercises the
shard boundaries on one card). `make_mesh(n, device="cpu")` is the
counterpart of the reference tests' virtual 8-device CPU mesh.

The multi-process form (one process per card on `torch.distributed`, the
counterpart of `jax.distributed` in `make_multihost_mesh`) is not ported
yet; see ROADMAP.md.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.dfa import dfa_scan_batch
from ..ops.match import count_matches, extract_matches

SHARD_AXIS = "shards"
LOOKBACK = 8  # bytes before a segment that its first positions read
# (the filter's suffix depth M is at most 8, so at most 7 are needed)


class Mesh:
    """Devices of a mesh: `devices` is a numpy object array of
    `torch.device`s whose number of dimensions equals that of
    `axis_names`."""

    def __init__(self, devices, axis_names: Sequence[str]):
        given = np.asarray(devices, dtype=object)
        devs = np.empty(given.shape, dtype=object)
        for idx in np.ndindex(given.shape):
            devs[idx] = torch.device(given[idx])
        if devs.ndim != len(tuple(axis_names)) or devs.size == 0:
            raise ValueError("a mesh needs one axis name per dimension and "
                             "at least one device")
        self.devices = devs
        self.axis_names = tuple(axis_names)

    @property
    def first(self) -> torch.device:
        """The device that collectives gather on."""
        return self.devices.flat[0]

    def __repr__(self) -> str:
        return (f"Mesh({[str(d) for d in self.devices.flat]}, shape "
                f"{self.devices.shape}, axes {self.axis_names})")


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
    return Mesh(mesh.devices.reshape(-1), (SHARD_AXIS,))


def make_multihost_mesh(coordinator_address: Optional[str] = None,
                        num_processes: Optional[int] = None,
                        process_id: Optional[int] = None) -> Mesh:
    """1-D mesh over every card of the job. Single-process (no
    coordinator, one process): the same as `make_mesh()`. The
    multi-process form, one process per card on `torch.distributed`, is
    not ported yet and raises."""
    if coordinator_address is not None or (num_processes or 1) > 1 or \
            (process_id or 0) > 0:
        raise NotImplementedError(
            "multi-process meshes are not ported yet (ROADMAP.md, queue 1, "
            "item 8: one process per card on torch.distributed)")
    return make_mesh()


def _on(device):
    """Make `device` the current CUDA device while a shard's work is
    launched: a kernel launches on the current device, and a stream of
    another card is refused. A no-op for a CPU device."""
    if torch.device(device).type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def psum(values: Sequence[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """Sum of one tensor per shard, on the mesh's first device."""
    dev = mesh.first
    out = values[0].to(dev)
    for v in values[1:]:
        out = out + v.to(dev)
    return out


def all_gather(values: Sequence[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """One tensor per shard, stacked on the mesh's first device."""
    dev = mesh.first
    return torch.stack([v.to(dev) for v in values])


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:
        a = a.copy()
    return torch.from_numpy(a).to(device)


def global_shard_arrays(mesh: Mesh, data: np.ndarray, lengths: np.ndarray
                        ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Split a [B, L] batch and its [B] lengths into one equal run of
    rows per shard, each uploaded to its shard's device. B must be a
    multiple of the mesh size (`pad_batch_for_mesh`)."""
    devs = list(mesh.devices.flat)
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
    """dfa_scan_batch on every shard: [(accepts, finals, eod table)]."""
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
    """Global match count of one engine over a sharded block batch."""
    mesh = _as_shard_mesh(mesh)
    local = [count_matches(a) for (a, _f, _e) in
             _scan_shards(engine, data, lengths, mesh)]
    return int(psum(local, mesh))


def sharded_scan_matches(engine, data: np.ndarray, lengths: np.ndarray,
                         mesh: Mesh, capacity: int = 4096):
    """Match tuples of one engine over a sharded block batch.

    Returns tensors on the mesh's first device: (total_per_shard [n],
    set_ids [n, cap], blocks [n, cap] local row index, tos [n, cap],
    eod_sets [n, rows/shard]). Callers translate local rows to global
    rows with shard * rows_per_shard + row."""
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
    corpus, whatever the segmentation."""
    from ..ops.teddy import mask_tables
    from ..ops.teddy_words import filter_words_count

    mesh = _as_shard_mesh(mesh)
    devs = list(mesh.devices.flat)
    n = int(corpus.shape[0])
    local, tabs = [], {}
    for dev, (lo, hi) in zip(devs, segments(n, len(devs))):
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
    if not local:
        return 0
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


def sharded_literal_confirm(lit, blocks, mesh: Mesh, capacity: int,
                            flat=None):
    """Filter + hash confirm of a block batch sharded across the mesh.

    Blocks partition contiguously across the shards (`partition_blocks`);
    each shard's bytes are uploaded to its device and scanned there by
    the literal path's own dispatcher (`ops.teddy_families`), so a shard
    runs the family that the unsharded scan would run and learns the same
    capacities. Every shard's meta and pairs are gathered on the first
    live shard's device and read in one copy; a shard whose outputs
    overflowed is dispatched again on its device. `flat` is
    `ops.teddy.flatten_blocks(blocks)`, when the caller has it already.

    Returns per shard (block_indices, fid_array, flat_pos_array,
    corpus_array, starts, ends): hash-matched pairs, to be exact-verified
    and window-validated by the host stages per shard group.
    """
    from ..ops.teddy import corpus_tensor, flatten_blocks
    from ..ops.teddy_families import (confirm_fetch_many, confirm_finish,
                                      confirm_start)

    mesh = _as_shard_mesh(mesh)
    devs = list(mesh.devices.flat)
    corpus, starts, lens = flat if flat is not None else \
        flatten_blocks(blocks)
    shards = []  # (g, corpus_d, starts_d, ends_d, handle or None)
    for g, dev in zip(partition_blocks(blocks, len(devs)), devs):
        gi = np.asarray(g, dtype=np.int64)
        lo = int(starts[g[0]]) if len(g) else 0
        hi = int(starts[g[-1]] + lens[g[-1]]) if len(g) else 0
        corpus_d = corpus[lo:hi]
        starts_d = starts[gi] - lo
        h = None
        if hi > lo:
            with _on(dev):
                h = confirm_start(corpus_tensor(corpus_d, dev), lit, hi - lo,
                                  capacity)
        shards.append((g, corpus_d, starts_d, starts_d + lens[gi], h))
    live = [sh[4] for sh in shards if sh[4] is not None]
    got = iter(confirm_fetch_many(live))
    out = []
    for (g, corpus_d, starts_d, ends_d, h) in shards:
        fid = pos = np.zeros(0, np.int64)
        if h is not None:
            with _on(h.corpus.device):
                fid, pos = confirm_finish(h, next(got))
        out.append((g, fid, pos, corpus_d, starts_d, ends_d))
    return out
