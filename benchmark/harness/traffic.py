"""The one traffic generator. A mix is a data file (`traffic/<name>.json`)
whose `kind` says which of two shapes it has; every byte comes from the
run's seed through the frozen formulas of `formulas/benchdata.py` and the
rule plants below, and every seed gives the same sizes and the same
number of plants, in another order and with other bytes. The traffic is
synthetic: hashed printable noise with matches of the ruleset planted in
it, not bytes taken from a public corpus.

A rule plant is a string that matches one rule of the ruleset, of a given
shape, its free parts drawn from the seed: the configuration's ruleset
module (`rulesets/<formula>.py`, see spec.py) says how many shapes there
are and makes each plant, from the mix's `plants`.

- "blocks": calls of `scan_batch`, each over `blocks_per_chip` x chips
  blocks whose sizes are drawn without replacement from the multiset that
  `sizes` ([size, weight] pairs) spreads over the batch. A pool of `pool`
  distinct batches is made and the calls cycle through it. `plant`
  "rules": each block is its own `gen_corpus` of its size, kind `corpus`,
  with one salt a block, and holds its own number of rule plants, drawn
  without replacement from the multiset that `plants["per_block"]`
  spreads over the batch: one plant in each of that many equal slots of
  the block, at a seeded offset in its slot, the last ending at the
  block's end, the shapes in turn from a seeded first one. `plant`
  "packets": the batch's payloads are cut one after another from one
  `gen_corpus` of the batch's bytes, and in each run of `plant_every`
  packets one packet that can hold it gets a rule plant (the shapes in
  turn) at a seeded offset.
- "flows": write rounds of a StreamSet of `flows` flows, each writing
  `write` bytes a round by the stream formula (`stream_extents`, flows
  numbered from a seeded first one). A pool of `pool_rounds` rounds (the
  formula's rounds 0 .. pool_rounds - 1) is made and the rounds cycle
  through it, so flow k's stream is its bytes of those rounds repeated.
  Every `plants["flows_every"]`-th flow from a seeded first one gets a plant
  of each shape laid across a write boundary (a seeded choice of the
  pool's boundaries, one each, cut at a seeded point), and
  `plants["inside"]` more plants of seeded shapes inside writes of their
  own. `in_flight` rounds stay started while the oldest is finished.

`check` gives the size of the sample that the reference checks after the
window (see loops.py).
"""

from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor
from typing import List

import numpy as np

from formulas import benchdata as BD

from . import spec

GEN_THREADS = 4  # threads that make a pool of blocks during set-up
MARGIN = 128  # bytes kept free of inside plants at each write boundary


def rng_for(seed: int, stream: str) -> np.random.Generator:
    """A generator of its own for each use of the seed."""
    tag = int.from_bytes(stream.encode(), "little") % (1 << 63)
    return np.random.default_rng([seed % (1 << 64), tag])


def size_multiset(sizes, n: int) -> np.ndarray:
    """n sizes in the proportions of `sizes` ([size, weight] pairs),
    rounded by the largest remainder, in the order of `sizes`."""
    vals = np.asarray([s for s, _ in sizes], dtype=np.int64)
    w = np.asarray([wt for _, wt in sizes], dtype=np.float64)
    exact = w / w.sum() * n
    counts = np.floor(exact).astype(np.int64)
    short = n - int(counts.sum())
    counts[np.argsort(-(exact - counts), kind="stable")[:short]] += 1
    return np.repeat(vals, counts)


def _put(arr: np.ndarray, at: int, plant: bytes) -> None:
    arr[at:at + len(plant)] = np.frombuffer(plant, np.uint8)


def _lay_block(arr: np.ndarray, count: int, rng, plant,
               shapes: int) -> None:
    """`count` rule plants in `arr`, one in each of `count` equal slots,
    the last ending at the end."""
    slot = len(arr) // count
    s0 = int(rng.integers(0, shapes))
    for j in range(count):
        p = plant(rng, (s0 + j) % shapes)
        if j == count - 1:
            at = len(arr) - len(p)
        else:
            at = j * slot + int(rng.integers(0, slot - len(p) + 1))
        _put(arr, at, p)


def _rules_batch(rng, sizes: np.ndarray, corpus: str, per_block,
                 plant, shapes: int) -> List[bytes]:
    order = rng.permutation(sizes)
    salts = rng.integers(0, 1 << 31, size=len(order))
    counts = rng.permutation(size_multiset(per_block, len(order)))
    # numpy releases the interpreter lock in the formula's array passes
    with ThreadPoolExecutor(max_workers=GEN_THREADS) as ex:
        arrs = list(ex.map(
            lambda a: BD.gen_corpus(int(a[0]), int(a[1]), corpus),
            zip(order, salts)))
    for arr, c in zip(arrs, counts):
        _lay_block(arr, int(c), rng, plant, shapes)
    return [a.tobytes() for a in arrs]


def _packet_batch(rng, sizes: np.ndarray, corpus: str, every: int,
                  plant, shapes: int) -> List[bytes]:
    order = rng.permutation(sizes)
    flat = BD.gen_corpus(int(order.sum()), int(rng.integers(0, 1 << 31)),
                         corpus)
    ends = np.cumsum(order)
    starts = ends - order
    for g, lo in enumerate(range(0, len(order), every)):
        p = plant(rng, g % shapes)
        fits = [j for j in range(lo, min(lo + every, len(order)))
                if order[j] >= len(p)]
        if not fits:
            continue
        j = fits[int(rng.integers(0, len(fits)))]
        _put(flat, int(starts[j])
             + int(rng.integers(0, order[j] - len(p) + 1)), p)
    return [flat[s:e].tobytes() for s, e in zip(starts, ends)]


@dataclasses.dataclass
class Blocks:
    pool: List[List[bytes]]  # the distinct batches
    check: dict

    def __post_init__(self):
        self.batch_bytes = [sum(map(len, b)) for b in self.pool]


@dataclasses.dataclass
class Flows:
    pool: List[List[bytes]]  # pool[r][k]: flow k's write in round r
    first: int  # the formula's number of flow 0
    write: int
    in_flight: int
    check: dict
    planted: np.ndarray  # the flows that hold rule plants, ascending

    @property
    def flows(self) -> int:
        return len(self.pool[0])

    def round(self, r: int) -> List[bytes]:
        return self.pool[r % len(self.pool)]

    def stream(self, k: int, rounds: int) -> bytes:
        """Flow k's bytes over its first `rounds` rounds."""
        return b"".join(self.pool[r % len(self.pool)][k]
                        for r in range(rounds))


def _lay_flow(stream: np.ndarray, w: int, rng, plant, shapes: int,
              inside: int) -> None:
    """A flow's plants in its pool's bytes, `stream` (rounds of `w`
    bytes): one of each shape across a write boundary of its own, cut at
    a seeded point, and `inside` more inside writes of their own, clear
    of the boundaries by MARGIN bytes."""
    rounds = len(stream) // w
    cuts = rng.choice(np.arange(1, rounds), shapes, replace=False)
    for shape, b in zip(rng.permutation(shapes), cuts):
        p = plant(rng, int(shape))
        if len(p) > MARGIN:
            raise ValueError("a plant longer than MARGIN")
        _put(stream, int(b) * w - int(rng.integers(1, len(p))), p)
    for r in rng.choice(rounds, inside, replace=False):
        p = plant(rng, int(rng.integers(0, shapes)))
        lo = int(r) * w + MARGIN
        _put(stream, lo + int(rng.integers(0, w - 2 * MARGIN - len(p) + 1)),
             p)


def make(mix: dict, seed: int, rs: dict, chips: int = 1):
    """The traffic of `mix` for `seed`, for a cell on `chips` cards whose
    configuration's ruleset is `rs`."""
    rng = rng_for(seed, "traffic")
    mod, plants = spec.ruleset(rs), mix["plants"]
    shapes = mod.shapes(rs)

    def plant(rng, shape: int) -> bytes:
        return mod.plant(rng, rs, shape, plants)

    if mix["kind"] == "blocks":
        sizes = size_multiset(mix["sizes"], mix["blocks_per_chip"] * chips)
        if mix["plant"] == "rules":
            pool = [_rules_batch(rng, sizes, mix["corpus"],
                                 plants["per_block"], plant, shapes)
                    for _ in range(mix["pool"])]
        elif mix["plant"] == "packets":
            pool = [_packet_batch(rng, sizes, mix["corpus"],
                                  mix["plant_every"], plant, shapes)
                    for _ in range(mix["pool"])]
        else:
            raise ValueError(f"unknown plant {mix['plant']!r}")
        return Blocks(pool, mix["check"])
    if mix["kind"] == "flows":
        n, w, rounds = mix["flows"], mix["write"], mix["pool_rounds"]
        if rounds - 1 < shapes or plants["inside"] > rounds:
            raise ValueError("too few rounds in the pool for the plants")
        first = int(rng.integers(0, 1 << 31))
        # ext[k, r]: flow k's write in round r, so ext[k] is its stream
        ext = np.stack([BD.stream_extents(n, w, 0, r, first).reshape(n, w)
                        for r in range(rounds)], axis=1)
        every = plants["flows_every"]
        planted = np.arange(int(rng.integers(0, every)), n, every)
        for k in planted:
            _lay_flow(ext[k].reshape(-1), w, rng, plant, shapes,
                      plants["inside"])
        pool = [[ext[k, r].tobytes() for k in range(n)]
                for r in range(rounds)]
        return Flows(pool, first, w, mix["in_flight"], mix["check"],
                     planted)
    raise ValueError(f"unknown traffic kind {mix['kind']!r}")
