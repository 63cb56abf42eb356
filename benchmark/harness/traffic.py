"""The one traffic generator. A mix is a data file (`traffic/<name>.json`)
whose `kind` says which of two shapes it has; every byte comes from the
run's seed through the frozen formulas of `formulas/benchdata.py` and the
rule plants below, and every seed gives the same sizes and the same
number of plants, in another order and with other bytes. The traffic is
synthetic: hashed printable noise with matches of the ruleset planted in
it, not bytes taken from a public corpus.

A rule plant is a string that matches one rule of the ruleset, of a given
shape (`patterns` in the formulas: six shapes by id % 6), its id and free
parts (digits, verb, path letters, hex, extension, the number of `ab`/`cd`
pairs of a gate chain) drawn from the seed.

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
  of each of the six shapes laid across a write boundary (a seeded
  choice of the pool's boundaries, one each, cut at a seeded point), and
  `plants["inside"]` more plants of seeded shapes inside writes of their
  own. `in_flight` rounds stay started while the oldest is finished.

`plants["gate_pairs"]` ([lo, hi]) bounds a gate chain's pairs. `check`
gives the size of the sample that the reference checks after the window
(see loops.py).
"""

from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor
from typing import List

import numpy as np

from formulas import benchdata as BD

GEN_THREADS = 4  # threads that make a pool of blocks during set-up
SHAPES = 6  # the ruleset's shapes, by id % 6
VERBS = ("GET", "POST", "PUT")
EXTS = ("exe", "dll", "bat")
LOWER = "abcdefghijklmnopqrstuvwxyz"
HEX = "0123456789abcdef"
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


def _pick(rng, chars: str, n: int) -> str:
    return "".join(chars[j] for j in rng.integers(0, len(chars), n))


def rule_plant(rng, n_patterns: int, shape: int, gate_pairs) -> bytes:
    """A string that matches a rule of `shape` among the first
    `n_patterns`, the rule and the free parts drawn from `rng`."""
    i = shape + SHAPES * int(rng.integers(0, (n_patterns - 1 - shape)
                                          // SHAPES + 1))
    w = BD.WORDS[i % len(BD.WORDS)]
    if shape == 0:
        s = f"{w}{i}"
    elif shape == 1:
        s = f"{w}{i}{_pick(rng, '0123456789', int(rng.integers(2, 5)))}z"
    elif shape == 2:
        s = (f"x{i}{VERBS[int(rng.integers(0, 3))]} /"
             f"{_pick(rng, LOWER, int(rng.integers(1, 21)))}")
    elif shape == 3:
        s = f"q{i}h{_pick(rng, HEX, 8)}"
    elif shape == 4:
        s = f"v{i}.{EXTS[int(rng.integers(0, 3))]}"
    else:
        pairs = int(rng.integers(gate_pairs[0], gate_pairs[1] + 1))
        chain = "".join(("ab", "cd")[j] for j in rng.integers(0, 2, pairs))
        s = f"gate{i}x{chain}{w}{i}end"
    return s.encode()


def _put(arr: np.ndarray, at: int, plant: bytes) -> None:
    arr[at:at + len(plant)] = np.frombuffer(plant, np.uint8)


def _lay_block(arr: np.ndarray, count: int, rng, n_patterns: int,
               gate_pairs) -> None:
    """`count` rule plants in `arr`, one in each of `count` equal slots,
    the last ending at the end."""
    slot = len(arr) // count
    s0 = int(rng.integers(0, SHAPES))
    for j in range(count):
        p = rule_plant(rng, n_patterns, (s0 + j) % SHAPES, gate_pairs)
        if j == count - 1:
            at = len(arr) - len(p)
        else:
            at = j * slot + int(rng.integers(0, slot - len(p) + 1))
        _put(arr, at, p)


def _rules_batch(rng, sizes: np.ndarray, corpus: str, plants: dict,
                 n_patterns: int) -> List[bytes]:
    order = rng.permutation(sizes)
    salts = rng.integers(0, 1 << 31, size=len(order))
    counts = rng.permutation(size_multiset(plants["per_block"], len(order)))
    # numpy releases the interpreter lock in the formula's array passes
    with ThreadPoolExecutor(max_workers=GEN_THREADS) as ex:
        arrs = list(ex.map(
            lambda a: BD.gen_corpus(int(a[0]), int(a[1]), corpus),
            zip(order, salts)))
    for arr, c in zip(arrs, counts):
        _lay_block(arr, int(c), rng, n_patterns, plants["gate_pairs"])
    return [a.tobytes() for a in arrs]


def _packet_batch(rng, sizes: np.ndarray, corpus: str, every: int,
                  plants: dict, n_patterns: int) -> List[bytes]:
    order = rng.permutation(sizes)
    flat = BD.gen_corpus(int(order.sum()), int(rng.integers(0, 1 << 31)),
                         corpus)
    ends = np.cumsum(order)
    starts = ends - order
    for g, lo in enumerate(range(0, len(order), every)):
        plant = rule_plant(rng, n_patterns, g % SHAPES,
                           plants["gate_pairs"])
        fits = [j for j in range(lo, min(lo + every, len(order)))
                if order[j] >= len(plant)]
        if not fits:
            continue
        j = fits[int(rng.integers(0, len(fits)))]
        _put(flat, int(starts[j])
             + int(rng.integers(0, order[j] - len(plant) + 1)), plant)
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


def _lay_flow(stream: np.ndarray, w: int, rng, n_patterns: int,
              plants: dict) -> None:
    """A flow's plants in its pool's bytes, `stream` (rounds of `w`
    bytes): one of each shape across a write boundary of its own, cut at
    a seeded point, and `inside` more inside writes of their own, clear
    of the boundaries by MARGIN bytes."""
    rounds = len(stream) // w
    cuts = rng.choice(np.arange(1, rounds), SHAPES, replace=False)
    for shape, b in zip(rng.permutation(SHAPES), cuts):
        p = rule_plant(rng, n_patterns, int(shape), plants["gate_pairs"])
        if len(p) > MARGIN:
            raise ValueError("a plant longer than MARGIN")
        _put(stream, int(b) * w - int(rng.integers(1, len(p))), p)
    for r in rng.choice(rounds, plants["inside"], replace=False):
        p = rule_plant(rng, n_patterns, int(rng.integers(0, SHAPES)),
                       plants["gate_pairs"])
        lo = int(r) * w + MARGIN
        _put(stream, lo + int(rng.integers(0, w - 2 * MARGIN - len(p) + 1)),
             p)


def make(mix: dict, seed: int, n_patterns: int, chips: int = 1):
    """The traffic of `mix` for `seed`, for a cell on `chips` cards whose
    ruleset is the first `n_patterns` rules."""
    rng = rng_for(seed, "traffic")
    if mix["kind"] == "blocks":
        sizes = size_multiset(mix["sizes"], mix["blocks_per_chip"] * chips)
        if mix["plant"] == "rules":
            pool = [_rules_batch(rng, sizes, mix["corpus"], mix["plants"],
                                 n_patterns)
                    for _ in range(mix["pool"])]
        elif mix["plant"] == "packets":
            pool = [_packet_batch(rng, sizes, mix["corpus"],
                                  mix["plant_every"], mix["plants"],
                                  n_patterns)
                    for _ in range(mix["pool"])]
        else:
            raise ValueError(f"unknown plant {mix['plant']!r}")
        return Blocks(pool, mix["check"])
    if mix["kind"] == "flows":
        n, w, rounds = mix["flows"], mix["write"], mix["pool_rounds"]
        plants = mix["plants"]
        if rounds - 1 < SHAPES or plants["inside"] > rounds:
            raise ValueError("too few rounds in the pool for the plants")
        first = int(rng.integers(0, 1 << 31))
        # ext[k, r]: flow k's write in round r, so ext[k] is its stream
        ext = np.stack([BD.stream_extents(n, w, 0, r, first).reshape(n, w)
                        for r in range(rounds)], axis=1)
        every = plants["flows_every"]
        planted = np.arange(int(rng.integers(0, every)), n, every)
        for k in planted:
            _lay_flow(ext[k].reshape(-1), w, rng, n_patterns, plants)
        pool = [[ext[k, r].tobytes() for k in range(n)]
                for r in range(rounds)]
        return Flows(pool, first, w, mix["in_flight"], mix["check"],
                     planted)
    raise ValueError(f"unknown traffic kind {mix['kind']!r}")
