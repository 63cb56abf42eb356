"""The one traffic generator: the same seed gives the same bytes, every
seed the same sizes and work; the rule plants give each block and flow
matches of its own, of every shape, across the whole block and across
write boundaries."""

import collections

import numpy as np
import pytest

from formulas import benchdata as BD
from harness import spec
from harness import traffic as T
from reference import snort_rules as R

SEEDS = (1, 2**31 + 11)
N = {"formula": "bench", "patterns": 300, "flags": 0}  # plants' ids < 300
RULES = spec.ruleset(N)
SHAPES = RULES.shapes(N)
HISTORY = 37  # bytes of history a flow keeps in the 10k stream database


def _small(name):
    mix = spec.traffic(name)
    if mix["kind"] == "blocks":
        mix["blocks_per_chip"] = min(mix["blocks_per_chip"], 512)
        mix["sizes"] = [[min(s, 1 << 14), w] for s, w in mix["sizes"]]
        mix["pool"] = 2
    else:
        mix["flows"] = 256
    return mix


def _shapes(matches):
    return {i % SHAPES for i, _f, _to in matches}


def test_size_multiset():
    s = T.size_multiset([[40, 7], [576, 4], [1500, 1]], 4096)
    assert collections.Counter(s.tolist()) == {40: 2390, 576: 1365,
                                               1500: 341}


@pytest.mark.parametrize("shape", range(SHAPES))
def test_rule_plant(shape):
    """A plant is a match, ending at its end, of a rule of its shape."""
    rng = np.random.default_rng(shape)
    for _ in range(200):
        p = RULES.plant(rng, N, shape, {"gate_pairs": (0, 48)})
        ends = {(i % SHAPES, to) for i, _f, to in R.block_matches(p, N)}
        assert (shape, len(p)) in ends


def test_blocks_by_seed():
    mix = _small("imix4k")
    a, b = (T.make(mix, s, N) for s in SEEDS)
    assert a.pool == T.make(mix, SEEDS[0], N).pool
    assert a.pool != b.pool
    for t in (a, b):
        for batch in t.pool:
            assert len(batch) == mix["blocks_per_chip"]
            assert sorted(map(len, batch)) == sorted(map(len, a.pool[0]))
    x4 = T.make(mix, SEEDS[0], N, chips=4)
    assert len(x4.pool[0]) == 4 * mix["blocks_per_chip"]


def test_packet_plants():
    """One packet in each run of plant_every carries a match."""
    mix = _small("imix4k")
    t = T.make(mix, 5, N)
    every = mix["plant_every"]
    for batch in t.pool:
        for lo in range(0, len(batch), every):
            assert any(R.block_matches(p, N) for p in batch[lo:lo + every])


def test_rule_blocks():
    """Every block has matches of its own: past its first 4 KiB, one
    ending at its last byte, of all six shapes where it holds six plants
    or more; the counts differ, and a batch holds every shape."""
    mix = _small("bulk1m")
    most = max(c for c, _w in mix["plants"]["per_block"])
    assert most >= SHAPES
    t = T.make(mix, 9, N)
    for batch in t.pool:
        answers = [R.block_matches(blk, N) for blk in batch]
        full = 0
        for blk, ms in zip(batch, answers):
            assert any(to > 4096 for _i, _f, to in ms)
            assert len(blk) in {to for _i, _f, to in ms}
            full += _shapes(ms) == set(range(SHAPES))
        assert full >= len(batch) // 4
        assert len({repr(ms) for ms in answers}) == len(batch)
        assert len({len(ms) for ms in answers}) > 1


def test_flows_by_seed():
    mix = _small("flows16k-mss")
    a = T.make(mix, SEEDS[1], N)
    assert a.pool == T.make(mix, SEEDS[1], N).pool
    assert a.pool != T.make(mix, SEEDS[0], N).pool
    assert len(a.pool) == mix["pool_rounds"]
    w = mix["write"]
    assert all(len(c) == w for rnd in a.pool for c in rnd)
    assert a.round(2 + mix["pool_rounds"]) == a.round(2)
    assert len(a.planted) == mix["flows"] // mix["plants"]["flows_every"]
    ext = BD.stream_extents(mix["flows"], w, 0, 2, a.first).reshape(-1, w)
    for k in range(mix["flows"]):
        if k not in set(a.planted.tolist()):
            assert a.pool[2][k] == ext[k].tobytes()
    k = 7
    assert a.stream(k, 3) == b"".join(a.pool[r][k] for r in range(3))


def test_flow_plants():
    """In every planted flow each shape has a match that only a scan
    across the write boundary finds, and in some a gate chain has more
    than the history's bytes before its boundary."""
    mix = _small("flows16k-mss")
    t = T.make(mix, 3, N)
    w = t.write
    rounds = len(t.pool)
    beyond_history = 0
    for k in t.planted[:24]:
        data = t.stream(int(k), rounds)
        want, close = R.stream_matches(data, N, w)
        assert close == []
        alone_by_round, _ = R.write_alone(data, N, w)
        crossing = set()
        for r, ms in want.items():
            alone = set(alone_by_round.get(r, []))
            crossing |= _shapes(set(ms) - alone)
            lo = max(0, r * w - HISTORY)
            seen = {(i, f, lo + to) for i, f, to in
                    R.block_matches(data[lo:(r + 1) * w], N)}
            beyond_history += len(_shapes(set(ms) - seen) & {5})
        assert crossing == set(range(SHAPES))
    assert beyond_history > 0
