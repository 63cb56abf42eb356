"""The traffic and the database cache's key of the benchmark's cells stay
byte for byte what they were when the bench ruleset's code lived in the
harness: the digests below were read from that generator, at the CPU cut
of `cpu_cell.py`, and the keys over an empty port (the ruleset, ids,
flags and mode alone)."""

import hashlib

import pytest

from harness import dbcache, spec
from harness import traffic as T

import cpu_cell

POOLS = {
    ("snort10k_block.bulk1m", 3):
        "6a1476e0a33d1202f01feb938a48274f550145319fd573773ffd48a183173998",
    ("snort10k_block.bulk1m", 2**31 + 7):
        "f56d020641642761bef785fc2eabb6bfc132eb7be9f9303597502d0e3e98be6b",
    ("snort10k_stream.flows16k-mss", 3):
        "dca368d6a3921d1057e46952504cf1c775b1da5e75b2dfcba3f00f210242f04a",
    ("snort10k_stream.flows16k-mss", 2**31 + 7):
        "aed5c9e4422677c0542846467b52c137ddb6fa1ad197e2782b6d44c5d6e8afd2",
    ("snort10k_block.imix4k", 3):
        "fd9a16a5674d07f0730238173b2250e4f4a606cfb12aac307bc28e2d0dccf5ba",
    ("snort10k_block.imix4k", 2**31 + 7):
        "805773c3fe21e03dded74d27cb0d161265d150ef147acd4814e10bf19f06b5df",
    ("snort10k_block_x4.bulk1m", 3):
        "8c394fc313668e4236896458147956a8bab13b264ce461642773004ea592a481",
    ("snort10k_block_x4.bulk1m", 2**31 + 7):
        "46188ebb27dbbbb87b2b9aaa594005adecfc7e0d6ceda5820d4e8bae08bd3e32",
}
KEYS = {"snort10k_block": "f6e908a4e2f9c008c7dd4366",
        "snort10k_stream": "e2cc16120e31044aaffcbf4e",
        "snort10k_block_x4": "f6e908a4e2f9c008c7dd4366"}


def _digest(t) -> str:
    """sha256 of every batch (or round) of the pool, each part with its
    length, and of a flows pool's first flow and planted flows."""
    h = hashlib.sha256()
    for batch in t.pool:
        h.update(len(batch).to_bytes(8, "little"))
        for b in batch:
            h.update(len(b).to_bytes(8, "little"))
            h.update(b)
    if isinstance(t, T.Flows):
        h.update(int(t.first).to_bytes(8, "little"))
        h.update(t.planted.astype("<i8").tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("cell,seed", sorted(POOLS),
                         ids=lambda x: str(x))
def test_traffic_unchanged(cell, seed):
    w = cpu_cell.cell(cell)
    mix = cpu_cell.small_traffic(spec.traffic(w["traffic"]))
    rs = dict(spec.config(w["config"])["ruleset"],
              patterns=cpu_cell.PATTERNS)
    assert _digest(T.make(mix, seed, rs, w["chips"])) == POOLS[(cell, seed)]


@pytest.mark.parametrize("name", sorted(KEYS))
def test_cache_key_unchanged(name, tmp_path):
    """The cached databases stay valid: the key's ruleset part is the
    same bytes."""
    assert dbcache.key(spec.config(name), tmp_path) == KEYS[name]
