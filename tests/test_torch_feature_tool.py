"""hyperscan_tpu_torch/tools/features.py (chip_smoke.py's phase 7) on
the CPU at a small size: every feature database through run_feature with
the device branch forced (host_scan_limit 0, the kernels' plain
versions), every block's matches exactly those of its plants, its
prefix, round trip and StreamSet held to the port's host route; and each feature database's scan of a planted
block equal to the JAX package's (its host route)."""

import numpy as np
import pytest

import hyperscan_tpu as hs
import torch_ref_native  # noqa: F401 (the reference's native build, locked)
from hyperscan_tpu.database import compile_patterns as ref_compile
from hyperscan_tpu.grey import Grey as RefGrey
from hyperscan_tpu_torch.tools import features as FT
from torch_parity import DEVICE, Uploads

N = 2 << 20
BLOCK = 1 << 20


@pytest.fixture(scope="module")
def base():
    return FT.base_corpus(N, 13)


@pytest.mark.parametrize("name", list(FT.FEATURES))
def test_feature_on_device_branch(name, base):
    with Uploads() as up:
        r = FT.run_feature(name, base, device="cpu", block=BLOCK,
                           prefix=BLOCK // 2, spacing=8192, streams=16,
                           write=4096, rounds=3, check_streams=16,
                           host_scan_limit=0)
    assert up.n > 0
    assert r["plants"] >= N // 8192 - 4 and r["matches"] >= r["plants"]
    if FT.FEATURES[name].stream:
        assert r["stream_matches"] == r["stream_host_matches"] > 0
    # the same database in the JAX package scans a planted block alike
    f = FT.FEATURES[name]
    block = FT.planted(base, f.plant, FT.plant_offsets(N, 8192))[:BLOCK]
    ref = ref_compile(list(f.pats), list(f.flags), list(f.ids),
                      ext=f.ext and [hs.ExprExt(**e) for e in f.ext],
                      grey=RefGrey(host_scan_limit=1 << 62))
    port = FT.compile_feature(name, host_scan_limit=0)
    data = block.tobytes()
    if f.kind == "ranges":
        ms, rg = hs.scan_block_ranges(ref, data)
        assert DEVICE.scan_block_ranges(port, data) == (
            [tuple(m) for m in ms], [tuple(r) for r in rg])
    else:
        assert DEVICE.scan(port, data) == [tuple(m)
                                           for m in hs.scan(ref, data)]


def test_plants_and_offsets():
    offs = FT.plant_offsets(N, 8192)
    assert np.all(np.diff(offs) > 4096) and offs[-1] + 4096 < N
    c = FT.planted(FT.base_corpus(1 << 16, 1), b"  abc  ",
                   FT.plant_offsets(1 << 16, 8192))
    assert c.tobytes().count(b"  abc  ") == FT.plant_offsets(
        1 << 16, 8192).size
    assert not set(c.tobytes()) - set(FT.ALPHABET) - set(b"abc")
