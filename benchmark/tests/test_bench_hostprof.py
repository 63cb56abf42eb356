"""Host seconds by layer on a toy profile: a builtin's own time goes to
its callers' layers in proportion to its time under each."""

import pytest

from harness import hostprof, spec

PORT = str(spec.PORT)
TEDDY = (PORT + "/ops/teddy.py", 69, "flatten_blocks")
VERIFY = (PORT + "/runtime/lit_runtime.py", 10, "verify_pairs")
SCAN = (PORT + "/runtime/scan.py", 1009, "scan_batch")
CONCAT = ("~", 0, "<built-in method numpy.concatenate>")
NPPY = ("/usr/lib/python3/site-packages/numpy/_core/fromnumeric.py", 5,
        "sort")
LOOP = ("/x/benchmark/harness/loops.py", 1, "step")
CLOCK = ("~", 0, "<built-in method time.perf_counter>")


class Stats:
    def __init__(self, stats):
        self.stats = stats


def test_builtin_split_by_callers():
    # func: (cc, nc, tt, ct, {caller: (cc, nc, tt, ct)})
    st = Stats({
        SCAN: (1, 1, 0.5, 9.0, {LOOP: (1, 1, 0.5, 9.0)}),
        TEDDY: (1, 1, 1.0, 4.0, {SCAN: (1, 1, 1.0, 4.0)}),
        VERIFY: (1, 1, 2.0, 4.5, {SCAN: (1, 1, 2.0, 4.5)}),
        # 3 s of concatenate: 2 under flatten_blocks, 1 under a numpy
        # function that verify_pairs called
        CONCAT: (2, 2, 3.0, 3.0, {TEDDY: (1, 1, 2.0, 2.0),
                                  NPPY: (1, 1, 1.0, 1.0)}),
        NPPY: (1, 1, 1.5, 2.5, {VERIFY: (1, 1, 1.5, 2.5)}),
        LOOP: (1, 1, 0.25, 9.5, {}),
        CLOCK: (1, 1, 0.125, 0.125, {LOOP: (1, 1, 0.125, 0.125)}),
    })
    got = hostprof.layer_seconds(st, spec.Layers())
    assert got["assembly"] == pytest.approx(1.0 + 2.0)
    assert got["literal"] == pytest.approx(2.0 + 1.0 + 1.5)
    assert got["api"] == pytest.approx(0.5)
    assert got["other"] == pytest.approx(0.25 + 0.125)
    assert sum(got.values()) == pytest.approx(
        sum(v[2] for v in st.stats.values()))
