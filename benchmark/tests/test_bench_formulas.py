"""The frozen formulas equal the program's, byte for byte."""

import numpy as np
import pytest

from formulas import benchdata as frozen
from hyperscan_tpu_torch.tools import benchdata as program


def test_ruleset_equal():
    assert frozen.patterns(10000) == program.patterns(10000)
    assert frozen.WORDS == program.WORDS
    assert frozen.PLANTS == program.PLANTS
    assert frozen.plant_starts() == program.plant_starts()
    assert np.array_equal(frozen.plant_region(), program.plant_region())


@pytest.mark.parametrize("kind", ["iid", "structured"])
@pytest.mark.parametrize("salt", [0, 1, 7, 4294])
def test_corpus_equal(kind, salt):
    n = (1 << 16) + 37
    assert np.array_equal(frozen.gen_corpus(n, salt, kind),
                          program.gen_corpus(n, salt, kind))


def test_corpus_any_salt():
    """A salt past the original's range wraps instead of overflowing."""
    a = frozen.gen_corpus(8192, 2**31 + 5, "iid")
    b = frozen.gen_corpus(8192, (2**31 + 5) % 2**32, "iid")
    assert np.array_equal(a, b)
    assert len(frozen.gen_corpus(100, 3, "iid")) == 100


@pytest.mark.parametrize("hist,r", [(0, 0), (37, 1), (37, 9), (0, 90)])
def test_stream_extents_equal(hist, r):
    assert np.array_equal(frozen.stream_extents(300, 1460, hist, r),
                          program.stream_extents(300, 1460, hist, r))
    assert frozen.stream_plants(300, 400_000) == \
        program.stream_plants(300, 400_000)


def test_stream_extents_first_flow():
    """Flows numbered from `first` are the original's rows from there."""
    whole = frozen.stream_extents(64, 1460, 0, 3).reshape(64, 1460)
    part = frozen.stream_extents(16, 1460, 0, 3, first=40).reshape(16, 1460)
    assert np.array_equal(whole[40:56], part)
