"""The plain reference against the known plants, and against the program
on data dense with near-matches of every shape (CPU, small ruleset)."""

import numpy as np

from formulas import benchdata as BD
from reference import snort_rules as R


def _rs(n: int) -> dict:
    return {"formula": "bench", "patterns": n, "flags": 0}


def test_no_program_in_reference():
    import reference.snort_rules as mod

    src = open(mod.__file__).read()
    assert "hyperscan_tpu" not in src and "import torch" not in src


def test_block_plants():
    """A block of the formula holds exactly the plants' matches: four
    each of attack0 (0), v4.exe (4), gate5...end (5), gate11...end (11);
    the other plants spell no rule of the ruleset."""
    block = BD.gen_corpus(1 << 16, 3, "structured").tobytes()
    got = R.block_matches(block, _rs(10000))
    want = []
    for off, p in BD.plant_starts():
        pid = {b"attack0 ": 0, b"v4.exe ": 4,
               b"gate5xabcdabunion5end ": 5,
               b"gate11xlogin11end ": 11}.get(p)
        if pid is not None:
            want.append((pid, 0, off + len(p.rstrip(b" ")) ))
    assert sorted(got) == sorted(want)


def test_stream_plants():
    """Pattern 0's matches in flows of the stream formula are exactly the
    formula's plants, wherever they fall against the writes."""
    n, w, rounds = 40, 1460, 100
    ext = [BD.stream_extents(n, w, 0, r).reshape(n, w) for r in range(rounds)]
    plants = BD.stream_plants(n, rounds * w)
    for k in range(n):
        data = b"".join(e[k].tobytes() for e in ext)
        by_round, close = R.stream_matches(data, _rs(10000), w)
        assert close == []
        ends = {m[2] for ms in by_round.values() for m in ms
                if m[0] == 0}
        assert ends == {t for (s, t) in plants if s == k}
        for r, ms in by_round.items():
            assert all(r * w < m[2] <= (r + 1) * w for m in ms)


def _dense(n: int, rng) -> bytes:
    parts = []
    for _ in range(2500):
        i = int(rng.integers(0, n))
        w = BD.WORDS[i % 14]
        tail = rng.choice([b"", b"12z", b"1234z", b"123456z", b"0",
                           b"GET /abcdefghijklmnopqrstuvwxyz", b"PUT /a ",
                           b"hdeadbeef0", b"h1234567", b".exe", b".dl",
                           b"xabcd" + (w + str(i) + "end").encode(),
                           b"x" + (w + str(i) + "endab" + w + str(i)
                                   + "end").encode()])
        parts += [rng.choice([b"", b"z", b" "]), R._head_of(i),
                  str(i).encode(), tail]
    return b"".join(parts) + BD.gen_corpus(1 << 14, 5, "iid").tobytes()


def test_reference_equals_program():
    import hyperscan_tpu_torch as ht

    n = 240
    pats, ids = BD.patterns(n)
    db = ht.compile_multi(pats, [0] * n, ids, ht.HS_MODE_BLOCK)
    data = _dense(n, np.random.default_rng(4))
    want = R.block_matches(data, _rs(n))
    assert len(want) > 1000
    assert sorted(ht.scan_batch(db, [data], device="cpu")[0]) == sorted(want)


def test_controls_break_the_guarantee():
    block = BD.gen_corpus(1 << 16, 3, "structured").tobytes()
    full = R.block_matches(block, _rs(10000))
    assert len(R.single_match(block, _rs(10000))) == 4 < len(full)
    # a plant across the write boundary: the write alone misses it
    data = b"x" * 1456 + b"attack0 " + b"y" * 1456
    assert R.stream_matches(data, _rs(10), 1460) == ({1: [(0, 0, 1463)]},
                                                    [])
    assert R.write_alone(data, _rs(10), 1460) == ({}, [])
    assert R.CONTROLS == {"single_match": R.single_match,
                          "write_alone": R.write_alone}
