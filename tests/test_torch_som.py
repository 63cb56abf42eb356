"""SOM (HS_FLAG_SOM_LEFTMOST) through the port against the JAX package:
every case of tests/test_som.py, on the same PATTERNS and CORPORA, run
through both packages; the outputs must be equal.

The JAX package runs as tests/test_som.py runs it. The port runs each
case on two routes:
- "cpu": its default compile, every scan and stream on device="cpu";
- "device": compiled with Grey(host_scan_limit=0), as
  tools/hscollider.compile_on_device compiles, so every scan takes the
  device branch (its kernels' plain versions on the CPU).
Each case also keeps test_som.py's own checks against the AST oracle.
"""

import functools

import numpy as np
import pytest

import hyperscan_tpu as hs
import hyperscan_tpu_torch as ht
import torch_ref_native  # noqa: F401 (the reference's native build, locked)
from hyperscan_tpu import database as ref_database
from hyperscan_tpu import flags as ref_flags
from hyperscan_tpu.compiler.parser import parse
from hyperscan_tpu.utils.oracle import ast_leftmost_som
from hyperscan_tpu_torch import database as port_database
from hyperscan_tpu_torch import flags as port_flags
from hyperscan_tpu_torch.grey import Grey
from test_som import CORPORA, PATTERNS, SOM


class Pkg:
    """One package's calls as a case makes them: compiled with `grey`
    (the package's default when None), scans and streams with the
    keyword arguments `on`. Other names resolve on the package; its
    `database` and `flags` modules are attributes."""

    def __init__(self, mod, database, flags, grey=None, **on):
        self.mod, self.database, self.flags = mod, database, flags
        self.grey, self.on = grey, on

    def __getattr__(self, name):
        return getattr(self.mod, name)

    def compile_multi(self, pats, flags=None, ids=None, mode=None):
        return self.database.compile_patterns(
            pats, flags, ids, self.mod.HS_MODE_BLOCK if mode is None
            else mode, grey=self.grey)

    def compile(self, pat, flags=0, mode=None):
        return self.compile_multi([pat], [flags], [0], mode)

    def scan(self, db, data):
        return [tuple(m) for m in self.mod.scan(db, data, **self.on)]

    def scan_stream(self, st, data):
        return [tuple(m) for m in self.mod.scan_stream(st, data)]

    def close_stream(self, st):
        return [tuple(m) for m in self.mod.close_stream(st)]

    def open_stream(self, db):
        return self.mod.open_stream(db, **self.on)

    def expand_stream(self, db, buf):
        return self.mod.expand_stream(db, buf, **self.on)


REF = Pkg(hs, ref_database, ref_flags)
ROUTES = {"cpu": Pkg(ht, port_database, port_flags, device="cpu"),
          "device": Pkg(ht, port_database, port_flags,
                        Grey(host_scan_limit=0), device="cpu")}


def _ends(pkg, db, data):
    return {(m[1], m[2]) for m in pkg.scan(db, data)}


def _oracle(pat, flags, data):
    return {(s, e) for (e, s) in ast_leftmost_som(parse(pat, flags),
                                                   data).items()}


def case_vs_oracle(pkg):
    """test_som.py::test_som_vs_oracle."""
    out = []
    for pat in PATTERNS:
        db = pkg.compile(pat, flags=SOM)
        node = parse(pat, 0)
        for data in CORPORA:
            want = ast_leftmost_som(node, data)
            got = pkg.scan(db, data)
            got_map = {to: frm for (_id, frm, to) in got}
            assert got_map == want, (pat, data, got_map, want)
            out.append(got)
    return out


def case_multi_pattern(pkg):
    """test_som.py::test_som_multi_pattern."""
    db = pkg.compile_multi([r"attack", r"at{1,5}ack"], flags=[SOM, SOM],
                           ids=[1, 2])
    ms = pkg.scan(db, b"zz attttack attack")
    assert (2, 3, 11) in ms
    assert (1, 12, 18) in ms and (2, 12, 18) in ms
    return ms


def case_streaming(pkg):
    """test_som.py::test_som_streaming."""
    db = pkg.compile_multi([r"admin[0-9]{1,3}"], flags=[SOM], ids=[5],
                           mode=pkg.HS_MODE_STREAM)
    st = pkg.open_stream(db)
    ms = pkg.scan_stream(st, b"xx adm")
    ms += pkg.scan_stream(st, b"in427 yy")
    ms += pkg.close_stream(st)
    assert ms == [(5, 3, 9), (5, 3, 10), (5, 3, 11)]
    return ms


def case_singlematch_conflict(pkg):
    """test_som.py::test_som_singlematch_conflict."""
    with pytest.raises(pkg.CompileError) as err:
        pkg.compile(r"attack", flags=SOM | pkg.HS_FLAG_SINGLEMATCH)
    return type(err.value).__name__


def case_without_literal_factor(pkg):
    """test_som.py::test_som_without_literal_factor."""
    db = pkg.compile(r"[0-9]{3}-[0-9]{4}", flags=SOM)
    assert any(isinstance(e, pkg.database.SomEngine) for e in db.engines)
    out = [sorted(pkg.scan(db, b"call 555-1212 now"))]
    assert out[0] == [(0, 5, 13)]
    pat = r"[0-9]+x{0,3}"
    db2 = pkg.compile(pat, flags=SOM)
    rng = np.random.default_rng(4)
    for _ in range(40):
        d = bytes(rng.choice(np.frombuffer(b"019x z", np.uint8),
                             size=int(rng.integers(0, 30))))
        got = _ends(pkg, db2, d)
        assert got == _oracle(pat, SOM, d), (d, sorted(got))
        out.append(sorted(got))
    return out


def case_general_streaming_and_serialize(pkg):
    """test_som.py::test_general_som_streaming_and_serialize."""
    pat = r"[0-9]+x{0,3}"
    sdb = pkg.compile(pat, flags=SOM, mode=pkg.HS_MODE_STREAM)
    sdb = pkg.deserialize_database(pkg.serialize_database(sdb))
    rng = np.random.default_rng(6)
    out = []
    for _ in range(20):
        d = bytes(rng.choice(np.frombuffer(b"019x z", np.uint8),
                             size=int(rng.integers(2, 30))))
        k = int(rng.integers(1, 4))
        cuts = sorted(rng.choice(len(d), size=k, replace=False).tolist())
        st = pkg.open_stream(sdb)
        ms, prev = [], 0
        for c in cuts + [len(d)]:
            ms += pkg.scan_stream(st, d[prev:c])
            prev = c
            if rng.integers(0, 3) == 0:
                st = pkg.expand_stream(sdb, pkg.compress_stream(st))
        ms += pkg.close_stream(st)
        got = {(m[1], m[2]) for m in ms}
        assert got == _oracle(pat, SOM, d), (d, cuts, sorted(got))
        out.append(ms)
    return out


def case_horizon(pkg):
    """test_som.py::test_som_horizon_past_horizon."""
    flags = pkg.flags
    sdb = pkg.compile(r"a[ab]*z", flags=SOM, mode=pkg.HS_MODE_STREAM
                      | flags.HS_MODE_SOM_HORIZON_SMALL)
    st = pkg.open_stream(sdb)
    ms = (pkg.scan_stream(st, b"a" + b"b" * 70000)
          + pkg.scan_stream(st, b"z") + pkg.close_stream(st))
    assert ms == [(0, flags.HS_OFFSET_PAST_HORIZON, 70002)]
    st = pkg.open_stream(sdb)
    ms2 = pkg.scan_stream(st, b"xxaz") + pkg.close_stream(st)
    assert ms2 == [(0, 2, 4)]
    return ms, ms2


def case_vacuous_branch(pkg):
    """test_som.py::test_som_vacuous_branch_with_literal_branch."""
    p = r"(1xc)|.?"
    fl = pkg.HS_FLAG_ALLOWEMPTY | SOM
    db = pkg.compile(p, flags=fl)
    out = [sorted(_ends(pkg, db, b"z1xcz"))]
    assert set(out[0]) == _oracle(p, fl, b"z1xcz")
    rng = np.random.default_rng(5)
    for _ in range(20):
        d = bytes(rng.choice(np.frombuffer(b"1xcz a", np.uint8),
                             size=int(rng.integers(0, 35))))
        got = _ends(pkg, db, d)
        assert got == _oracle(p, fl, d), (d, sorted(got))
        out.append(sorted(got))
    return out


def case_eod_defers_until_close(pkg):
    """test_som.py::test_som_eod_boundary_report_defers_until_close."""
    pat = r"ab|a.?b$"
    flags = [pkg.HS_FLAG_SOM_LEFTMOST]
    bdb = pkg.compile_multi([pat], flags=flags)
    sdb = pkg.compile_multi([pat], flags=flags, mode=pkg.HS_MODE_STREAM)
    out = []
    want = set(pkg.scan(bdb, b"zaxb"))
    assert want == {(0, 1, 4)}
    st = pkg.open_stream(sdb)
    ms = pkg.scan_stream(st, b"za") + pkg.scan_stream(st, b"xb")
    ms += pkg.close_stream(st)
    assert set(ms) == want
    out.append(ms)
    want2 = set(pkg.scan(bdb, b"zaab"))
    assert want2 == {(0, 1, 4)}
    st = pkg.open_stream(sdb)
    ms = pkg.scan_stream(st, b"zaab") + pkg.close_stream(st)
    assert set(ms) == want2
    out.append(ms)
    st = pkg.open_stream(sdb)
    ms = pkg.scan_stream(st, b"zaab") + pkg.scan_stream(st, b"zz")
    ms += pkg.close_stream(st)
    assert set(ms) == set(pkg.scan(bdb, b"zaabzz"))
    out.append(ms)
    st = pkg.open_stream(sdb)
    pkg.scan_stream(st, b"zaab")
    st2 = pkg.expand_stream(sdb, pkg.compress_stream(st))
    ms = pkg.close_stream(st2)
    assert set(ms) == want2
    out.append(ms)
    return out


CASES = {f.__name__[len("case_"):]: f for f in (
    case_vs_oracle, case_multi_pattern, case_streaming,
    case_singlematch_conflict, case_without_literal_factor,
    case_general_streaming_and_serialize, case_horizon, case_vacuous_branch,
    case_eod_defers_until_close)}


@functools.lru_cache(maxsize=None)
def _reference(case: str):
    return CASES[case](REF)


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("case", list(CASES))
def test_som_equals_reference(case, route):
    assert CASES[case](ROUTES[route]) == _reference(case)
