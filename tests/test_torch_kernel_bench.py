"""The port's per-kernel benches (hyperscan_tpu_torch/tools/kernel_bench.py,
tools_torch_bench_kernels.py) and its kconfirm bench
(hyperscan_tpu_torch/tools/kconf_bench.py, tools_torch_bench_kconfirm.py)
on the CPU, where every kernel wrapper takes its plain version.

- The four benches' databases have the tables of the JAX package's sets
  (tools_bench_kernels.py:19-22, :88-91, :152-155, :214), compiled as
  that file compiles them.
- Each engine bench runs at 1 MiB: its kernel equals its plain version
  on the block it times, and the end offsets of its records over the
  bench corpus equal the ends of the JAX package's host-route scan of the
  same bytes.
- The batch-scan and literal benches run at 1 MiB (the literal ones with
  a 600-pattern bench ruleset, structured and iid): each kernel equals
  its plain version on the input it times, and each row gives its report
  line.
- The kconfirm bench at 1 MiB: both families' verified pairs are equal as
  sets, scan by scan, and equal the JAX package's host filter + confirm.
Every value is an integer, so equality is exact.
"""

import dataclasses

import numpy as np
import pytest
import torch

import hyperscan_tpu as hs
import torch_ref_native  # noqa: F401 (the reference's native build, locked)
import tools_torch_bench_kconfirm
import tools_torch_bench_kernels
from hyperscan_tpu.database import NfaEngine as RefNfa
from hyperscan_tpu.database import compile_patterns as ref_compile
from hyperscan_tpu.grey import Grey as RefGrey
from hyperscan_tpu.runtime.lit_runtime import confirm_candidates
from hyperscan_tpu.runtime.lit_runtime import verify_pairs as ref_verify
from hyperscan_tpu.runtime.smallwrite import teddy_filter_host
from hyperscan_tpu_torch.ops._build import LAUNCHES
from hyperscan_tpu_torch.tools import benchdata as BD
from hyperscan_tpu_torch.tools import kconf_bench as KC
from hyperscan_tpu_torch.tools import kernel_bench as KB

CPU = "cpu"
ROUTES = list(KB.ENGINE_SETS)
KCONF_PATTERNS = 600  # the kconfirm bench's ruleset in these tests


def _ref_engine(route):
    """The engine the JAX package's tools_bench_kernels.py benches."""
    if route == "bounded_dfa":
        db = ref_compile([r"ab[cd]{2,6}ef", r"[0-9]{3}-[0-9]{4}",
                          r"GET /[a-z]{1,12} "],
                         grey=RefGrey(allow_teddy=False))
        return db.engines[0]
    if route == "unbounded_dfa":
        db = ref_compile([r"\d+[a-z]{3,}\d+"], flags=[2],
                         grey=RefGrey(allow_teddy=False))
        return db.engines[0]
    if route == "cyclic_nfa":
        db = ref_compile([r"(ax|by|cz|dw)+[!]"],
                         grey=RefGrey(max_dfa_states=8, allow_teddy=False))
    else:
        db = hs.compile_multi([r".*a.{18}b"])
    return next(e for e in db.engines if isinstance(e, RefNfa))


def _assert_same(ref, port, where):
    """Two engines (dataclasses) equal field by field, arrays exactly."""
    if dataclasses.is_dataclass(ref):
        assert type(ref).__name__ == type(port).__name__, where
        for f in dataclasses.fields(ref):
            _assert_same(getattr(ref, f.name), getattr(port, f.name),
                         f"{where}.{f.name}")
    elif isinstance(ref, np.ndarray):
        assert np.array_equal(ref, np.asarray(port)), where
    elif isinstance(ref, (list, tuple)):
        assert len(ref) == len(port), where
        for i, (a, b) in enumerate(zip(ref, port)):
            _assert_same(a, b, f"{where}[{i}]")
    else:
        assert ref == port, where


@pytest.mark.parametrize("route", ROUTES)
def test_bench_databases_equal_reference(route):
    port = KB.engine_db(route)
    assert port.lit is None and len(port.engines) == 1
    _assert_same(_ref_engine(route), port.engines[0], route)


@pytest.mark.parametrize("route", ROUTES)
def test_bench_runs_at_1mib_on_cpu(route):
    before = dict(LAUNCHES)
    r = KB.bench_route(route, sizes_mb=(1,), reps=1, device=CPU)
    assert dict(LAUNCHES) == before  # the plain versions: no launch
    kernel = KB.ENGINE_SETS[route][3]
    assert r["err"] == {kernel: 0} and r["launches"] == {kernel: 0}
    (s,) = r["rows"]
    assert s["kernel"] == kernel and s["mb"] == 1
    assert s["records"] > 0 and s["ms"] > 0 and s["plain_ms"] > 0
    assert s["bound_ms"] == max(s["t_ops"], s["t_bytes"]) > 0
    # the records' end offsets against the reference's host-route scan
    corpus = KB.bench_corpus(route, 1 << 20, 1)
    inp = KB.bench_inputs(torch, route, KB.engine_db(route), corpus, CPU)
    recs, tot, _x = inp["run"](KB.RECORD_CAP)
    rec = recs[:int(tot)].long().numpy()
    if route == "acyclic_nfa":
        ends = rec[:, 0] + 1
    else:
        ends = inp["plan"].meta[rec[:, 0], 0].astype(np.int64) \
            + rec[:, 1] + 1
    pats, flags, grey, _k = KB.ENGINE_SETS[route]
    ref = ref_compile(pats, flags, grey=RefGrey(host_scan_limit=1 << 22,
                                                **grey))
    want = {m[2] for m in hs.scan(ref, corpus.tobytes())}
    assert len(want) > 20
    assert set(ends.tolist()) == want


def test_bench_corpus_plants_every_route():
    c = KB.bench_corpus("bounded_dfa", 1 << 16, 0)
    assert c.dtype == np.uint8 and len(c) == 1 << 16
    assert c[:64].min() >= 32 and c[:64].max() < 127
    for p in KB.ENGINE_PLANTS:
        assert p in c.tobytes()
    n = KB.bench_corpus("acyclic_nfa", 1 << 16, 0)
    assert set(n[:64].tobytes()) <= set(KB.NFA_ALPHABET.tobytes())


def test_kernel_bench_main_on_cpu(capsys):
    assert tools_torch_bench_kernels.main(
        ["--device", CPU, "--mb", "1", "--reps", "1",
         "--bench", "bounded_dfa", "acyclic_nfa"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[-1] == "cpu"
    assert [line.split(" ")[0] for line in out[:-1]] == ["bounded_dfa",
                                                         "acyclic_nfa"]
    assert all("equal to the plain version" in line for line in out[:-1])


@pytest.fixture(scope="module")
def kconf_db():
    import hyperscan_tpu_torch as ht

    pats, ids = BD.patterns(KCONF_PATTERNS)
    return ht.compile_multi(pats, ids=ids)


@pytest.mark.parametrize("bench", ["dfa_rows", *KB.LIT_BENCHES])
def test_kernel_benches_run_at_1mib_on_cpu(bench, kconf_db):
    """The batch-scan and literal benches through the plain versions: each
    kernel held to its plain version on the input it times (a difference
    raises), a row a kernel and input, each with its report line."""
    before = dict(LAUNCHES)
    r = KB.run_benches([bench], sizes_mb=(1,), reps=1, device=CPU,
                       db=kconf_db)[bench]
    assert dict(LAUNCHES) == before  # the plain versions: no launch
    kernels = ("dfa_scan_rows",) if bench == "dfa_rows" \
        else KB.LIT_BENCHES[bench][1]
    assert r["err"] == dict.fromkeys(kernels, 0)
    assert r["launches"] == dict.fromkeys(kernels, 0)
    assert {s["kernel"] for s in r["rows"]} == set(kernels)
    if bench != "dfa_rows":
        assert {s["kind"] for s in r["rows"]} == set(KB.LIT_KINDS)
    for s in r["rows"]:
        assert s["mb"] == 1 and s["ms"] > 0 and s["plain_ms"] > 0
        assert s["count"] > 0
        assert s["bound_ms"] > 0 and s["bound_by"] in ("bytes", "operations")
    lines = KB.report({bench: r}, "cpu")
    assert len(lines) == len(r["rows"])
    assert all(line.startswith(f"{bench} (") and "bound" in line
               and "plain version" in line
               and "equal to the plain version" in line for line in lines)


def test_kconf_bench_families_equal_on_cpu(kconf_db):
    res = KC.run(kconf_db, mb=1, iters=2, kind="iid", device=CPU)
    assert list(res) == list(KC.FAMILIES)
    for fam, r in res.items():
        assert r["family"] == fam and r["redispatches"] == 0
        assert [f for f, _n in r["warm"]] == [fam] * KC.WARM
    a, b = (res[f]["pairs"] for f in KC.FAMILIES)
    assert a == b and all(len(p) >= len(BD.PLANTS) for p in a)
    # each timed scan's pairs: the reference's host filter + confirm
    pats, ids = BD.patterns(KCONF_PATTERNS)
    ref = hs.compile_multi(pats, ids=ids)
    z = np.zeros(1, np.int64)
    for s, got in enumerate(a):
        corpus = BD.gen_corpus(1 << 20, KC.WARM + s, "iid")
        pos, words = teddy_filter_host(corpus, ref.lit.masks)
        f, p = confirm_candidates(ref.lit, corpus, z, pos, words)
        f, p = ref_verify(ref.lit, corpus, z, f, p)
        assert got == set(zip(f.tolist(), p.tolist()))


def test_kconf_bench_main_on_cpu(capsys):
    assert tools_torch_bench_kconfirm.main(
        ["--device", CPU, "--mb", "1", "--iters", "1", "--n", "300",
         "--separate"]) == 0
    out = capsys.readouterr().out
    assert "compact: 1 x 1 MiB" in out and "kconfirm:" not in out
    assert out.splitlines()[-1] == "cpu"
