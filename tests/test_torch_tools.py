"""The port's tools and public surface against the JAX package's
(hyperscan_tpu_torch.tools vs hyperscan_tpu.tools, hyperscan_tpu_torch vs
hyperscan_tpu).

hscheck's report and hsbench's `Expression count`, `Database CRC` and
`Matches` lines (block, stream and vectored mode, and a SQLite corpus
built by the port's corpus tool) must equal the reference's on the same
files; the port scans on the CPU (--device cpu). Both packages must
export the same public names (the port adds `load_reference`). The stage
probe runs on the CPU at a small size, and the port's new modules import
neither JAX nor the JAX package.
"""

import json
import pathlib
import subprocess
import sys
import types

import numpy as np
import pytest

import hyperscan_tpu as hs
import hyperscan_tpu_torch as ht
import torch_ref_native  # noqa: F401 (the reference's native build, locked)

from hyperscan_tpu.tools import hsbench as ref_hsbench
from hyperscan_tpu.tools import hscheck as ref_hscheck
from hyperscan_tpu_torch.tools import corpus, hsbench, hscheck, kconf_probe

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_ONLY = {"load_reference"}  # the port loads the JAX package's blobs


@pytest.fixture()
def patfile(tmp_path):
    """tests/test_tools.py's pattern file."""
    p = tmp_path / "pats.txt"
    p.write_text(
        "1:/attack[0-9]+/\n"
        "2:/foo(bar|baz)/i\n"
        "# comment\n"
        "3:/err(or)?/\n"
        "4:/[ab]+c[de]+/\n"
        "5:/gatex(ab|cd)*doorq/\n"
        "6:/num[0-9]{2,4}tail/L\n"
        "7:/lead[a-z]*mark7/\n"
    )
    return str(p)


@pytest.fixture()
def corpusfile(tmp_path):
    rng = np.random.default_rng(0)
    blob = bytearray(rng.integers(32, 127, 50000, dtype=np.uint8).tobytes())
    blob[100:108] = b"attack42"
    blob[5000:5006] = b"FOOBAR"
    for off in range(8000, 49000, 2999):
        blob[off:off + 30] = b"gatexabcddoorq num123tail errs"
    f = tmp_path / "corpus.bin"
    f.write_bytes(bytes(blob))
    return str(f)


def _fields(out: str) -> dict:
    keep = ("Expression count", "Database CRC", "Matches", "Corpus size",
            "Bytecode size")
    got = {}
    for line in out.splitlines():
        key, _, val = line.partition(":")
        if key.strip() in keep:
            got[key.strip()] = val.strip()
    return got


@pytest.mark.parametrize("text,rc", [
    (None, 0), ("1:/good/\n2:/a{5,2}/\n3:/(?<=x)y/\n", 1)])
def test_hscheck_equals_reference(patfile, tmp_path, capsys, text, rc):
    path = patfile
    if text is not None:
        path = str(tmp_path / "bad.txt")
        pathlib.Path(path).write_text(text)
    for mode in ("block", "stream"):
        assert ref_hscheck.main([path, "--mode", mode]) == rc
        want = capsys.readouterr().out
        assert hscheck.main([path, "--mode", mode]) == rc
        assert capsys.readouterr().out == want


@pytest.mark.parametrize("mode", ["block", "stream", "vectored"])
def test_hsbench_equals_reference(patfile, corpusfile, capsys, mode):
    args = ["-e", patfile, "-c", corpusfile, "--repeats", "1",
            "--block-size", "8192", "--blocks-per-stream", "3",
            "--mode", mode]
    assert ref_hsbench.main(args) == 0
    want = _fields(capsys.readouterr().out)
    assert hsbench.main(args + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "Overall throughput" in out
    got = _fields(out)
    assert got == want and len(got) == 5
    assert int(got["Matches"].split()[0]) >= 12


def test_hsbench_sqlite_corpus_and_profile(patfile, tmp_path, capsys):
    """A SQLite corpus built by the port's corpus tool gives hsbench the
    reference's matches in stream mode; --profile writes a Chrome trace."""
    src = tmp_path / "data.bin"
    src.write_bytes(b"attack42 foobar gatexcdcddoorq " * 300)
    db = tmp_path / "corpus.db"
    assert corpus.main([str(db), "--from-file", str(src), "--block-size",
                        "512", "--blocks-per-stream", "3"]) == 0
    blocks, groups = hsbench.load_sqlite_corpus(str(db))
    assert sum(map(len, blocks)) == 300 * 31 and all(
        len(g) <= 3 for g in groups)
    capsys.readouterr()
    args = ["-e", patfile, "-c", str(db), "--mode", "stream", "--repeats",
            "1"]
    assert ref_hsbench.main(args) == 0
    want = _fields(capsys.readouterr().out)
    prof = tmp_path / "prof"
    assert hsbench.main(args + ["--device", "cpu", "--profile",
                                str(prof)]) == 0
    assert _fields(capsys.readouterr().out) == want
    trace = json.loads((prof / "hsbench_trace.json").read_text())
    assert trace["traceEvents"]


def _public(mod) -> set:
    return {n for n in dir(mod) if not n.startswith("_")
            and not isinstance(getattr(mod, n), types.ModuleType)}


def test_public_names_equal_reference():
    assert _public(ht) - PORT_ONLY == _public(hs)
    assert PORT_ONLY <= _public(ht)
    for name in ("HS_MODE_STREAM", "HS_MODE_VECTORED", "hs_open_stream",
                 "hs_scan_vector", "scan_streamset", "stream_size",
                 "scan_count"):
        assert getattr(ht, name) is not None


def test_api_sizes_and_info_equal_reference():
    pats = [r"attack[0-9]+", r"foo(bar|baz)", r"num[0-9]{2,4}tail"]
    rdb = hs.compile_multi(pats, ids=[1, 2, 3], mode=hs.HS_MODE_STREAM)
    pdb = ht.compile_multi(pats, ids=[1, 2, 3], mode=ht.HS_MODE_STREAM)
    assert ht.stream_size(pdb) == hs.stream_size(rdb)
    assert ht.database_size(pdb) == hs.database_size(rdb)
    blob = ht.serialize_database(pdb)
    assert blob == hs.serialize_database(rdb)
    assert ht.serialized_database_size(blob) == len(blob)
    assert ht.serialized_database_info(blob) == \
        hs.serialized_database_info(blob)
    assert ht.deserialize_database_at(blob).mode == ht.HS_MODE_STREAM
    for p, f in ((r"ab(c|de)$", 0), (r"x{2,5}", 0), (r"a.*b", 0)):
        assert ht.expression_info(p, f) == hs.expression_info(p, f)
        ext = ht.ExprExt(min_length=3, edit_distance=1)
        assert ht.expression_ext_info(p, f, ext) == \
            hs.expression_ext_info(p, f, hs.ExprExt(min_length=3,
                                                    edit_distance=1))
    s = ht.alloc_scratch(pdb, 1024)
    assert ht.scratch_size(ht.clone_scratch(s)) == hs.scratch_size(
        hs.alloc_scratch(rdb, 1024))
    bdb = ht.compile_multi(pats, ids=[1, 2, 3])
    data = b"xx attack12 foobaz num123tail " * 3
    assert ht.scan_count(bdb, data, device="cpu") == len(
        ht.scan(bdb, data, device="cpu")) == hs.scan_count(
            hs.compile_multi(pats, ids=[1, 2, 3]), data) == 12
    pats, flags, ids = [r"x*", "ab"], [hs.HS_FLAG_ALLOWEMPTY, 0], [4, 5]
    got = ht.scan_block_ranges(ht.compile_multi(pats, flags, ids), b"abc",
                               device="cpu")
    assert got == hs.scan_block_ranges(hs.compile_multi(pats, flags, ids),
                                       b"abc")
    assert got[1] == [(4, 0, 3)] and got[0] == [(5, 0, 2)]


def test_kconf_probe_on_cpu():
    """The stage probe at a small size on the CPU (its plain versions):
    every variant timed, stage 3's counts given."""
    pats, ids = kconf_probe.patterns(300)
    db = ht.compile_multi(pats, ids=ids)
    res = kconf_probe.stage_times(db, kconf_probe.gen_corpus(
        1 << 18, 1, "iid"), reps=1, device="cpu")
    assert list(res["ms"]) == list(kconf_probe.STAGE_NAMES)
    assert all(v > 0 for v in res["ms"].values())
    assert res["candidates"] > res["matches"] > 0
    assert res["families"] == ["kconfirm"]
    lines = kconf_probe.report(res, "cpu")
    assert len(lines) == 7 and all("GB/s" in x for x in lines)


def test_hsbench_script_finds_plants(tmp_path):
    """tools_torch_hsbench.py: the planted corpus gives the same nonzero
    match count in block, stream and vectored mode."""
    r = subprocess.run(
        [sys.executable, "tools_torch_hsbench.py", "--mib", "1",
         "--patterns", "200", "--device", "cpu", "--out", str(tmp_path)],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    got = [int(x.split()[1]) for x in r.stdout.splitlines()
           if x.startswith("Matches:")]
    assert len(got) == 3 and got[0] > 0 and len(set(got)) == 1, got
    assert (tmp_path / "prof" / "hsbench_trace.json").exists()


def test_new_modules_import_without_jax():
    code = ("import sys; sys.modules['jax'] = None;"
            "sys.modules['hyperscan_tpu'] = None;"
            "import hyperscan_tpu_torch, chip_smoke;"
            "import hyperscan_tpu_torch.runtime.stream,"
            " hyperscan_tpu_torch.runtime.streamset,"
            " hyperscan_tpu_torch.tools.hsbench,"
            " hyperscan_tpu_torch.tools.hscheck,"
            " hyperscan_tpu_torch.tools.corpus,"
            " hyperscan_tpu_torch.tools.kconf_probe;"
            "import tools_torch_probe_kconfirm, tools_torch_hsbench")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
