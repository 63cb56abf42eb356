"""The port's compile side and database carry-across against the JAX
package, and the port's import boundary.

The port keeps its own copy of the compiler, so its compile must give
the same teddy masks, class split and confirm tables as the reference,
and a database serialized by the JAX package must load into the port
(`load_reference`) and scan identically."""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest

import bench
import hyperscan_tpu as hs
import hyperscan_tpu_torch as ht
import torch_ref_native  # noqa: F401 (the reference's native build, locked)
from hyperscan_tpu.database import compile_patterns as ref_compile
from hyperscan_tpu.grey import Grey as RefGrey
from hyperscan_tpu.ops.teddy import _class_split as ref_class_split
from hyperscan_tpu.runtime.lit_runtime import \
    confirm_device_tables as ref_confirm_tables
from hyperscan_tpu_torch.ops.teddy import _class_split
from hyperscan_tpu_torch.runtime.lit_runtime import confirm_device_tables

from test_torch_teddy import force_ungated_compact

ROOT = pathlib.Path(__file__).resolve().parents[1]

RULESETS = {
    "bench100": bench._patterns(100),
    "bench600": bench._patterns(600),
    "caseless": ([r"Admin\d", r"SeLeCt", r"union\s+select", r"xyz{2,4}w"],
                 [1, 2, 3, 4]),
}


@pytest.mark.parametrize("name", sorted(RULESETS))
def test_compile_tables_equal_reference(name):
    pats, ids = RULESETS[name]
    flags = [hs.HS_FLAG_CASELESS if name == "caseless" else 0] * len(pats)
    ref = hs.compile_multi(pats, flags=flags, ids=ids)
    port = ht.compile_multi(pats, flags=flags, ids=ids)
    assert np.array_equal(port.lit.masks, ref.lit.masks)
    a, b = ref_class_split(ref.lit.masks), _class_split(port.lit.masks)
    assert (a is None) == (b is None)
    if a is not None:
        assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    tr, tp = ref_confirm_tables(ref.lit), confirm_device_tables(port.lit)
    assert len(tr) == len(tp)
    for gr, gp in zip(tr, tp):
        assert gr[:3] == gp[:3] and gr[5] == gp[5]
        assert np.array_equal(gr[3], gp[3])
    assert len(port.engines) == len(ref.engines)
    assert len(port.patterns) == len(ref.patterns)


def test_load_reference_scans_identically():
    pats, ids = bench._patterns(100)
    ref = ref_compile(pats, ids=ids, grey=RefGrey(host_scan_limit=0))
    force_ungated_compact(ref.lit)
    blob = hs.serialize_database(ref)
    port = ht.load_reference(blob)
    assert isinstance(port, ht.Database)
    assert port.host_scan_limit == 0
    assert np.array_equal(port.lit.masks, ref.lit.masks)
    rng = np.random.default_rng(8)
    c = (32 + rng.integers(0, 95, size=100_000)).astype(np.uint8)
    c[128:128 + 4096] = bench._plant_region()
    data = c.tobytes()
    want = hs.scan(ref, data)
    assert len(want) >= len(bench._PLANTS)
    assert ht.scan(port, data, device="cpu") == want
    # and back: the port's serialization loads into the reference
    again = hs.deserialize_database(ht.serialize_database(port))
    assert np.array_equal(again.lit.masks, ref.lit.masks)


def test_database_info_reports_torch_target():
    db = ht.compile_multi(["attack0"], ids=[1])
    info = ht.database_info(db)
    assert "tpu-generic" in info  # the shared format tag
    assert ("cuda/" if ht.valid_platform() else "cpu/cpu") in info
    assert ht.version().endswith("hyperscan-tpu-torch")
    plat = ht.populate_platform()
    if ht.valid_platform():
        assert plat["platform"] == "cuda" and plat["num_devices"] >= 1
    else:
        assert plat == {"platform": "none", "device_kind": "none",
                        "num_devices": 0}


def _port_files():
    """The port's package, its chip smoke test, its root launchers
    (tools_torch_*.py) and its examples."""
    files = sorted((ROOT / "hyperscan_tpu_torch").rglob("*.py"))
    return (files + [ROOT / "chip_smoke.py"]
            + sorted(ROOT.glob("tools_torch_*.py"))
            + sorted((ROOT / "examples" / "torch").glob("*.py")))


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module:
            yield node.module.split(".")[0]


def test_port_imports_no_jax_nor_reference_package():
    files = _port_files()
    assert len(files) > 20
    for f in ("chip_smoke.py", "tools_torch_bench.py",
              "tools_torch_diff_device_host.py",
              "examples/torch/simplegrep.py",
              "hyperscan_tpu_torch/tools/bench.py",
              "hyperscan_tpu_torch/graft_entry.py",
              "hyperscan_tpu_torch/tools/kernel_bench.py",
              "hyperscan_tpu_torch/tools/kconf_bench.py",
              "tools_torch_bench_kernels.py",
              "tools_torch_bench_kconfirm.py"):
        assert ROOT / f in files, f
    for f in files:
        roots = set(_imported_roots(f))
        assert not roots & {"jax", "jaxlib", "hyperscan_tpu"}, (f, roots)


def test_importing_port_leaves_jax_unloaded():
    code = ("import sys, hyperscan_tpu_torch, hyperscan_tpu_torch.ops.teddy;"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'hyperscan_tpu'));"
            "print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
