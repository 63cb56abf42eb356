"""The port's block-mode scan against the JAX package's, match list for
match list (hyperscan_tpu_torch.scan(db, data, device="cpu") vs
hyperscan_tpu.scan).

Both databases are compiled with Grey(host_scan_limit=0), so every scan
takes the device path: the JAX side in Pallas interpret mode, the port on
its plain PyTorch versions, both with the literal family pinned to
ungated compact + hash confirm (tests/test_torch_families.py covers the
other families). Inputs come from a numpy seed; equality is
exact."""

import numpy as np
import pytest

import bench
import hyperscan_tpu as hs
import hyperscan_tpu_torch as ht
import torch_ref_native  # noqa: F401 (the reference's native build, locked)
from hyperscan_tpu.database import compile_patterns as ref_compile
from hyperscan_tpu.grey import Grey as RefGrey
from hyperscan_tpu_torch.database import compile_patterns as port_compile
from hyperscan_tpu_torch.grey import Grey as PortGrey
from hyperscan_tpu_torch.ops.teddy_families import force_family

from test_anchored import FAMILY
from test_chains import CHAIN_PATTERNS
from test_chains import CORPORA as CHAIN_CORPORA
from test_torch_teddy import force_ungated_compact


def _pair(pats, flags=None, ids=None):
    ids = list(range(len(pats))) if ids is None else ids
    flags = [0] * len(pats) if flags is None else flags
    ref = ref_compile(pats, flags, ids, grey=RefGrey(host_scan_limit=0))
    port = port_compile(pats, flags, ids, grey=PortGrey(host_scan_limit=0))
    assert ref.lit is not None and not ref.engines, "literal-routed only"
    force_ungated_compact(ref.lit)
    force_family(port.lit, "compact")
    return ref, port


def _same(ref, port, data: bytes):
    want = hs.scan(ref, data)
    got = ht.scan(port, data, device="cpu")
    assert got == want
    return got


def _bench_corpus(n: int, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    c = (32 + rng.integers(0, 95, size=n)).astype(np.uint8)
    c[128:128 + 4096] = bench._plant_region()
    return c.tobytes()


@pytest.mark.parametrize("som", [False, True])
def test_bench_ruleset_with_plants(som):
    pats, ids = bench._patterns(100)
    flags = [0] * len(pats)
    need = len(bench._PLANTS)
    if som:  # the bench's SOM config: shape 5 (infix chains) dropped
        keep = [j for j, i in enumerate(ids) if i % 6 != 5]
        pats = [pats[j] for j in keep]
        ids = [ids[j] for j in keep]
        flags = [hs.HS_FLAG_SOM_LEFTMOST] * len(pats)
        need -= 2
    ref, port = _pair(pats, flags, ids)
    got = _same(ref, port, _bench_corpus(150_000, 2))
    assert len(got) >= need
    if som:
        assert any(f > 0 for (_e, f, _t) in got)


def test_literal_path_fused_device_case():
    """tests/test_literal_path.py: the fused device confirm over 300 KB."""
    words = ["attack", "payload", "shell", "admin"]
    pats = [[w + str(i), rf"{w}{i}[0-9]{{2,4}}z", rf"q{i}h[a-f0-9]{{8}}",
             rf"x{i}(GET|POST) /[a-z]{{1,9}}"][i % 4]
            for i, w in ((i, words[i % 4]) for i in range(120))]
    ref, port = _pair(pats)
    rng = np.random.default_rng(3)
    corpus = (32 + rng.integers(0, 95, size=300_000)).astype(np.uint8)
    off = 4000
    for p in [b"attack0 ", b"payload1699z", b"q2hdeadbeef", b"x3GET /ab",
              b"shell2442z99"]:
        corpus[off:off + len(p)] = np.frombuffer(p, np.uint8)
        off += 50_000
    assert len(_same(ref, port, corpus.tobytes())) >= 4


def test_literal_path_cell_boundary_case():
    """tests/test_literal_path.py: plants across row and cell boundaries."""
    ref, port = _pair(["needleZ", "probeQ"])
    rng = np.random.default_rng(11)
    corpus = (32 + rng.integers(0, 95, size=200_000)).astype(np.uint8)
    offs = [0, 120, 127, 65_520, 65_533, 131_000, 199_990]
    for k, off in enumerate(offs):
        p = b"needleZ" if k % 2 else b"probeQ"
        corpus[off:off + len(p)] = np.frombuffer(p, np.uint8)
    assert len(_same(ref, port, corpus.tobytes())) >= len(offs)


def test_anchored_family_case():
    ref, port = _pair(FAMILY, ids=[1, 2, 3, 4])
    data = (b"xx attack734z yy payload12399z zz evilstring55z "
            b"attack7z gadget123456z gadget12345z oo attack71234z") * 40
    assert _same(ref, port, data)


@pytest.mark.parametrize("k", range(len(CHAIN_CORPORA)))
def test_chains_case(k):
    ref, port = _pair(CHAIN_PATTERNS)
    _same(ref, port, CHAIN_CORPORA[k])


def test_batch_equals_reference():
    pats, ids = bench._patterns(100)
    ref, port = _pair(pats, ids=ids)
    blocks = [_bench_corpus(40_000, s)[:40_000 - 7 * s] for s in range(4)]
    blocks.append(b"")
    want = hs.scan_batch(ref, blocks)
    assert ht.scan_batch(port, blocks, device="cpu") == want


def test_empty_input():
    ref, port = _pair(["attack0", "shell1"])
    assert _same(ref, port, b"") == []


def test_cuda_device_without_card_raises():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    _ref, port = _pair(["attack0"])
    with pytest.raises(RuntimeError, match="cuda"):
        ht.scan(port, b"xx attack0 yy")


def test_engine_scan_above_host_limit_raises():
    """Above host_scan_limit an engine database scans on the device path
    and equals the reference, also with a mesh (the engine half then runs
    on the mesh's first device); a mesh that is not a Mesh raises."""
    from hyperscan_tpu_torch.parallel import make_mesh

    pats = [r"[0-9]{3}-[0-9]{4}"]
    port = port_compile(pats, grey=PortGrey(host_scan_limit=0))
    ref = ref_compile(pats, [0], [0], grey=RefGrey(host_scan_limit=0))
    assert port.engines
    data = b"call 555-1212 or 555-12345 now"
    assert ht.scan(port, data, device="cpu") == hs.scan(ref, data)
    assert len(hs.scan(ref, data)) == 2
    blocks = [data, b"555-1212", data[5:]]
    assert ht.scan_batch(port, blocks, mesh=make_mesh(2, device="cpu")) \
        == hs.scan_batch(ref, blocks)
    with pytest.raises(TypeError, match="Mesh"):
        ht.scan_batch(port, [b"555-1212"], mesh=object(), device="cpu")
