"""The port's differential tools against the JAX package's:
hyperscan_tpu_torch.utils.oracle, tools.fuzz, tools.hscollider and
tools.hsdump.

The oracles must give exactly the reference's outputs (match ends, `re`
match ends, leftmost starts) over tests/test_tools.py's patterns and a
seeded sample of conformance/signatures.txt, on seeded corpora; the
fuzz grammar must give the reference's patterns from a seed. The port's
collider and fuzz rounds run with --device cpu: their databases are
compiled with `Grey(host_scan_limit=0)`, so every scan takes the device
branch (the corpus upload is counted) and the kernels' plain versions;
so does tools_torch_collider.py, which times the collider's calls.
hsdump must print the reference's text, apart from its `Info:` line,
which names the platform and the target device.
"""

import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_ref_native  # noqa: F401 (the reference's native build, locked)

from hyperscan_tpu.compiler.parser import parse as ref_parse
from hyperscan_tpu.tools import fuzz as ref_fuzz
from hyperscan_tpu.tools import hsdump as ref_hsdump
from hyperscan_tpu.utils import oracle as ref_oracle
from hyperscan_tpu_torch.compiler.parser import parse as port_parse
from hyperscan_tpu_torch.ops import teddy as T
from hyperscan_tpu_torch.tools import fuzz, hscheck, hscollider, hsdump
from hyperscan_tpu_torch.utils import oracle

ROOT = pathlib.Path(__file__).resolve().parents[1]
PATFILE = (
    "1:/attack[0-9]+/\n"
    "2:/foo(bar|baz)/i\n"
    "# comment\n"
    "3:/err(or)?/\n"
    "4:/[ab]+c[de]+/\n"
    "5:/gatex(ab|cd)*doorq/\n"     # general-infix chain
    "6:/num[0-9]{2,4}tail/L\n"     # SOM triples
    "7:/lead[a-z]*mark7/\n"        # class-gap chain
)
N_SIGNATURES = 40  # the seeded sample of the conformance battery


def oracle_entries():
    """tests/test_tools.py's patterns and a seeded sample of the battery
    (combinations reference other expressions and have no oracle)."""
    pat = [hscheck.parse_line(l) for l in PATFILE.splitlines()]
    sig = [hscheck.parse_line(l) for l in (
        ROOT / "conformance" / "signatures.txt").read_text(
            errors="replace").splitlines()]
    sig = [e for e in sig
           if e and not e[2] & (hscheck.hs.HS_FLAG_COMBINATION
                                | hscheck.hs.HS_FLAG_PREFILTER)]
    pick = np.random.default_rng(10).choice(len(sig), N_SIGNATURES,
                                            replace=False)
    return [e for e in pat if e] + [sig[i] for i in sorted(pick.tolist())]


ENTRIES = oracle_entries()


def oracle_corpora(pattern: str, seed: int):
    """Three seeded corpora: printable noise with the pattern's own text
    (backslashes dropped) planted, a run of its first bytes, and empty."""
    rng = np.random.default_rng(seed)
    frag = pattern.encode("utf-8", "ignore").replace(b"\\", b"")[:12]
    blob = bytearray(rng.integers(32, 127, 160, dtype=np.uint8).tobytes())
    for off in (3, 70, 140):
        blob[off:off + len(frag)] = frag
    return [bytes(blob[:160]), frag[:4] * 8 + b"\n" + frag, b""]


@pytest.mark.parametrize("k", range(len(ENTRIES)))
def test_oracles_equal_reference(k):
    pid, pat, flags = ENTRIES[k]
    try:
        want_node = ref_parse(pat, flags)
    except Exception as e:  # the port must refuse it the same way
        with pytest.raises(Exception) as got:
            port_parse(pat, flags)
        assert type(got.value).__name__ == type(e).__name__
        return
    node = port_parse(pat, flags)
    for data in oracle_corpora(pat, pid):
        assert oracle.ast_match_ends(node, data) == \
            ref_oracle.ast_match_ends(want_node, data), (pat, data)
        assert oracle.ast_leftmost_som(node, data) == \
            ref_oracle.ast_leftmost_som(want_node, data), (pat, data)
        assert oracle.re_match_ends(pat, flags, data) == \
            ref_oracle.re_match_ends(pat, flags, data), (pat, data)
        assert oracle.re_leftmost_som(pat, flags, data) == \
            ref_oracle.re_leftmost_som(pat, flags, data), (pat, data)


def test_nfa_oracle_equals_reference():
    from hyperscan_tpu.compiler.glushkov import build_nfa as ref_build
    from hyperscan_tpu_torch.compiler.glushkov import build_nfa

    for pid, pat, flags in ENTRIES[:7]:
        for data in oracle_corpora(pat, pid):
            assert oracle.nfa_match_ends(
                build_nfa(port_parse(pat, flags)), data) == \
                ref_oracle.nfa_match_ends(
                    ref_build(ref_parse(pat, flags)), data), (pat, data)


@pytest.mark.parametrize("seed", [0, 1, 99])
def test_fuzz_patterns_and_corpora_equal_reference(seed):
    rng, ref_rng = (np.random.default_rng(seed),
                    np.random.default_rng(seed))
    pats = [fuzz.gen_pattern(rng) for _ in range(200)]
    assert pats == [ref_fuzz.gen_pattern(ref_rng) for _ in range(200)]
    frags = [p.encode("latin-1", "ignore")[:6] for p in pats[:8]]
    assert [fuzz.gen_corpus(rng, frags) for _ in range(20)] == \
        [ref_fuzz.gen_corpus(ref_rng, frags) for _ in range(20)]


@pytest.fixture()
def uploads(monkeypatch):
    """Counts the device branch's corpus uploads."""
    seen = []
    real = T.corpus_tensor
    monkeypatch.setattr(T, "corpus_tensor",
                        lambda *a, **k: seen.append(1) or real(*a, **k))
    return seen


def test_fuzz_round_on_device_branch(uploads):
    rng = np.random.default_rng(99)
    assert fuzz.fuzz_round(rng, 5, 4, device="cpu") == []
    assert uploads, "no scan took the device branch"


@pytest.fixture()
def patfile(tmp_path):
    p = tmp_path / "pats.txt"
    p.write_text(PATFILE)
    return str(p)


def test_hscollider_consistent_on_device_branch(patfile, capsys, uploads):
    assert hscollider.main([patfile, "--seed", "3", "--device", "cpu"]) == 0
    assert "all consistent" in capsys.readouterr().out
    assert uploads, "no scan took the device branch"


def test_timed_collider_run(patfile, capsys):
    """tools_torch_collider.py: the collider's result and its time by
    bucket; the collider's module is left as it was."""
    import tools_torch_collider

    hs_before = hscollider.hs
    assert tools_torch_collider.main(
        [patfile, "--seed", "3", "--device", "cpu", "--every", "0"]) == 0
    out = capsys.readouterr().out
    assert "all consistent" in out and "progress [cpu]" in out
    done = [l for l in out.splitlines() if "done rc=0 [cpu]" in l]
    buckets = json.loads(done[0].split("[cpu] ", 1)[1])
    assert buckets["corpora"][0] == 8 and buckets["compile_on_device"][0] > 3
    assert buckets["scan"][0] > 0 and buckets["ast_match_ends"][0] > 0
    assert hscollider.hs is hs_before
    assert hscollider.compile_on_device.__name__ == "compile_on_device"


def test_tools_refuse_a_missing_card(patfile):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        hscollider.main([patfile, "--device", "cuda"])
    with pytest.raises(RuntimeError, match="cuda"):
        fuzz.main(["--rounds", "1", "--device", "cuda"])


def dump_text(mod, argv, capsys):
    assert mod.main(argv) == 0
    # the Info line names the platform and the target device
    return [l for l in capsys.readouterr().out.splitlines()
            if not l.startswith("Info: ")]


@pytest.mark.parametrize("extra", [[], ["--mode", "stream"], ["--dot"]])
def test_hsdump_equals_reference(patfile, capsys, extra):
    got = dump_text(hsdump, [patfile] + extra, capsys)
    want = dump_text(ref_hsdump, [patfile] + extra, capsys)
    assert got == want and len(got) > 5


def test_tools_and_chimera_import_without_jax():
    code = ("import sys; sys.modules['jax'] = None;"
            "sys.modules['hyperscan_tpu'] = None;"
            "import hyperscan_tpu_torch.chimera,"
            " hyperscan_tpu_torch.utils.oracle,"
            " hyperscan_tpu_torch.tools.hscollider,"
            " hyperscan_tpu_torch.tools.fuzz,"
            " hyperscan_tpu_torch.tools.hsdump;"
            "import tools_torch_bench, tools_torch_diff_device_host,"
            " tools_torch_collider, hyperscan_tpu_torch.tools.bench")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
