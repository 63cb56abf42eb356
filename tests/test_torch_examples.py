"""The port's examples (examples/torch/) against the JAX package's
(examples/*.py): each runs as a subprocess from a temporary directory on
the same small inputs, the port's with --device cpu and the JAX one's
with JAX_PLATFORMS=cpu, all eight at once.

simplegrep, flowscan and massflow must print the same lines. patbench's
lines hang on timings: the pattern count must be equal, and every
pattern it reports must be one of the file's, with the times masked.
"""

import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
PATTERNS = """\
# id:/pattern/flags, as hscheck reads them
1:/attack[0-9]+/
2:/needle/
3:/GET \\/[a-z]+\\.php/
4:/foo.*bar$/m
"""
FLOWS = b"""\
a xx att
b GET /in
a ack12 yy needle
c nee
b dex.php and more
c dle foo then bar
a foo bar
"""


def _inputs(d: pathlib.Path) -> dict:
    """The examples' arguments over inputs written into `d`."""
    (d / "pats.txt").write_text(PATTERNS)
    (d / "flows.txt").write_bytes(FLOWS)
    rng = np.random.default_rng(11)
    blob = bytearray((32 + rng.integers(0, 95, 40_000)).astype(np.uint8))
    for k, w in enumerate([b"attack42", b"needle", b"GET /x.php", b"fobar",
                           b"fooobar"] * 3):
        at = 500 + k * 2_600
        blob[at:at + len(w)] = w
    (d / "corpus.bin").write_bytes(bytes(blob))
    return {"simplegrep": ["fo+bar", "corpus.bin"],
            "flowscan": ["pats.txt", "flows.txt"],
            "patbench": ["pats.txt", "corpus.bin", "--top", "2",
                         "--repeats", "1", "--block-size", "8192"],
            "massflow": ["pats.txt", "64", "4"]}


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    """name -> (JAX example's stdout, port example's stdout), each run
    exiting 0."""
    d = tmp_path_factory.mktemp("examples")
    args = _inputs(d)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
    procs = {}
    for name, a in args.items():
        procs[name] = (
            subprocess.Popen([sys.executable, str(REPO / "examples"
                                                  / f"{name}.py"), *a],
                             cwd=d, env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE),
            subprocess.Popen([sys.executable, str(REPO / "examples" / "torch"
                                                  / f"{name}.py"), *a,
                              "--device", "cpu"],
                             cwd=d, env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE))
    out = {}
    try:
        for name, pair in procs.items():
            got = []
            for p in pair:
                so, se = p.communicate(timeout=120)
                assert p.returncode == 0, (name, p.args, se.decode()[-2000:])
                got.append(so.decode().splitlines())
            out[name] = tuple(got)
    finally:
        for pair in procs.values():
            for p in pair:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    return out


@pytest.mark.parametrize("name", ["simplegrep", "flowscan", "massflow"])
def test_example_prints_the_reference_lines(outputs, name):
    ref, port = outputs[name]
    assert port == ref
    assert ref and " 0 matches" not in f" {ref[-1]}"  # something found


def test_patbench_reports_the_reference_set(outputs):
    ref, port = outputs["patbench"]
    assert len(port) == len(ref) == 3

    def masked(lines):
        return [re.sub(r"[-+]?\d+\.\d+ m?s", "T", ln) for ln in lines]

    assert masked(port)[0] == masked(ref)[0] == "full set: 4 patterns, T"
    ids = {1, 2, 3, 4}
    for ln in port[1:]:
        m = re.match(r"#\d costliest: id (\d+) pattern ", ln)
        assert m and int(m.group(1)) in ids, ln
