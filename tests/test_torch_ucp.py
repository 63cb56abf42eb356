"""UCP through the port against the JAX package: the tests of
tests/test_ucp.py (but for the two property cases, which are in
tests/test_torch_unicode.py), as a body run by torch_parity.parity on
the reference's host route and on both of the port's routes (its host
route, and the device branch forced) on the CPU. Each body keeps the
reference test's own checks (Python `re` with re.UNICODE over the
decoded text) and returns what it saw; the port's must equal the
reference's exactly. A UCP class compiles to a DFA of hundreds of
states in several seconds, in either package."""

import pytest

import torch_ref_native  # noqa: F401 (the reference's native build, locked)
from hyperscan_tpu.compiler import ucp as ref_ucp
from hyperscan_tpu_torch.compiler import ucp as port_ucp
from torch_parity import parity, raises

import test_ucp


def _ends(ms):
    return {t for (_i, _f, t) in ms}


@pytest.mark.parametrize("pat,pypat,data", test_ucp.CASES)
def test_ucp_vs_python_re(pat, pypat, data):
    want = test_ucp._oracle(pypat or pat, data)

    def body(pkg):
        got = pkg.scan(pkg.compile(
            pat, flags=pkg.HS_FLAG_UTF8 | pkg.HS_FLAG_UCP), data)
        assert _ends(got) == want, pat
        return got

    parity(body)


def test_ucp_caseless_unicode_fold():
    def body(pkg):
        got = pkg.scan(pkg.compile("σοφία", flags=pkg.HS_FLAG_UTF8
                                   | pkg.HS_FLAG_UCP | pkg.HS_FLAG_CASELESS),
                       "ΣΟΦΊΑ σοφία".encode())
        assert len(_ends(got)) == 2
        return got

    parity(body)


def test_ucp_without_utf8_clips_to_bytes():
    def body(pkg):
        got = pkg.scan(pkg.compile(r"\w", flags=pkg.HS_FLAG_UCP), b"a\xb5-")
        assert _ends(got) == {1, 2}
        return got

    parity(body)


def test_script_and_special_properties():
    for name in ("Any", "L&", "Greek", "Xan", "Lu", "Nd"):
        assert port_ucp.category_ranges(name) == \
            ref_ucp.category_ranges(name), name
    lamp = port_ucp.category_ranges("L&")
    assert port_ucp.category_ranges("Any")[0][0] == 0
    assert any(lo <= ord("a") <= hi for (lo, hi) in lamp)
    assert not any(lo <= ord("1") <= hi for (lo, hi) in lamp)

    def body(pkg):
        fl = pkg.HS_FLAG_UTF8 | pkg.HS_FLAG_UCP
        greek = pkg.scan(pkg.compile(r"\p{Greek}", flags=fl),
                         "λ".encode("utf-8"))
        assert greek == [(0, 0, 2)]
        xan = pkg.scan(pkg.compile(r"\p{Xan}+", flags=fl), b"a1!")
        assert _ends(xan) == {1, 2}
        ucp = port_ucp if pkg.port else ref_ucp
        err = raises(pkg, ucp.category_ranges, "NotAProperty")
        assert err == "CompileError"
        return greek, xan, err

    parity(body)
