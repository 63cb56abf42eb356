"""The port's Chimera (hyperscan_tpu_torch.chimera) against the JAX
package's (hyperscan_tpu.chimera).

Every case of tests/test_chimera.py runs through both packages: the same
(id, from, to, captured) lists, the same return codes, the same callback
sequences and the same compile errors (with the expression index) for
the PCRE-only constructs. The port's prefilter scans with device="cpu";
below `host_scan_limit` that is the host path, so one more case scans a
buffer above it, where the prefilter goes through the device branch and
the kernels' plain versions.
"""

import numpy as np
import pytest

import hyperscan_tpu.chimera as ref
import hyperscan_tpu_torch.chimera as port
import torch_ref_native  # noqa: F401 (the reference's native build, locked)

from hyperscan_tpu.errors import CompileError as RefCompileError
from hyperscan_tpu_torch.errors import CompileError as PortCompileError


def scan_kw(ch):
    """The port's prefilter scans on the CPU; the reference takes no
    device."""
    return {"device": "cpu"} if ch is port else {}


def collect(ch, db, data, **kw):
    out = []
    rc = ch.ch_scan(db, data, matches=out, **scan_kw(ch), **kw)
    return rc, out


def compile_error(ch, fn):
    """(raised, expression index) of a compile call."""
    err = (PortCompileError if ch is port else RefCompileError)
    try:
        fn()
    except err as e:
        return True, getattr(e, "expression", None)
    return False, None


def case_basic_capture_groups(ch):
    db = ch.ch_compile(r"(\w+)@(\w+)\.com", mode=ch.CH_MODE_GROUPS)
    return collect(ch, db, b"mail me at bob@example.com please")


def case_backreference_and_lookahead(ch):
    db = ch.ch_compile_multi([r"(foo|bar)\1", r"\d+(?= dollars)"],
                             ids=[7, 8])
    return collect(ch, db, b"xx foofoo and 25 dollars")


def case_nogroups_mode(ch):
    db = ch.ch_compile(r"(a)(b)c", mode=ch.CH_MODE_NOGROUPS)
    return collect(ch, db, b"xxabcxx")


def case_inactive_group(ch):
    return collect(ch, ch.ch_compile(r"(a)|(b)"), b"b")


def case_callback_terminate_and_skip(ch):
    db = ch.ch_compile_multi([r"a", r"b"], ids=[1, 2])
    seen = []
    res = []
    for ret in (ch.CH_CALLBACK_TERMINATE, ch.CH_CALLBACK_SKIP_PATTERN,
                ch.CH_CALLBACK_CONTINUE):
        seen.clear()

        def cb(id_, frm, to, flags, caps, ret=ret):
            seen.append((id_, frm, to, flags, caps))
            return ret

        rc = ch.ch_scan(db, b"aa bb", on_match=cb, **scan_kw(ch))
        res.append((rc, list(seen)))
    return res


def case_singlematch_flag(ch):
    db = ch.ch_compile(r"a", flags=ch.CH_FLAG_SINGLEMATCH)
    return collect(ch, db, b"aaa")


def case_caseless_multiline_dotall(ch):
    db = ch.ch_compile_multi(
        [r"^foo", r"a.b"],
        flags=[ch.CH_FLAG_CASELESS | ch.CH_FLAG_MULTILINE,
               ch.CH_FLAG_DOTALL],
        ids=[1, 2])
    return collect(ch, db, b"x\nFOO a\nb")


def case_utf8_byte_offsets(ch):
    db = ch.ch_compile(r"(\w+)é", flags=ch.CH_FLAG_UTF8 | ch.CH_FLAG_UCP)
    return collect(ch, db, "x cafés rock".encode("utf-8"))


def case_invalid_utf8_no_match(ch):
    db = ch.ch_compile(r"a", flags=ch.CH_FLAG_UTF8)
    return collect(ch, db, b"\xff\xfea")


def case_prefilter_split(ch):
    db = ch.ch_compile_multi([r"foo\d+", r"(x)\1"], ids=[1, 2])
    return (db.prefilter_db is not None, db.prefilter_ids,
            [p.always_confirm for p in db.patterns],
            collect(ch, db, b"foo12 xx"))


def case_match_limit(ch):
    db = ch.ch_compile_ext_multi([r"a"], match_limit=3)
    errors = []
    rc, out = collect(ch, db, b"a" * 10,
                      on_error=lambda code, pid: errors.append((code, pid)))
    return rc, out, errors


def case_compile_error(ch):
    return compile_error(
        ch, lambda: ch.ch_compile_multi([r"ok", r"(unclosed"], ids=[1, 2]))


def case_bad_mode_and_bad_data(ch):
    bad_mode = compile_error(ch, lambda: ch.ch_compile(r"a", mode=12345))
    bad_flags = compile_error(ch, lambda: ch.ch_compile(r"a", flags=1 << 20))
    db = ch.ch_compile(r"a")
    return bad_mode, bad_flags, ch.ch_scan(db, 42, **scan_kw(ch))


def case_pcre_end_anchor_translation(ch):
    db = ch.ch_compile_multi([r"foo\Z", r"bar\z"], ids=[1, 2])
    return collect(ch, db, b"foo\n"), collect(ch, db, b"bar")


def case_supported_subset_captures(ch):
    cases = [
        (r"(\w+)=(\w+);\1", b"k=v;k rest"),
        (r"(?=ab)a(b)", b"zab"),
        (r"(?<=x)(y+)", b"axyyy"),
        (r"(?>a+)(b)", b"aaab"),
        (r"(a)(?(1)x|y)", b"zax"),
    ]
    return [collect(ch, ch.ch_compile(p, mode=ch.CH_MODE_GROUPS), d)
            for (p, d) in cases]


def case_constants(ch):
    names = sorted(n for n in dir(ref) if n.startswith("CH_"))
    return [(n, getattr(ch, n)) for n in names]


CASES = {name[len("case_"):]: fn for name, fn in globals().items()
         if name.startswith("case_")}


@pytest.mark.parametrize("name", sorted(CASES))
def test_chimera_case_equals_reference(name):
    assert CASES[name](port) == CASES[name](ref)


UNSUPPORTED_PCRE = [
    r"(?R)",              # recursion
    r"a(?1)b(x)",         # subroutine call
    r"a(?C1)b",           # callout
    r"a(*SKIP)b",         # backtracking verb
    r"a(*FAIL)",          # backtracking verb
    r"foo\Kbar",          # match-start reset
]


@pytest.mark.parametrize("pat", UNSUPPORTED_PCRE)
def test_rejects_pcre_only_as_reference(pat):
    got = compile_error(
        port, lambda: port.ch_compile_multi(["ok1", pat], ids=[1, 2]))
    want = compile_error(
        ref, lambda: ref.ch_compile_multi(["ok1", pat], ids=[1, 2]))
    assert got == want and got[0]


def test_large_buffer_prefilter_on_device_branch(monkeypatch):
    """A buffer above `host_scan_limit` (128 KiB): the port's prefilter
    takes the device branch (the corpus upload is counted) and runs the
    literal kernels' plain versions on the CPU; the matches equal the
    reference's."""
    from hyperscan_tpu_torch.ops import teddy as T

    rng = np.random.default_rng(5)
    buf = bytearray(rng.integers(32, 127, 200_000, dtype=np.uint8).tobytes())
    for off in range(1000, 199_000, 9973):
        buf[off:off + 24] = b"user bob@example.com ok "
    buf[150_000:150_009] = b"attack123"
    buf = bytes(buf)
    pats = [r"(\w+)@(\w+)\.com", r"attack(\d+)", r"(foo|bar)\1"]
    uploads = []
    real = T.corpus_tensor
    monkeypatch.setattr(T, "corpus_tensor",
                        lambda *a, **k: uploads.append(1) or real(*a, **k))
    pdb = port.ch_compile_multi(pats, ids=[1, 2, 3])
    assert len(buf) > pdb.prefilter_db.host_scan_limit
    assert pdb.prefilter_db.lit is not None
    got = collect(port, pdb, buf)
    assert uploads, "the prefilter scan did not take the device branch"
    want = collect(ref, ref.ch_compile_multi(pats, ids=[1, 2, 3]), buf)
    assert got == want
    assert got[0] == port.CH_SUCCESS and len(got[1]) == 21
