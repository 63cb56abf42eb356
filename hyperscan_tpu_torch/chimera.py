"""Chimera analogue: hybrid PCRE-semantics engine with capture groups.

Reference: chimera/ (ch_compile.cpp, ch_runtime.c, ch_runtime.h:119,204).
The reference layers libpcre on Hyperscan: patterns are compiled into a
Hyperscan prefilter database plus per-pattern PCRE programs; at scan time
the prefilter identifies which patterns *may* occur, and only those are
confirmed (with capture extraction) by PCRE.

The port's copy of `hyperscan_tpu.chimera`. The split: the prefilter is
a normal `hyperscan_tpu_torch` database compiled with HS_FLAG_PREFILTER +
HS_FLAG_SINGLEMATCH, scanned by `runtime.scan.scan_block` on the torch
device that `ch_scan` is given (the CUDA card by default; above the
database's `host_scan_limit` its bulk scan runs on the card's Teddy,
DFA and bit-NFA kernels); confirmation uses Python's `re`
module as the PCRE stand-in (it supports the constructs the main engine
rejects: backreferences, lookaround, atomic groups, possessives) and
reports capture groups. Patterns whose prefilter over-approximation
cannot be compiled are placed in an always-confirm set, mirroring
ch_compile.cpp's handling of pure-PCRE patterns.

Match callback signature (reference ch_match_event_handler,
chimera/ch_runtime.h:119): on_match(id, frm, to, flags, captured) where
`captured` is a list of (flags, frm, to) per capture group (group 0 =
whole match; flags bit 0 = CH_CAPTURE_FLAG_ACTIVE) in CH_MODE_GROUPS, or
None in CH_MODE_NOGROUPS. Returning CH_CALLBACK_TERMINATE stops the scan
(ch_scan returns CH_SCAN_TERMINATED), CH_CALLBACK_SKIP_PATTERN stops
further matches for that pattern.

Semantics notes (as in the reference): matches are PCRE "global match"
style — leftmost, non-overlapping per pattern — not the main engine's
all-match-ends semantics. Ordering across patterns is by pattern order,
as in ch_runtime.c's per-hit confirm loop; within a pattern, by offset.

PCRE-semantics boundary (the confirm engine is Python `re`, not real
libpcre — the supported subset differs; unsupported constructs raise
CompileError with the expression index, the CH_COMPILER_ERROR analogue):

SUPPORTED beyond the main engine: backreferences (\\1, (?P=name)),
lookahead/lookbehind (fixed-width behind), atomic groups (?>...),
possessive quantifiers (a++, Python >= 3.11), conditional references
(?(1)yes|no), named groups, inline flag regions (?i:...).

NOT supported (real libpcre accepts these; `ch_compile` rejects them):
recursion (?R) / subroutine calls (?1) (?&name), callouts (?C...),
backtracking control verbs (*SKIP) (*PRUNE) (*THEN) (*COMMIT) (*FAIL)
(*ACCEPT), \\K match-start reset, variable-width lookbehind, \\cX outside
the main parser's range, and PCRE-specific escapes Python re lacks
(\\R, \\N{...} differences aside). Reference: ch_compile.cpp accepts
anything libpcre compiles; this stand-in accepts anything Python `re`
compiles — the split logic (hyperscan-able vs confirm-only) is the same.
"""
from __future__ import annotations

import re as _re
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from .errors import CompileError
from .flags import (
    HS_FLAG_CASELESS,
    HS_FLAG_DOTALL,
    HS_FLAG_MULTILINE,
    HS_FLAG_PREFILTER,
    HS_FLAG_SINGLEMATCH,
    HS_FLAG_UCP,
    HS_FLAG_UTF8,
    HS_MODE_BLOCK,
)

# ---- public constants (reference: chimera/ch_common.h, ch_compile.h) ----

CH_FLAG_CASELESS = 1
CH_FLAG_DOTALL = 2
CH_FLAG_MULTILINE = 4
CH_FLAG_SINGLEMATCH = 8
CH_FLAG_UTF8 = 32
CH_FLAG_UCP = 64

CH_MODE_NOGROUPS = 0
CH_MODE_GROUPS = 1048576  # chimera/ch_compile.h CH_MODE_GROUPS

CH_SUCCESS = 0
CH_INVALID = -1
CH_NOMEM = -2
CH_SCAN_TERMINATED = -3
CH_COMPILER_ERROR = -4
CH_DB_MODE_ERROR = -7
CH_BAD_ALIGN = -8

CH_CALLBACK_CONTINUE = 0
CH_CALLBACK_TERMINATE = 1
CH_CALLBACK_SKIP_PATTERN = 2

CH_ERROR_MATCHLIMIT = 1
CH_ERROR_RECURSIONLIMIT = 2

CH_CAPTURE_FLAG_INACTIVE = 0
CH_CAPTURE_FLAG_ACTIVE = 1

_ALL_CH_FLAGS = (
    CH_FLAG_CASELESS | CH_FLAG_DOTALL | CH_FLAG_MULTILINE
    | CH_FLAG_SINGLEMATCH | CH_FLAG_UTF8 | CH_FLAG_UCP
)

_DEFAULT_MATCH_LIMIT = 10000000  # chimera/ch_compile.h match_limit default


def _to_python_re(expr: str, utf8: bool) -> str:
    """Minimal PCRE→Python-re syntax bridge for the confirm step.

    Python 3.11+ covers atomic groups and possessive quantifiers
    natively; the remaining deltas handled here are \\z / \\Z end
    anchors and \\x{...} codepoint escapes.
    """
    out: List[str] = []
    i, n = 0, len(expr)
    while i < n:
        c = expr[i]
        if c == "\\" and i + 1 < n:
            d = expr[i + 1]
            if d == "z":  # PCRE \z (absolute end) == Python \Z
                out.append(r"\Z")
                i += 2
                continue
            if d == "Z":  # PCRE \Z: end or before final newline
                out.append(r"(?=\n\Z|\Z)")
                i += 2
                continue
            if d == "x" and i + 2 < n and expr[i + 2] == "{":
                j = expr.find("}", i + 3)
                if j < 0:
                    raise CompileError("unterminated \\x{", -1)
                cp = int(expr[i + 3:j] or "0", 16)
                if utf8:
                    out.append("\\u%04x" % cp if cp <= 0xFFFF
                               else "\\U%08x" % cp)
                elif cp <= 0xFF:
                    out.append("\\x%02x" % cp)
                else:
                    raise CompileError(
                        "\\x{> \\xFF} requires CH_FLAG_UTF8", -1)
                i = j + 1
                continue
            out.append(expr[i:i + 2])
            i += 2
            continue
        out.append(c)
        i += 1
    return "".join(out)


@dataclass
class _ChPattern:
    external_id: int
    regex: object            # compiled re (bytes or str program)
    utf8: bool
    singlematch: bool
    always_confirm: bool     # no usable prefilter: confirm every scan


@dataclass
class ChDatabase:
    """reference: ch_database_t (chimera/ch_database.h)."""

    patterns: List[_ChPattern]
    prefilter_db: Optional[object]  # hyperscan_tpu_torch Database or None
    prefilter_ids: List[int] = field(default_factory=list)  # idx by pf id
    mode: int = CH_MODE_GROUPS
    match_limit: int = _DEFAULT_MATCH_LIMIT

    def info(self) -> str:
        return "Chimera Version: %s Features: prefilter+re" % (
            __import__("hyperscan_tpu_torch").__version__,
        )

    def size(self) -> int:
        import sys

        base = sum(sys.getsizeof(p.regex.pattern) for p in self.patterns)
        if self.prefilter_db is not None:
            base += self.prefilter_db.size()
        return base


def ch_compile(expression: str, flags: int = 0,
               mode: int = CH_MODE_GROUPS) -> ChDatabase:
    """reference: ch_compile (chimera/ch_compile.cpp)."""
    return ch_compile_multi([expression], [flags], [0], mode)


def ch_compile_multi(expressions: Sequence[str],
                     flags: Optional[Sequence[int]] = None,
                     ids: Optional[Sequence[int]] = None,
                     mode: int = CH_MODE_GROUPS) -> ChDatabase:
    """reference: ch_compile_multi (chimera/ch_compile.cpp)."""
    return ch_compile_ext_multi(expressions, flags, ids, mode)


def ch_compile_ext_multi(expressions: Sequence[str],
                         flags: Optional[Sequence[int]] = None,
                         ids: Optional[Sequence[int]] = None,
                         mode: int = CH_MODE_GROUPS,
                         match_limit: int = _DEFAULT_MATCH_LIMIT,
                         match_limit_recursion: int = 0) -> ChDatabase:
    """reference: ch_compile_ext_multi (chimera/ch_compile.cpp); the
    match_limit caps per-pattern confirm iterations per scan (the
    libpcre match_limit analogue)."""
    n = len(expressions)
    flags = list(flags) if flags is not None else [0] * n
    ids = list(ids) if ids is not None else [0] * n
    if not (len(flags) == len(ids) == n):
        raise CompileError("expressions/flags/ids length mismatch", -1)
    if mode not in (CH_MODE_NOGROUPS, CH_MODE_GROUPS):
        raise CompileError("invalid chimera mode", -1)

    pats: List[_ChPattern] = []
    pf_exprs: List[str] = []
    pf_flags: List[int] = []
    pf_idx: List[int] = []
    for i, expr in enumerate(expressions):
        f = flags[i]
        if f & ~_ALL_CH_FLAGS:
            raise CompileError("invalid chimera flags", i)
        utf8 = bool(f & CH_FLAG_UTF8)
        refl = 0
        if f & CH_FLAG_CASELESS:
            refl |= _re.IGNORECASE
        if f & CH_FLAG_DOTALL:
            refl |= _re.DOTALL
        if f & CH_FLAG_MULTILINE:
            refl |= _re.MULTILINE
        try:
            py = _to_python_re(str(expr), utf8)
            prog = _re.compile(py if utf8 else py.encode("latin-1"), refl)
        except (_re.error, UnicodeEncodeError, CompileError) as exc:
            raise CompileError("chimera confirm compile: %s" % exc, i)

        hs_f = HS_FLAG_PREFILTER | HS_FLAG_SINGLEMATCH
        if f & CH_FLAG_CASELESS:
            hs_f |= HS_FLAG_CASELESS
        if f & CH_FLAG_DOTALL:
            hs_f |= HS_FLAG_DOTALL
        if f & CH_FLAG_MULTILINE:
            hs_f |= HS_FLAG_MULTILINE
        if f & CH_FLAG_UTF8:
            hs_f |= HS_FLAG_UTF8
        if f & CH_FLAG_UCP:
            hs_f |= HS_FLAG_UCP
        pats.append(_ChPattern(
            external_id=ids[i], regex=prog, utf8=utf8,
            singlematch=bool(f & CH_FLAG_SINGLEMATCH),
            always_confirm=True,
        ))
        pf_exprs.append(str(expr))
        pf_flags.append(hs_f)
        pf_idx.append(i)

    # Build the prefilter database over whichever patterns the main
    # engine can over-approximate; the rest stay always-confirm
    # (reference: ch_compile.cpp splits hyperscan-able vs PCRE-only).
    from .database import compile_patterns

    prefilter_db = None
    kept_idx: List[int] = []
    exprs, fl, idx = list(pf_exprs), list(pf_flags), list(pf_idx)
    while exprs:
        try:
            prefilter_db = compile_patterns(
                exprs, flags=fl, ids=list(range(len(exprs))),
                mode=HS_MODE_BLOCK,
            )
            kept_idx = idx
            break
        except CompileError as exc:
            at = getattr(exc, "expression", None)
            if at is None or not (0 <= at < len(exprs)):
                break  # no usable prefilter at all
            del exprs[at], fl[at], idx[at]
    for i in kept_idx:
        pats[i].always_confirm = False
    return ChDatabase(patterns=pats, prefilter_db=prefilter_db,
                      prefilter_ids=kept_idx, mode=mode,
                      match_limit=match_limit or _DEFAULT_MATCH_LIMIT)


def _byte_offsets(text: str, data: bytes) -> np.ndarray:
    """Cumulative byte offset of each codepoint boundary (UTF-8 confirm
    runs over str; reported offsets must be byte offsets into data)."""
    lens = np.frombuffer(data, dtype=np.uint8)
    # count UTF-8 lead bytes: positions where (b & 0xC0) != 0x80
    leads = np.flatnonzero((lens & 0xC0) != 0x80)
    return np.append(leads, len(data)).astype(np.int64)


def ch_scan(db: ChDatabase, data: bytes, flags: int = 0,
            scratch: object = None,
            on_match: Optional[Callable] = None,
            on_error: Optional[Callable] = None,
            matches: Optional[List] = None, device="cuda") -> int:
    """reference: ch_scan (chimera/ch_runtime.c). Returns CH_SUCCESS or
    CH_SCAN_TERMINATED. If `on_match` is None, (id, frm, to, captured)
    tuples are appended to `matches` (convenience, as hs-level scan).
    The prefilter scans on `device`, the card unless the caller passes
    another (a missing card raises); the confirm runs on the host."""
    if not isinstance(data, (bytes, bytearray, memoryview)):
        return CH_INVALID
    data = bytes(data)

    # Prefilter pass: which patterns might occur? (ch_runtime.c runs the
    # hyperscan scan and confirms per hit; we batch per-pattern since the
    # confirm step is a full leftmost sweep anyway.)
    live = [i for i, p in enumerate(db.patterns) if p.always_confirm]
    if db.prefilter_db is not None and db.prefilter_ids:
        from .runtime.scan import scan_block

        hits, _term = scan_block(db.prefilter_db, data, device=device)
        seen = {int(t[0]) for t in hits}
        live.extend(db.prefilter_ids[k] for k in sorted(seen))
        live.sort()

    out = matches if matches is not None else []
    for i in live:
        p = db.patterns[i]
        if p.utf8:
            try:
                subject = data.decode("utf-8")
            except UnicodeDecodeError:
                continue  # invalid UTF-8: pattern cannot match
            boundaries = _byte_offsets(subject, data)
        else:
            subject = data
            boundaries = None

        def _b(off: int) -> int:
            return int(boundaries[off]) if boundaries is not None else off

        count = 0
        for m in p.regex.finditer(subject):
            count += 1
            if count > db.match_limit:
                if on_error is not None:
                    on_error(CH_ERROR_MATCHLIMIT, p.external_id)
                break
            captured = None
            if db.mode == CH_MODE_GROUPS:
                captured = []
                for gi in range(p.regex.groups + 1):
                    s, e = m.span(gi)
                    if s < 0:
                        captured.append((CH_CAPTURE_FLAG_INACTIVE, 0, 0))
                    else:
                        captured.append(
                            (CH_CAPTURE_FLAG_ACTIVE, _b(s), _b(e)))
            frm, to = _b(m.start()), _b(m.end())
            if on_match is not None:
                rc = on_match(p.external_id, frm, to, 0, captured)
                if rc == CH_CALLBACK_TERMINATE:
                    return CH_SCAN_TERMINATED
                if rc == CH_CALLBACK_SKIP_PATTERN:
                    break
            else:
                out.append((p.external_id, frm, to, captured))
            if p.singlematch:
                break
    return CH_SUCCESS


# C-style aliases (reference: chimera/ch_runtime.h, ch_database.h)
ch_database_info = ChDatabase.info
ch_database_size = ChDatabase.size
