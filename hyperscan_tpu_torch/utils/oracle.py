"""Ground-truth matchers for differential testing.

Analogue of the reference's conformance oracles:
- ``ast_match_ends``: direct interpretation of the parsed AST with true
  zero-width assertion semantics — plays the role of PCRE ground truth
  (reference: tools/hscollider/GroundTruth.cpp)
- ``nfa_match_ends``: simulation of the compiled NFAGraph — plays the role
  of the graph NFA simulation (reference: tools/hscollider/GraphTruth.cpp
  via src/nfagraph/ng_execute.cpp)

Both return the set of match records the engine must reproduce:
Hyperscan reports *every* end offset at which a match ends ("automata
semantics"), deduped per (id, to).
"""

from __future__ import annotations

from typing import Dict, FrozenSet, Set, Tuple

from ..compiler.ast import (
    A_BOS,
    A_EOS,
    A_EOS_NL,
    A_MLINE_BOS,
    A_MLINE_EOS,
    A_NWORDB,
    A_UNWORDB,
    A_UNWORDB8,
    A_UWORDB,
    A_UWORDB8,
    A_WORDB,
    Alt,
    Anchor,
    Empty,
    Node,
    Pos,
    Rep,
    Seq,
)
from ..compiler.charclass import WORD
from ..compiler.glushkov import NFAGraph

_WORD_BITS = WORD.bits


def _is_word(data: bytes, i: int) -> bool:
    return 0 <= i < len(data) and bool(_WORD_BITS[data[i]])


def _is_uword_byte(data: bytes, i: int) -> bool:
    """UCP word-ness of a byte codepoint (UCP without UTF8: Latin-1)."""
    from ..compiler.ucp import is_word_cp

    return 0 <= i < len(data) and is_word_cp(data[i])


def _decode_cp_at(data: bytes, i: int):
    """Decode the UTF-8 codepoint starting at i; None if invalid/oob."""
    n = len(data)
    if not (0 <= i < n):
        return None
    b0 = data[i]
    if b0 < 0x80:
        return b0
    if b0 < 0xC2:
        return None
    if b0 < 0xE0:
        ln, cp, lo = 2, b0 & 0x1F, 0x80
    elif b0 < 0xF0:
        ln, cp, lo = 3, b0 & 0x0F, 0x800
    elif b0 < 0xF5:
        ln, cp, lo = 4, b0 & 0x07, 0x10000
    else:
        return None
    if i + ln > n:
        return None
    for k in range(1, ln):
        b = data[i + k]
        if (b & 0xC0) != 0x80:
            return None
        cp = (cp << 6) | (b & 0x3F)
    if cp < lo or (0xD800 <= cp <= 0xDFFF) or cp > 0x10FFFF:
        return None
    return cp


def _decode_cp_before(data: bytes, pos: int):
    """Decode the UTF-8 codepoint ending at pos-1; None if none/invalid."""
    j = pos - 1
    while j >= 0 and pos - j < 4 and (data[j] & 0xC0) == 0x80:
        j -= 1
    if j < 0:
        return None
    cp = _decode_cp_at(data, j)
    # must end exactly at pos (reject mid-codepoint boundaries)
    if cp is None:
        return None
    ln = 1 if cp < 0x80 else 2 if cp < 0x800 else 3 if cp < 0x10000 else 4
    if j + ln != pos:
        return None
    return cp


def _is_uword_utf8(data: bytes, pos: int, before: bool) -> bool:
    from ..compiler.ucp import is_word_cp

    cp = _decode_cp_before(data, pos) if before else _decode_cp_at(data, pos)
    return cp is not None and is_word_cp(cp)


def _assert_holds(kind: str, data: bytes, pos: int) -> bool:
    n = len(data)
    if kind == A_BOS:
        return pos == 0
    if kind == A_MLINE_BOS:
        return pos == 0 or data[pos - 1] == 0x0A
    if kind == A_EOS:
        return pos == n
    if kind == A_EOS_NL:  # $, \Z: at end, or before a final \n
        return pos == n or (pos == n - 1 and data[pos] == 0x0A)
    if kind == A_MLINE_EOS:  # before any \n, or at end
        return pos == n or data[pos] == 0x0A
    if kind == A_WORDB:
        return _is_word(data, pos - 1) != _is_word(data, pos)
    if kind == A_NWORDB:
        return _is_word(data, pos - 1) == _is_word(data, pos)
    if kind == A_UWORDB8:
        return _is_uword_byte(data, pos - 1) != _is_uword_byte(data, pos)
    if kind == A_UNWORDB8:
        return _is_uword_byte(data, pos - 1) == _is_uword_byte(data, pos)
    if kind in (A_UWORDB, A_UNWORDB):
        # UTF-8 word boundaries are only tested at codepoint boundaries
        # (PCRE UTF semantics advance by characters, never mid-codepoint)
        if 0 < pos < n and (data[pos] & 0xC0) == 0x80:
            return False
        same = (_is_uword_utf8(data, pos, True)
                == _is_uword_utf8(data, pos, False))
        return same if kind == A_UNWORDB else not same
    raise ValueError(kind)


def _ends(node: Node, data: bytes, start: int, memo) -> FrozenSet[int]:
    """All positions reachable by matching `node` beginning at `start`."""
    key = (id(node), start)
    hit = memo.get(key)
    if hit is not None:
        return hit
    memo[key] = frozenset()  # cycle guard (Rep of nullable child)
    if isinstance(node, Empty):
        out = frozenset([start])
    elif isinstance(node, Pos):
        if start < len(data) and bool(node.cr.bits[data[start]]):
            out = frozenset([start + 1])
        else:
            out = frozenset()
    elif isinstance(node, Anchor):
        out = frozenset([start]) if _assert_holds(node.kind, data, start) else frozenset()
    elif isinstance(node, Seq):
        cur = {start}
        for child in node.children:
            nxt: Set[int] = set()
            for p in cur:
                nxt |= _ends(child, data, p, memo)
            cur = nxt
            if not cur:
                break
        out = frozenset(cur)
    elif isinstance(node, Alt):
        acc: Set[int] = set()
        for child in node.children:
            acc |= _ends(child, data, start, memo)
        out = frozenset(acc)
    else:
        assert isinstance(node, Rep)
        lo, hi = node.lo, node.hi
        # mandatory part
        cur = {start}
        for _ in range(lo):
            nxt: Set[int] = set()
            for p in cur:
                nxt |= _ends(node.child, data, p, memo)
            cur = nxt
            if not cur:
                break
        acc = set(cur)
        # optional part: closure (bounded by hi or by fixpoint)
        frontier = set(cur)
        count = lo
        while frontier and (hi is None or count < hi):
            nxt = set()
            for p in frontier:
                nxt |= _ends(node.child, data, p, memo)
            new = nxt - acc
            acc |= new
            frontier = new if hi is None else nxt
            count += 1
            if hi is None and not new:
                break
        out = frozenset(acc)
    memo[key] = out
    return out


def ast_match_ends(node: Node, data: bytes) -> Set[int]:
    """Hyperscan-semantics match ends: every offset `e` such that some
    substring data[s:e] (any s ≤ e) matches the pattern."""
    memo: Dict = {}
    ends: Set[int] = set()
    for s in range(len(data) + 1):
        ends |= _ends(node, data, s, memo)
    return ends


def ast_leftmost_som(node: Node, data: bytes) -> Dict[int, int]:
    """SOM ground truth: end offset → leftmost start offset over all
    matches ending there (reference: HS_FLAG_SOM_LEFTMOST semantics,
    src/hs_compile.h:963-1005)."""
    memo: Dict = {}
    out: Dict[int, int] = {}
    for s in range(len(data) + 1):
        for e in _ends(node, data, s, memo):
            out.setdefault(e, s)  # ascending s → first recorded is leftmost
    return out


def nfa_match_ends(g: NFAGraph, data: bytes) -> Set[int]:
    """Simulate the position NFA; return the set of match end offsets."""
    n = len(data)
    ends: Set[int] = set()

    # empty-match accepts
    for (anchored, eod, adj) in g.start_accepts:
        if anchored and eod:
            if n == 0:
                ends.add(adj)
        elif anchored:
            ends.add(adj)
        elif eod:
            ends.add(n + adj)
        else:
            for e in range(n + 1):
                ends.add(e + adj)

    active: Set[int] = set()
    for i in range(n):
        byte = data[i]
        nxt: Set[int] = set()
        for u in active:
            for v in g.follow[u]:
                if g.reach[v, byte]:
                    nxt.add(v)
        firsts = g.float_first if i > 0 else (g.float_first | g.anchored_first)
        for v in firsts:
            if g.reach[v, byte]:
                nxt.add(v)
        active = nxt
        for v in active:
            for adj in g.accept.get(v, ()):
                ends.add(i + 1 + adj)
    for v in active:
        for adj in g.accept_eod.get(v, ()):
            ends.add(n + adj)
    return {e for e in ends if 0 <= e <= n}


# --------------------------------------------------------------------------
# Independent ground truth via Python `re` (reference analogue: PCRE
# GroundTruth, tools/hscollider/GroundTruth.cpp). Unlike the AST/NFA
# oracles above, `re` shares no code with this project, so a
# parser-semantics bug cannot hide in both.
# --------------------------------------------------------------------------

_RE_UNSAFE = ("$", r"\b", r"\B", r"\Z", r"\z", r"\Q", "(?", "[:")


def _re_compile_end(pattern: str, flags: int):
    """Compile `(?:pattern)\\Z` for end-anchored region searches, or None
    when the pattern's semantics don't translate to Python `re` (end
    anchors and word boundaries interact with `re`'s pos/endpos region
    semantics; UTF8/UCP/PREFILTER change the alphabet or the match set)."""
    import re as _re

    from ..flags import (
        HS_FLAG_CASELESS,
        HS_FLAG_DOTALL,
        HS_FLAG_MULTILINE,
        HS_FLAG_PREFILTER,
        HS_FLAG_UCP,
        HS_FLAG_UTF8,
    )

    if flags & (HS_FLAG_UTF8 | HS_FLAG_UCP | HS_FLAG_PREFILTER):
        return None
    if any(tok in pattern for tok in _RE_UNSAFE):
        return None
    refl = 0
    if flags & HS_FLAG_CASELESS:
        refl |= _re.IGNORECASE
    if flags & HS_FLAG_DOTALL:
        refl |= _re.DOTALL
    if flags & HS_FLAG_MULTILINE:
        refl |= _re.MULTILINE
    try:
        return _re.compile(b"(?:" + pattern.encode("latin-1") + b")\\Z",
                           refl)
    except (_re.error, UnicodeEncodeError):
        return None


def re_leftmost_som(pattern: str, flags: int, data: bytes):
    """end offset -> leftmost start per Python `re` (independent PCRE-style
    ground truth; reference: hscollider diffs full (id, from, to)
    ResultSets, tools/hscollider/ResultSet.h). None when untranslatable
    (see _re_compile_end).

    Hyperscan reports every offset at which *some* match ends; `re`
    backtracking yields one match per search, so ends are enumerated by
    ONE `search(data, 0, e)` per candidate end with the pattern wrapped
    in `(?:...)\\Z` — `\\Z` matches at endpos, pinning the match end at
    `e` while `search` scans starts left to right, so the hit's .start()
    IS the leftmost SOM. O(n) C-level search calls (the prior fullmatch
    enumeration was O(n^2) Python-level calls, capping corpora at ~1 KB).
    """
    pat = _re_compile_end(pattern, flags)
    if pat is None:
        return None
    out: Dict[int, int] = {}
    for e in range(len(data) + 1):
        m = pat.search(data, 0, e)
        if m is not None:
            out[e] = m.start()
    return out


def re_match_ends(pattern: str, flags: int, data: bytes):
    """All match-end offsets per Python `re`, or None when untranslatable
    (see _re_compile_end / re_leftmost_som for method and complexity)."""
    pat = _re_compile_end(pattern, flags)
    if pat is None:
        return None
    ends: Set[int] = set()
    for e in range(len(data) + 1):
        if pat.search(data, 0, e) is not None:
            ends.add(e)
    return ends
