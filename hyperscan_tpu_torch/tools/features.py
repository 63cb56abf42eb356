"""The feature surface at size: one small database per feature class of
the reference's tests (logical combinations with QUIET sub-expressions,
extended parameters, SINGLEMATCH, the anchored families, edit and
Hamming distance, UTF-8, UTF-8|UCP, bit-NFA blow-ups, ALLOWEMPTY through
the range API), each scanned over a planted corpus made on the host from
a seed, and held to the port's host route and to its plants.

`chip_smoke.py` phase 7 runs `run_feature` for every feature on the
card at full width (a 256 MiB corpus, a StreamSet of 4,096 streams x 8
KiB x 6 rounds); `tests/test_torch_feature_tool.py` runs it on the CPU
at a small size. Every check raises RuntimeError when it fails.

Each feature plants one string (two spaces each side, so no match
reaches past it) at fixed offsets, none across a block's end. The
matches of each block are exactly those of its plants, each plant's
those of the plant scanned alone, moved to its offset: the block's first
plant as scanned first, every later one as scanned after a first copy
(a combination's sub-expressions are then already seen, a SINGLEMATCH
id already reported). To these come the feature's own rules: the purely
negative combinations report at each block's end, and the offset bounds
of `ext` keep a match only where its end in the block is inside them.
The ranges feature scans its corpus as one block: its point matches are
exactly the planted needles, and its x* ranges cover every offset once.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

import hyperscan_tpu_torch as ht
from hyperscan_tpu_torch.database import Database, compile_patterns
from hyperscan_tpu_torch.grey import Grey

HOST_ONLY = 1 << 62  # a host_scan_limit past any input: the host route

# the corpus alphabet: no lowercase letter and no byte past 0x7F, so the
# plants hold the only lowercase literals and UTF-8 sequences
ALPHABET = (b"ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789 .,;:!?-_=+()[]<>/\n")

U8 = ht.HS_FLAG_UTF8
UCP = ht.HS_FLAG_UTF8 | ht.HS_FLAG_UCP
Q = ht.HS_FLAG_QUIET
C = ht.HS_FLAG_COMBINATION
MIN_OFF = 1 << 20  # the ext feature's bounds (block offsets)
MAX_OFF = 1 << 21


@dataclasses.dataclass(frozen=True)
class Feature:
    """One feature's database and plant. `kind`: "free" (every plant's
    own matches), "offsets" (ext bounds), "single" (SINGLEMATCH ids),
    "ranges" (ALLOWEMPTY through scan_block_ranges). `eod_ids` are the
    purely negative combinations, which report at the end of each block
    and stream; `stream` marks the features also run in stream mode."""

    pats: Tuple[str, ...]
    flags: Tuple[int, ...]
    ids: Tuple[int, ...]
    plant: bytes
    ext: Optional[Tuple[dict, ...]] = None
    kind: str = "free"
    eod_ids: Tuple[int, ...] = ()
    stream: bool = False


FEATURES: Dict[str, Feature] = {
    # tests/test_combination.py: QUIET sub-expressions, AND, AND-NOT and a
    # purely negative combination (103 is never planted)
    "combination": Feature(
        ("abc", "def", "xyz", "101&102", "101&!103", "!103"),
        (Q, Q, Q, C, C, C), (101, 102, 103, 900, 901, 902),
        b"  abc def  ", eod_ids=(902,), stream=True),
    # tests/test_fuzzy.py min_length, tests/test_api.py and
    # test_edges.py min_offset / max_offset
    "ext": Feature(
        (r"admin[0-9]{1,3}", r"foobar", r"needle[0-9]"), (0, 0, 0),
        (11, 12, 13), b"  admin1 admin22 admin333 foobar needle7  ",
        ext=(dict(min_length=8), dict(min_offset=MIN_OFF),
             dict(max_offset=MAX_OFF)), kind="offsets"),
    # tests/test_anchored.py and test_api.py SINGLEMATCH
    "singlematch": Feature(
        (r"hit[0-9]{1,2}e", r"x[0-9]+y", r"zork"),
        (ht.HS_FLAG_SINGLEMATCH, ht.HS_FLAG_SINGLEMATCH, 0), (21, 22, 23),
        b"  hit1e hit22e x12y zork  ", kind="single"),
    # tests/test_anchored.py: the family sharing one suffix validator and
    # the head alternations expanded into anchored refs
    "anchored": Feature(
        (r"attack7[0-9]{2,4}z", r"payload123[0-9]{2,4}z",
         r"evilstring[0-9]{2,4}z", r"gadget[0-9]{2,4}z",
         r"x12(GET|POST|PUT) /[a-z]{1,20}", r"v4\.(exe|dll|bat)"),
        (0,) * 6, (1, 2, 3, 4, 5, 6),
        b"  attack734z payload12399z evilstring55z gadget123456z "
        b"x12POST /abc v4.dll  ", stream=True),
    # tests/test_fuzzy.py
    "fuzzy": Feature(
        (r"attack", r"abcd"), (0, 0), (31, 32), b"  attck atack abxd  ",
        ext=(dict(edit_distance=1), dict(hamming_distance=1))),
    # tests/test_utf8.py
    "utf8": Feature(
        (r"h.llo", r"[α-ω]+x", r"gr[äa]y"), (U8, U8, U8), (41, 42, 43),
        "  hällo h€llo αβγx gräy  ".encode(), stream=True),
    # tests/test_utf8.py UCP word boundaries, tests/test_ucp.py scripts
    "ucp": Feature(
        (r"\bgr[äa]y\b", r"\p{Greek}+x"), (UCP, UCP), (51, 52),
        "  gräy grays ωλx  ".encode()),
    # tests/test_bitnfa.py blow-ups
    "bitnfa": Feature(
        (r".*a.{18}b", r".*[ab]c.{12}[de]"), (0, 0), (61, 62),
        b"  a0123456789ABCDEFGHb  bc0123456789ABd  "),
    # tests/test_api.py: ALLOWEMPTY through scan_block_ranges
    "ranges": Feature(
        (r"x*", r"needle"), (ht.HS_FLAG_ALLOWEMPTY, 0), (71, 72),
        b"  needle  ", kind="ranges"),
}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError("check failed: " + msg)


def compile_feature(name: str, mode: int = ht.HS_MODE_BLOCK,
                    host_scan_limit: int = 1 << 17) -> Database:
    f = FEATURES[name]
    ext = f.ext and [ht.ExprExt(**e) for e in f.ext]
    return compile_patterns(list(f.pats), list(f.flags), list(f.ids), mode,
                            ext=ext, grey=Grey(host_scan_limit=host_scan_limit))


def base_corpus(n: int, seed: int) -> np.ndarray:
    """n bytes of ALPHABET, uniform, from `seed`."""
    rng = np.random.default_rng(seed)
    return np.frombuffer(ALPHABET, np.uint8)[
        rng.integers(0, len(ALPHABET), size=n, dtype=np.uint8)]


def plant_offsets(n: int, spacing: int) -> np.ndarray:
    """Where the plants go: one every `spacing` bytes from `spacing // 3`
    on, each moved by a seeded jitter below `spacing // 2`, the last at
    least `spacing // 2` bytes before n (a plant is shorter)."""
    rng = np.random.default_rng(n ^ spacing)
    offs = np.arange(spacing // 3, n - spacing, spacing, dtype=np.int64)
    return offs + rng.integers(0, spacing // 2, size=offs.size)


def planted(base: np.ndarray, plant: bytes, offs: np.ndarray) -> np.ndarray:
    c = base.copy()
    p = np.frombuffer(plant, np.uint8)
    idx = offs[:, None] + np.arange(p.size)[None, :]
    c[idx.reshape(-1)] = np.tile(p, offs.size)
    return c


def plant_matches(name: str, db: Database) -> Tuple[
        List[Tuple[int, int]], List[Tuple[int, int]]]:
    """The sorted (id, end) matches of the feature's plant scanned alone
    on the host route, without the end-of-data reports: as the first
    plant of a block, and as any later one (the plant scanned after a
    first copy: a combination's sub-expressions are then already seen, a
    SINGLEMATCH id already reported). `db` is the feature's database;
    the ext feature's plant is scanned without its offset bounds, which
    `expected` applies."""
    f = FEATURES[name]
    if f.kind == "offsets":
        ext = [ht.ExprExt(**{k: v for k, v in e.items()
                             if k not in ("min_offset", "max_offset")})
               for e in f.ext]
        db = compile_patterns(list(f.pats), list(f.flags), list(f.ids),
                              ext=ext)
    gap = len(f.plant) + 64  # the second copy's start
    with host_limit(db, HOST_ONLY):
        one = ht.scan(db, f.plant, device="cpu")
        two = ht.scan(db, f.plant + b" " * 64 + f.plant, device="cpu")
    # an ALLOWEMPTY pattern's empty matches are everywhere
    empty = {i for i, fl in zip(f.ids, f.flags)
             if fl & ht.HS_FLAG_ALLOWEMPTY}

    def own(ms, end):
        return sorted((i, t) for (i, _f, t) in ms
                      if not (i in f.eod_ids and t == end))

    first = own(one, len(f.plant))
    check(own([m for m in two if m[2] <= len(f.plant)], -1) == first,
          f"{name}: the plant's matches depend on what follows it")
    check(not any(len(f.plant) < t <= gap and i not in empty
                  for (i, _f, t) in two),
          f"{name}: a plant's match reaches past it")
    later = [(i, t - gap) for (i, t) in own(two, gap + len(f.plant))
             if t > gap]
    return first, later


@contextlib.contextmanager
def host_limit(db, limit: int):
    """Within the block, `db` scans on the host up to `limit` bytes a
    call (the port's host route for a differential)."""
    old, db.host_scan_limit = db.host_scan_limit, limit
    try:
        yield
    finally:
        db.host_scan_limit = old


def expected(name: str, db: Database, offs: np.ndarray, block: int,
             n_blocks: int) -> Tuple[List[List[Tuple[int, int]]], int]:
    """Per block, the sorted (id, end) matches the plants inside it give
    (none of them may cross a block's end), and the count of plants
    inside blocks."""
    f = FEATURES[name]
    first, later = plant_matches(name, db)
    want: List[List[Tuple[int, int]]] = [[] for _ in range(n_blocks)]
    seen = set()  # the blocks whose first plant is counted
    n_in = 0
    for off in offs.tolist():
        b, rel = divmod(off, block)
        if b >= n_blocks:
            continue
        check(rel + len(f.plant) <= block, f"{name}: a plant crosses the "
              f"end of block {b}")
        n_in += 1
        for (i, t) in (later if b in seen else first):
            end = rel + t
            if f.kind == "offsets":
                e = f.ext[f.ids.index(i)]
                if end < e.get("min_offset", 0) or \
                        end > e.get("max_offset", 1 << 62):
                    continue
            want[b].append((i, end))
        seen.add(b)
    for b in range(n_blocks):
        want[b] += [(i, block) for i in f.eod_ids]
        want[b].sort()
    return want, n_in


def _first_diff(a: list, b: list):
    """The first entry where two sorted lists differ (a's, b's; None
    where the lists are equal)."""
    for x, y in zip(a, b):
        if x != y:
            return x, y
    if len(a) == len(b):
        return None
    return (a[len(b)], None) if len(a) > len(b) else (None, b[len(a)])


def _families(db: Database) -> Dict[str, int]:
    """The literal families the database has dispatched so far."""
    if db.lit is None:
        return {}
    from hyperscan_tpu_torch.ops.teddy_families import family_state

    return {k: v for k, v in family_state(db.lit).dispatches.items() if v}


def _stage(stages: dict, key: str, t0: float) -> float:
    t = time.perf_counter()
    stages[key] = stages.get(key, 0.0) + t - t0
    return t


def run_feature(name: str, base: np.ndarray, *, device, block: int,
                prefix: int, spacing: int, streams: int = 0,
                write: int = 0, rounds: int = 0, check_streams: int = 64,
                host_scan_limit: int = 1 << 17, sync=None,
                kernel_checks=None) -> dict:
    """One feature at the size `base` gives: compile, plant, scan_batch
    over blocks of `block` bytes on `device` (scan_block_ranges over the
    whole corpus for the ranges feature), the plants found, the first
    `prefix` bytes equal to the host route, the database serialized,
    loaded back and scanned again with the same result; for the stream
    features also a StreamSet of `streams` x `write` bytes x `rounds`
    whose first `check_streams` streams equal scan_streams on the host
    route and whose every stream reports the purely negative
    combinations at close. `sync` (e.g. torch.cuda.synchronize) runs
    before each stage's clock is read. `kernel_checks(db, corpus, block)`,
    when given, runs after the scan on the database and the bytes it
    scanned (blocks of `block` bytes head to head) and returns the max
    abs error of each kernel it held against its plain version
    ("kernel_errs"). Returns the stage seconds and the counts; raises on
    a failed check."""
    sync = sync or (lambda: None)
    f = FEATURES[name]
    n = base.size
    stages: Dict[str, float] = {}
    t0 = time.perf_counter()
    db = compile_feature(name, host_scan_limit=host_scan_limit)
    t0 = _stage(stages, "compile", t0)
    offs = plant_offsets(n, spacing)
    if f.kind == "ranges":
        block = n  # one block: the whole corpus
    offs = offs[offs % block + len(f.plant) <= block]  # none crosses
    corpus = planted(base, f.plant, offs)
    n_blocks = n // block
    out: dict = {"bytes": n_blocks * block}

    def held(scanned):
        nonlocal t0
        if kernel_checks is not None:
            out["kernel_errs"] = kernel_checks(db, scanned, block)
            sync()
            t0 = _stage(stages, "kernel_checks", t0)

    if f.kind == "ranges":
        data = corpus.tobytes()
        t0 = _stage(stages, "corpus", t0)
        ms, ranges = ht.scan_block_ranges(db, data, device=device)
        sync()
        t0 = _stage(stages, "scan", t0)
        cnt = ht.scan_count(db, data, device=device)
        sync()
        t0 = _stage(stages, "scan_count", t0)
        first, _later = plant_matches(name, db)
        needles = sorted((i, int(o) + t) for o in offs.tolist()
                         for (i, t) in first if i != 71)
        check(sorted((i, t) for (i, _f, t) in ms) == needles,
              f"{name}: the point matches are not the planted needles")
        check(all(i == 71 for (i, _lo, _hi) in ranges)
              and sum(hi - lo + 1 for (_i, lo, hi) in ranges) == n + 1,
              f"{name}: the x* ranges do not cover every offset once")
        check(cnt == len(ms) + n + 1, f"{name}: scan_count {cnt} != "
              f"{len(ms)} points + {n + 1} range offsets")
        with host_limit(db, HOST_ONLY):
            host = ht.scan_block_ranges(db, data[:prefix], device="cpu")
        dev = ht.scan_block_ranges(db, data[:prefix], device=device)
        check(host == dev, f"{name}: the {prefix}-byte prefix differs "
              "from the host route")
        t0 = _stage(stages, "host_prefix", t0)
        held(corpus)
        db2 = ht.deserialize_database(ht.serialize_database(db))
        check(ht.scan_block_ranges(db2, data, device=device) == (ms, ranges),
              f"{name}: the loaded-back database scans differently")
        sync()
        _stage(stages, "roundtrip", t0)
        out.update(plants=len(offs), matches=len(ms) + len(ranges),
                   count=cnt)
        return {"stages": stages, **out}
    blocks = [corpus[k * block:(k + 1) * block].tobytes()
              for k in range(n_blocks)]
    t0 = _stage(stages, "corpus", t0)
    got = ht.scan_batch(db, blocks, device=device)
    sync()
    t0 = _stage(stages, "scan", t0)
    out["families"] = _families(db)
    want, n_in = expected(name, db, offs, block, n_blocks)
    for b in range(n_blocks):
        have = sorted((i, t) for (i, _f, t) in got[b])
        check(have == want[b], f"{name}: block {b}'s {len(have)} matches "
              f"are not the {len(want[b])} its plants give (first "
              f"difference {_first_diff(have, want[b])})")
    with host_limit(db, HOST_ONLY):
        host = ht.scan_batch(db, [blocks[0][:prefix]], device="cpu")[0]
    dev = ht.scan_batch(db, [blocks[0][:prefix]], device=device)[0]
    check(host == dev, f"{name}: the {prefix}-byte prefix's {len(dev)} "
          f"matches differ from the host route's {len(host)}")
    cut = prefix - 64  # a match ending here has its context in the prefix
    check(sorted((i, t) for (i, _f, t) in got[0] if t <= cut) ==
          sorted((i, t) for (i, _f, t) in host if t <= cut),
          f"{name}: block 0's matches in the prefix differ from the host "
          "route's")
    t0 = _stage(stages, "host_prefix", t0)
    held(corpus[:n_blocks * block])
    db2 = ht.deserialize_database(ht.serialize_database(db))
    check(ht.scan_batch(db2, blocks, device=device) == got,
          f"{name}: the loaded-back database scans differently")
    sync()
    t0 = _stage(stages, "roundtrip", t0)
    del db2
    out.update(plants=n_in, matches=sum(map(len, got)),
               host_prefix_matches=len(host))
    if f.stream and streams:
        out.update(stream_feature(name, corpus, device=device,
                                  streams=streams, write=write,
                                  rounds=rounds, check_streams=check_streams,
                                  host_scan_limit=host_scan_limit,
                                  stages=stages, sync=sync))
    return {"stages": stages, **out}


def stream_feature(name: str, corpus: np.ndarray, *, device, streams: int,
                   write: int, rounds: int, check_streams: int,
                   host_scan_limit: int, stages: dict, sync) -> dict:
    """A StreamSet of `streams` streams over `rounds` writes of `write`
    bytes each: stream i's round r is corpus[(r * streams + i) * write:]
    (the plants fall anywhere, across write boundaries too)."""
    from hyperscan_tpu_torch.runtime import streamset as SS

    f = FEATURES[name]
    check(corpus.size >= streams * write * rounds,
          f"{name}: the corpus is shorter than the StreamSet's writes")
    t0 = time.perf_counter()
    sdb = compile_feature(name, ht.HS_MODE_STREAM, host_scan_limit)
    writes = [[corpus[(r * streams + i) * write:
                      (r * streams + i + 1) * write].tobytes()
               for i in range(streams)] for r in range(rounds)]
    t0 = _stage(stages, "stream_setup", t0)
    ss = SS.open_streamset(sdb, streams, device=device)
    got = [SS.scan_streamset(sdb, ss, w) for w in writes]
    sync()
    t0 = _stage(stages, "streamset", t0)
    got.append(SS.close_streamset(sdb, ss))
    t0 = _stage(stages, "stream_close", t0)
    total = write * rounds
    for i, ms in enumerate(got[-1]):
        for j in f.eod_ids:
            check((j, 0, total) in ms, f"{name}: stream {i} closed without "
                  f"the purely negative combination {j}")
    host_sts = [ht.open_stream(sdb, device="cpu")
                for _ in range(check_streams)]
    with host_limit(sdb, HOST_ONLY):
        host = [ht.scan_streams(sdb, host_sts, w[:check_streams])
                for w in writes]
        host.append([ht.close_stream(s) for s in host_sts])
    for r, (g, h) in enumerate(zip(got, host)):
        check([sorted(x) for x in g[:check_streams]]
              == [sorted(x) for x in h], f"{name}: StreamSet round {r}'s "
              f"first {check_streams} streams differ from the host route")
    _stage(stages, "stream_host", t0)
    return {"stream_bytes": streams * total,
            "stream_matches": sum(len(m) for rnd in got for m in rnd),
            "stream_host_matches": sum(len(m) for rnd in host for m in rnd)}
