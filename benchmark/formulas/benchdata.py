"""Frozen copy of the bench ruleset and corpus formulas.

The formulas are those of `hyperscan_tpu_torch/tools/benchdata.py` (the
Snort-flavoured 10k ruleset, the planted 4 KiB region, the structured and
iid printable corpora, and the per-flow stream bytes). They are copied
here so that the benchmark's traffic and its reference cannot move when
the program changes; `benchmark/tests/test_bench_formulas.py` holds the
copy byte for byte to the program's module.

Two widenings, both equal to the original where the original is defined:
`gen_corpus` takes any salt (the product `salt * 1_000_003` wraps modulo
2**32 instead of overflowing), and `stream_extents` / `stream_plants`
take the number of the first flow (`first`, 0 in the original), so that a
seed can choose which flows a run drives.
"""

from __future__ import annotations

import numpy as np

WORDS = ["attack", "payload", "shell", "admin", "select", "union", "eval",
         "script", "passwd", "cookie", "token", "login", "root", "exec"]

PLANTS = [b"attack0 ", b"payload16y99z!", b"x12GET /abc ", b"q8hdeadbeef ",
          b"v4.exe ", b"union55 ", b"shell2222 ",
          b"gate5xabcdabunion5end ", b"gate11xlogin11end "]
PLANT_AT = 128


def patterns(n: int):
    """The first n patterns of the ruleset and their ids: six shapes by
    id % 6, each carrying the word WORDS[id % 14] or a one-letter head
    and the id's decimal digits."""
    pats, ids = [], []
    for i in range(n):
        k = i % 6
        w = WORDS[i % len(WORDS)]
        if k == 0:
            pats.append(w + str(i))
        elif k == 1:
            pats.append(rf"{w}{i}[0-9]{{2,4}}z")
        elif k == 2:
            pats.append(rf"x{i}(GET|POST|PUT) /[a-z]{{1,20}}")
        elif k == 3:
            pats.append(rf"q{i}h[a-f0-9]{{8}}")
        elif k == 4:
            pats.append(rf"v{i}\.(exe|dll|bat)")
        else:
            pats.append(rf"gate{i}x(ab|cd)*{w}{i}end")
        ids.append(i)
    return pats, ids


def plant_starts() -> list:
    """(offset in the corpus, plant) of each of the 36 plants: every plant
    of PLANTS four times, 97 spaces apart, from 16 bytes into the region."""
    out, off = [], PLANT_AT + 16
    for k in range(len(PLANTS) * 4):
        p = PLANTS[k % len(PLANTS)]
        out.append((off, p))
        off += len(p) + 97
    return out


def plant_region() -> np.ndarray:
    """4 KiB holding every planted match, spliced at offset 128."""
    region = np.full(4096, ord(" "), dtype=np.uint8)
    for off, p in plant_starts():
        off -= PLANT_AT
        region[off:off + len(p)] = np.frombuffer(p, np.uint8)
    return region


_PRINTABLE = (32 + np.arange(65536, dtype=np.uint32) % 95).astype(np.uint8)


def gen_corpus(n: int, salt: int, kind: str) -> np.ndarray:
    """kind="structured": a multiplicative-hash progression (low filter
    candidate rate); kind="iid": one more xorshift-multiply round, iid-like
    printable noise (the adversarial candidate rate). The plant region
    lies at PLANT_AT when the corpus holds it."""
    v = np.arange(n, dtype=np.uint32)
    v += np.uint32((salt * 1_000_003) % (1 << 32))
    v *= np.uint32(2654435761)
    if kind == "iid":
        v ^= v >> np.uint32(15)
        v *= np.uint32(2246822519)
    v >>= np.uint32(16)
    corpus = _PRINTABLE[v]
    region = plant_region()[:max(0, n - PLANT_AT)]
    corpus[PLANT_AT:PLANT_AT + len(region)] = region
    return corpus


STREAM_PLANT = b"attack0 "
STREAM_PERIOD = 1 << 17  # one planted match per 128 KiB per stream


def stream_extents(n_streams: int, write: int, hist: int, r: int,
                   first: int = 0) -> np.ndarray:
    """Round r's extents of `n_streams` streams (flows first, first + 1,
    ...) that each write `write` bytes a round, head to head: each
    stream's last `hist` bytes of history, then its write. Flow si's byte
    at absolute offset t is a printable multiply-mix of (si, t), with
    STREAM_PLANT spliced where (t - 131 si) is a multiple of
    STREAM_PERIOD."""
    ext_len = hist + write
    if ext_len > STREAM_PERIOD:
        raise ValueError("an extent longer than the plant period")
    t_lo = r * write - hist  # each extent's first absolute offset
    rows = np.arange(first, first + n_streams, dtype=np.int64)
    si = (rows % (1 << 32)).astype(np.uint32)[:, None]
    t = np.arange(t_lo, t_lo + ext_len, dtype=np.int64).astype(np.uint32)
    v = (si * np.uint32(1_000_003) + t[None, :]) * np.uint32(2654435761)
    out = _PRINTABLE[v >> np.uint32(16)]
    # plant byte k lies where t - 131 si = k (mod STREAM_PERIOD): at most
    # once in an extent, which is shorter than the period
    local = np.arange(n_streams, dtype=np.int64)
    for k, byte in enumerate(STREAM_PLANT):
        at = (131 * rows + k - t_lo) % STREAM_PERIOD
        hit = at < ext_len
        out[local[hit], at[hit]] = byte
    return out.reshape(-1)


def stream_plants(n_streams: int, n_bytes: int, first: int = 0) -> set:
    """(stream, end offset of its `attack0`, the ruleset's pattern 0) of
    every STREAM_PLANT that lies wholly in the first `n_bytes` of each
    stream (streams counted from 0, flows from `first`)."""
    out = set()
    for k in range(n_streams):
        si = first + k
        for t in range((131 * si) % STREAM_PERIOD, n_bytes, STREAM_PERIOD):
            if t + len(STREAM_PLANT) <= n_bytes:
                out.add((k, t + len(STREAM_PLANT) - 1))
    return out
