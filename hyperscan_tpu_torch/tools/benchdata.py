"""The bench rulesets and corpora of the JAX package's bench.py, copied
(bench.py belongs to the JAX package): Snort-flavored patterns that all
carry bounded literal factors, and 4 KiB of planted matches spliced into
corpora of printable bytes made from a formula.

Also kernel D's wide bit-NFA engines and the plant of the 45-class one.

Used by the port's bench (tools/bench.py), chip_smoke.py, the stage probe
(tools/kconf_probe.py) and the port's kernel tests.
"""

from __future__ import annotations

import numpy as np

WORDS = ["attack", "payload", "shell", "admin", "select", "union", "eval",
         "script", "passwd", "cookie", "token", "login", "root", "exec"]

PLANTS = [b"attack0 ", b"payload16y99z!", b"x12GET /abc ", b"q8hdeadbeef ",
          b"v4.exe ", b"union55 ", b"shell2222 ",
          b"gate5xabcdabunion5end ", b"gate11xlogin11end "]
PLANT_AT = 128


def patterns(n: int, drop_shapes=()):
    """The first n patterns and their ids (bench.py:52-90), without those
    of the shapes (id % 6) in `drop_shapes` (bench.py:156-159: the SOM
    configurations drop shape 5, whose general-infix chains route to SOM
    engines under SOM_LEFTMOST)."""
    pats, ids = [], []
    for i in range(n):
        k = i % 6
        if k in drop_shapes:
            continue
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


# kernel D's engines past the bench engine: name -> (pattern, Grey
# tunables). "many_class" has 45 classes (two membership words a byte),
# "p502" 502 positions, near the device's limit of 512.
MANY_CLASS_NFA = (r".*[a-c]x[d-f]y[g-i]z[j-l]w[m-o]v[p-r]u[s-t]q0[1-2]1"
                  r"[3-4]2[5-6]3[7-8]4[9A]5[B-C]6[D-E]7[F-G]8[H-I]9[J-K]A"
                  r"[L-M]B[N-O]C[P-Q]D[R-S]E.{3}[T-U]")
NFA_ENGINES = {
    "many_class": (MANY_CLASS_NFA,
                   {"max_dfa_states": 8, "allow_teddy": False}),
    "p502": (r".*a.{500}b", {"max_dfa_states": 8}),
}
# one match of MANY_CLASS_NFA
MANY_CLASS_PLANT = b"axdygzjwmvpusq01132537495B6D7F8H9JALBNCPDREzzzT"


def plant_many_class(data, start: int, every: int):
    """A copy of `data` (bytes or a uint8 array, of the same type) with
    MANY_CLASS_PLANT at start, start + every, ... while it fits 64 bytes
    before the end."""
    out = np.frombuffer(data, np.uint8).copy() if isinstance(
        data, (bytes, bytearray)) else data.copy()
    p = np.frombuffer(MANY_CLASS_PLANT, np.uint8)
    for off in range(start, len(out) - 64, every):
        out[off:off + len(p)] = p
    return out.tobytes() if isinstance(data, (bytes, bytearray)) else out


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


def gen_corpus(n: int, salt: int, kind: str) -> np.ndarray:
    """kind="structured": a multiplicative-hash progression (low filter
    candidate rate); kind="iid": one more xorshift-multiply round, iid-like
    printable noise (the adversarial candidate rate)."""
    v = np.arange(n, dtype=np.uint32)
    v += np.uint32(salt * 1_000_003)
    v *= np.uint32(2654435761)
    if kind == "iid":
        v ^= v >> np.uint32(15)
        v *= np.uint32(2246822519)
    v >>= np.uint32(16)
    lut = (32 + np.arange(65536, dtype=np.uint32) % 95).astype(np.uint8)
    corpus = lut[v]
    corpus[PLANT_AT:PLANT_AT + 4096] = plant_region()
    return corpus


# --- streams (the formula of the JAX package's tools_bench_stream.py) --------

_PRINTABLE = (32 + np.arange(65536, dtype=np.uint32) % 95).astype(np.uint8)

STREAM_PLANT = b"attack0 "
STREAM_PERIOD = 1 << 17  # one planted match per 128 KiB per stream


def stream_extents(n_streams: int, write: int, hist: int,
                   r: int) -> np.ndarray:
    """Round r's extents of `n_streams` streams that each write `write`
    bytes a round, head to head: each stream's last `hist` bytes of
    history, then its write. Stream si's byte at absolute offset t is a
    printable multiply-mix of (si, t), with STREAM_PLANT spliced where
    (t - 131 si) is a multiple of STREAM_PERIOD (tools_bench_stream.py:
    54-96)."""
    ext_len = hist + write
    if ext_len > STREAM_PERIOD:
        raise ValueError("an extent longer than the plant period")
    t_lo = r * write - hist  # each extent's first absolute offset
    si = np.arange(n_streams, dtype=np.uint32)[:, None]
    t = np.arange(t_lo, t_lo + ext_len, dtype=np.int64).astype(np.uint32)
    v = (si * np.uint32(1_000_003) + t[None, :]) * np.uint32(2654435761)
    out = _PRINTABLE[v >> np.uint32(16)]
    # plant byte k lies where t - 131 si = k (mod STREAM_PERIOD): at most
    # once in an extent, which is shorter than the period
    rows = np.arange(n_streams, dtype=np.int64)
    for k, byte in enumerate(STREAM_PLANT):
        at = (131 * rows + k - t_lo) % STREAM_PERIOD
        hit = at < ext_len
        out[rows[hit], at[hit]] = byte
    return out.reshape(-1)


def stream_plants(n_streams: int, n_bytes: int) -> set:
    """(stream, end offset of its `attack0`, the bench ruleset's pattern
    0) of every STREAM_PLANT that lies wholly in the first `n_bytes` of
    each stream."""
    out = set()
    for si in range(n_streams):
        for t in range((131 * si) % STREAM_PERIOD, n_bytes, STREAM_PERIOD):
            if t + len(STREAM_PLANT) <= n_bytes:
                out.add((si, t + len(STREAM_PLANT) - 1))
    return out


# --- the host-path streams of bench.py:280-344 ---------------------------------

HOST_STREAMS = 16
HOST_WRITE = 8192


def host_stream_writes(seed: int, every: int, rounds: int) -> list:
    """`rounds` rounds of HOST_STREAMS writes of HOST_WRITE random
    printable bytes from default_rng(seed), with `attack0 ` at offset 100
    of stream s's write in round r where (r + s) % every == 0 (bench.py:
    296-305 with seed 3 and every 4, :322-331 with seed 7 and every 5). The
    first k rounds do not depend on `rounds`."""
    rng = np.random.default_rng(seed)
    writes = []
    for r in range(rounds):
        row = []
        for s in range(HOST_STREAMS):
            c = (32 + rng.integers(0, 95, size=HOST_WRITE)).astype(np.uint8)
            if (r + s) % every == 0:
                c[100:108] = np.frombuffer(STREAM_PLANT, np.uint8)
            row.append(c.tobytes())
        writes.append(row)
    return writes
