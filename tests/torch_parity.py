"""Run one test body through the JAX package and through the port, and
hold the port's results to the reference's exactly.

A body is a function of one argument, a `Pkg`: it makes its calls
through the Pkg (compile, scan, streams, serialization, the package's
names and error classes), keeps the reference test's own checks (its
oracle, its asserts) and returns what it saw. `parity(body)` runs it
three times:

- "ref": the JAX package, every scan on its host route (a database's
  `host_scan_limit` set past any input, so no Pallas kernel runs in
  interpret mode: that path is too slow to serve as a reference for a
  large DFA);
- "host": the port on device="cpu", on its host route (the same limit);
- "device": the port on device="cpu" with the device branch forced
  (`host_scan_limit` 0, as Grey(host_scan_limit=0) compiles it): every
  scan and stream write runs the plain versions of the port's kernels.

and asserts that the two port runs return exactly what the reference
returned. The compiler's output does not depend on `host_scan_limit`,
so the device route takes the host route's databases (compiled once per
body) with the limit set to 0, instead of compiling them again.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import hyperscan_tpu as hs
import hyperscan_tpu_torch as ht
import torch_ref_native  # noqa: F401 (the reference's native build, locked)
from hyperscan_tpu import database as ref_database
from hyperscan_tpu.grey import Grey as RefGrey
from hyperscan_tpu_torch import database as port_database
from hyperscan_tpu_torch.grey import Grey as PortGrey

HOST_ONLY = 1 << 62  # a host_scan_limit past any input


def _tuples(ms) -> List[tuple]:
    return [tuple(m) for m in ms]


class Pkg:
    """One package on one route, with the JAX package's call signatures
    (the port's device keyword added where the port takes one). Names
    that are not methods here resolve on the package module."""

    def __init__(self, name: str, mod, database, grey_cls, limit: int,
                 device: Optional[str] = None):
        self.name, self.mod, self.database = name, mod, database
        self.grey_cls, self.limit, self.device = grey_cls, limit, device
        self.port = device is not None
        self._compiled: Optional[Dict[str, object]] = None
        self._reuse = False

    def __getattr__(self, name):
        return getattr(self.mod, name)

    def __repr__(self) -> str:
        return f"Pkg({self.name})"

    @property
    def on(self) -> dict:
        return {"device": self.device} if self.port else {}

    # --- compile ------------------------------------------------------------

    def grey(self, **kw):
        return self.grey_cls(**{"host_scan_limit": self.limit, **kw})

    def compile_patterns(self, pats, flags=None, ids=None, mode=None,
                         ext=None, literal=False, **grey_kw):
        """database.compile_patterns with this route's grey (plus the
        Grey tunables in `grey_kw`)."""
        mode = self.mod.HS_MODE_BLOCK if mode is None else mode
        key = repr((list(pats), flags, ids, mode, ext, literal,
                    sorted(grey_kw.items())))
        cache = self._compiled
        if cache is not None and self._reuse and key in cache:
            db = cache[key]
            return dataclasses.replace(db, host_scan_limit=self.limit)
        db = self.database.compile_patterns(
            pats, flags, ids, mode, ext=ext, literal=literal,
            grey=self.grey(**grey_kw))
        if cache is not None and not self._reuse:
            cache[key] = db
        return db

    def compile(self, pat, flags=0, mode=None):
        return self.compile_patterns([pat], [flags], [0], mode)

    def compile_multi(self, pats, flags=None, ids=None, mode=None):
        return self.compile_patterns(pats, flags, ids, mode)

    def compile_ext_multi(self, pats, flags=None, ids=None, ext=None,
                          mode=None):
        return self.compile_patterns(pats, flags, ids, mode, ext=ext)

    def compile_lit(self, pat, flags=0, mode=None):
        return self.compile_patterns([pat], [flags], [0], mode,
                                     literal=True)

    def compile_lit_multi(self, pats, flags=None, ids=None, mode=None):
        return self.compile_patterns(pats, flags, ids, mode, literal=True)

    # --- block scans --------------------------------------------------------

    def scan(self, db, data, callback=None, scratch=None):
        return _tuples(self.mod.scan(db, data, callback, scratch, **self.on))

    def scan_batch(self, db, blocks, **kw):
        return [_tuples(ms) for ms in
                self.mod.scan_batch(db, blocks, **kw, **self.on)]

    def scan_block_ranges(self, db, data):
        ms, ranges = self.mod.scan_block_ranges(db, data, **self.on)
        return _tuples(ms), [tuple(r) for r in ranges]

    def scan_count(self, db, data):
        return self.mod.scan_count(db, data, **self.on)

    def make_mesh(self, n):
        if self.port:
            from hyperscan_tpu_torch.parallel import make_mesh
            return make_mesh(n, device=self.device)
        from hyperscan_tpu.parallel.sharded import make_mesh
        return make_mesh(n)

    # --- streams ------------------------------------------------------------

    def open_stream(self, db):
        return self.mod.open_stream(db, **self.on)

    def expand_stream(self, db, buf):
        return self.mod.expand_stream(db, buf, **self.on)

    def scan_stream(self, st, data, callback=None):
        return _tuples(self.mod.scan_stream(st, data, callback))

    def close_stream(self, st, callback=None):
        return _tuples(self.mod.close_stream(st, callback))

    def scan_streams(self, db, streams, chunks, **kw):
        return [_tuples(ms) for ms in
                self.mod.scan_streams(db, streams, chunks, **kw)]

    def hs_reset_and_copy_stream(self, to, src, callback=None):
        return _tuples(self.mod.hs_reset_and_copy_stream(to, src, callback))

    @property
    def streamset(self):
        if self.port:
            from hyperscan_tpu_torch.runtime import streamset
        else:
            from hyperscan_tpu.runtime import streamset
        return streamset

    def open_streamset(self, db, n):
        return self.streamset.open_streamset(db, n, **self.on)

    def scan_streamset(self, db, ss, chunks):
        return [_tuples(ms) for ms in
                self.streamset.scan_streamset(db, ss, chunks)]

    def close_streamset(self, db, ss):
        return [_tuples(ms) for ms in
                self.streamset.close_streamset(db, ss)]


REF = Pkg("ref", hs, ref_database, RefGrey, HOST_ONLY)
HOST = Pkg("host", ht, port_database, PortGrey, HOST_ONLY, device="cpu")
DEVICE = Pkg("device", ht, port_database, PortGrey, 0, device="cpu")
ROUTES = (HOST, DEVICE)


def raises(pkg: Pkg, fn: Callable, *args, **kw) -> str:
    """The name of the package error class `fn(*args)` raises, which
    must be a HyperscanError of `pkg`'s package; "ok" if it returns."""
    try:
        fn(*args, **kw)
    except pkg.HyperscanError as e:
        return type(e).__name__
    return "ok"


class Uploads:
    """Counts the port's uploads of a corpus to a torch device
    (`ops.teddy.corpus_tensor`, which every device branch calls and no
    host route does) while it is installed."""

    def __init__(self):
        self.n = 0

    def __enter__(self):
        from hyperscan_tpu_torch.ops import teddy

        self._real = teddy.corpus_tensor

        def counted(*a, **kw):
            self.n += 1
            return self._real(*a, **kw)

        teddy.corpus_tensor = counted
        return self

    def __exit__(self, *exc):
        from hyperscan_tpu_torch.ops import teddy

        teddy.corpus_tensor = self._real


def parity(body: Callable[[Pkg], object], share_compiles: bool = True,
           scans: bool = True):
    """body(REF), then body on each port route; each must return exactly
    what the reference returned. Returns the reference's result.

    The host route must upload no corpus to a torch device, and, where
    the body scans (`scans`), the device route must upload one at
    least. `share_compiles=False` compiles again on the device route
    (for a body that changes its databases or compiles under a patched
    module)."""
    want = body(REF)
    cache: Dict[str, object] = {}
    try:
        for route in ROUTES:
            route._compiled = cache if share_compiles else None
            route._reuse = route is not ROUTES[0]
            with Uploads() as up:
                got = body(route)
            assert got == want, (
                f"port route {route.name} differs from the JAX package:\n"
                f"  port: {got!r}\n  ref:  {want!r}")
            if route.limit:
                assert up.n == 0, f"the host route uploaded {up.n} corpora"
            elif scans:
                assert up.n > 0, "the device route took no device branch"
    finally:
        for route in ROUTES:
            route._compiled, route._reuse = None, False
    return want
