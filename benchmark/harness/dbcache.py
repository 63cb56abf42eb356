"""Each configuration's database, compiled once per checkout.

The serialized database (`serialize_database`) is kept under
`benchmark/cache/db/`, named by the configuration and a key: a hash of the
ruleset, the mode, the flags and every source file of the port. A run
that finds its file deserializes it; one that does not compiles the
ruleset and writes the file (through a temporary name, so a reader never
sees half a file). Users ship databases the same way.
"""

from __future__ import annotations

import hashlib
import json
import os
import pathlib
import time

from . import spec
from .spec import BENCH, PORT

CACHE = BENCH / "cache" / "db"
SOURCE_SUFFIXES = (".py", ".cu", ".cuh", ".cpp", ".h")


def ruleset(cfg: dict):
    """(patterns, ids, flags) of a configuration's ruleset, from the
    module that its `ruleset.formula` names."""
    rs = cfg["ruleset"]
    return spec.ruleset(rs).rules(rs)


def port_sources(port: pathlib.Path = PORT) -> list:
    """The port's source files, in a fixed order (its build output is
    not a source)."""
    return sorted(p for p in port.rglob("*")
                  if p.suffix in SOURCE_SUFFIXES and p.is_file()
                  and "build" not in p.relative_to(port).parts
                  and "__pycache__" not in p.parts)


def key(cfg: dict, port: pathlib.Path = PORT) -> str:
    pats, ids, flags = ruleset(cfg)
    h = hashlib.sha256(json.dumps(
        {"patterns": pats, "ids": ids, "flags": flags, "mode": cfg["mode"]},
        sort_keys=True).encode())
    for p in port_sources(port):
        h.update(p.relative_to(port).as_posix().encode() + b"\0")
        h.update(p.read_bytes())
    return h.hexdigest()[:24]


def mode_flag(ht, cfg: dict) -> int:
    return {"block": ht.HS_MODE_BLOCK, "stream": ht.HS_MODE_STREAM}[
        cfg["mode"]]


def path_for(cfg: dict) -> pathlib.Path:
    return CACHE / f"{cfg['name']}-{key(cfg)}.hsdb"


def ensure(ht, cfg: dict, log) -> pathlib.Path:
    """The cache file of the configuration, compiled and written first if
    it is missing; `log` gets the compile seconds."""
    path = path_for(cfg)
    if path.exists():
        return path
    pats, ids, flags = ruleset(cfg)
    t0 = time.perf_counter()
    db = ht.compile_multi(pats, flags, ids, mode_flag(ht, cfg))
    log(f"compiled {cfg['name']} ({len(pats)} patterns) in "
        f"{time.perf_counter() - t0:.3f} s; writing {path.name}")
    CACHE.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    tmp.write_bytes(ht.serialize_database(db))
    os.replace(tmp, path)
    return path


def load(ht, cfg: dict, log):
    """The configuration's database, from the cache file."""
    path = ensure(ht, cfg, log)
    t0 = time.perf_counter()
    db = ht.deserialize_database(path.read_bytes())
    log(f"deserialized {path.name} in {time.perf_counter() - t0:.3f} s")
    return db
