"""Public API of the PyTorch/CUDA port (the JAX package's api.py, its
platform calls on torch).

Pythonic surface plus C-style aliases mirroring the reference's hs.h
(reference: src/hs_compile.h, src/hs_runtime.h, src/hs_common.h):

  hs_compile / hs_compile_multi / hs_compile_ext_multi / hs_compile_lit*
  hs_scan (block), scan_batch (batched blocks)
  hs_serialize_database / hs_deserialize_database / hs_database_size /
  hs_database_info / hs_serialized_database_info
  hs_alloc_scratch / hs_clone_scratch
  hs_expression_info / hs_expression_ext_info
  hs_version / hs_valid_platform / hs_populate_platform
  hs_open/scan/close/reset/copy_stream, hs_compress/expand_stream
  hs_scan_vector
  hs_set_allocator (+ per-domain variants)

Scans and streams run on the CUDA card unless the caller passes
device="cpu"; asked for the card where there is none, they raise.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

from .compiler.glushkov import build_nfa
from .compiler.parser import parse as _parse
from .database import DB_VERSION, Database, _nfa_widths, compile_patterns
from .errors import *  # noqa: F401,F403 — error codes are part of the API
from .flags import ExprExt, HS_MODE_BLOCK, UNBOUNDED, validate_flags
from .runtime.scan import Match, Scratch, scan_batch, scan_block
from .runtime.stream import (  # noqa: F401
    Stream,
    close_stream,
    compress_stream,
    copy_stream,
    expand_stream,
    reset_and_copy_stream,
    reset_and_expand_stream,
    open_stream,
    reset_stream,
    scan_stream,
    scan_streams,
    scan_vector,
)


def version() -> str:
    return ".".join(map(str, DB_VERSION)) + " hyperscan-tpu-torch"


# --- allocator hooks (reference: hs_set_allocator, src/hs_common.h:325-439)
# Host memory is managed by Python/numpy and device memory by torch's
# caching allocator, so these are compatibility no-ops that record the
# hooks for introspection, mirroring the reference's pluggable
# malloc/free domains.

_allocators = {}


def set_allocator(alloc=None, free=None) -> None:
    for domain in ("database", "misc", "scratch", "stream"):
        _allocators[domain] = (alloc, free)


def set_database_allocator(alloc=None, free=None) -> None:
    _allocators["database"] = (alloc, free)


def set_misc_allocator(alloc=None, free=None) -> None:
    _allocators["misc"] = (alloc, free)


def set_scratch_allocator(alloc=None, free=None) -> None:
    _allocators["scratch"] = (alloc, free)


def set_stream_allocator(alloc=None, free=None) -> None:
    _allocators["stream"] = (alloc, free)


def populate_platform() -> dict:
    """reference: hs_populate_platform (src/hs_compile.h): describes the
    execution target — the CUDA card when there is one."""
    import torch

    if torch.cuda.is_available():
        return {"platform": "cuda",
                "device_kind": torch.cuda.get_device_name(0),
                "num_devices": torch.cuda.device_count()}
    return {"platform": "none", "device_kind": "none", "num_devices": 0}


def valid_platform() -> bool:
    """True if a CUDA device is available (reference: hs_valid_platform)."""
    import torch

    return torch.cuda.is_available()


# --- compile ----------------------------------------------------------------


def compile(expression: str, flags: int = 0, mode: int = HS_MODE_BLOCK) -> Database:
    """Single-pattern compile (reference: hs_compile, src/hs.cpp:412)."""
    return compile_patterns([expression], [flags], [0], mode)


def compile_multi(
    expressions: Sequence[str],
    flags: Optional[Sequence[int]] = None,
    ids: Optional[Sequence[int]] = None,
    mode: int = HS_MODE_BLOCK,
    platform: Optional[dict] = None,
) -> Database:
    """Multi-pattern compile (reference: hs_compile_multi, src/hs.cpp:438)."""
    return compile_patterns(expressions, flags, ids, mode,
                            platform=platform)


def compile_ext_multi(
    expressions: Sequence[str],
    flags: Optional[Sequence[int]] = None,
    ids: Optional[Sequence[int]] = None,
    ext: Optional[Sequence[Optional[ExprExt]]] = None,
    mode: int = HS_MODE_BLOCK,
    platform: Optional[dict] = None,
) -> Database:
    """Compile with extended parameters (reference: hs_compile_ext_multi,
    src/hs.cpp:450)."""
    return compile_patterns(expressions, flags, ids, mode, ext=ext,
                            platform=platform)


def compile_lit(expression: bytes, flags: int = 0, mode: int = HS_MODE_BLOCK) -> Database:
    """Pure-literal compile (reference: hs_compile_lit)."""
    return compile_patterns([expression], [flags], [0], mode, literal=True)


def compile_lit_multi(
    expressions: Sequence[bytes],
    flags: Optional[Sequence[int]] = None,
    ids: Optional[Sequence[int]] = None,
    mode: int = HS_MODE_BLOCK,
) -> Database:
    """Pure-literal multi compile (reference: hs_compile_lit_multi)."""
    return compile_patterns(expressions, flags, ids, mode, literal=True)


# --- scan -------------------------------------------------------------------


def scan(
    db: Database,
    data: bytes,
    callback: Optional[Callable[[int, int, int, int], int]] = None,
    scratch: Optional[Scratch] = None,
    device="cuda",
) -> List[Match]:
    """Block-mode scan (reference: hs_scan, src/runtime.c:316).

    Returns the ordered match list [(id, from, to), ...]; if `callback` is
    given it is invoked per match and a nonzero return stops delivery
    (HS_SCAN_TERMINATED semantics). Runs on the CUDA card unless
    `device` names another torch device (the tests pass "cpu")."""
    matches, _terminated = scan_block(db, data, callback, scratch, device)
    return matches


# --- scratch ---------------------------------------------------------------


def alloc_scratch(db: Database, capacity: int = 4096) -> Scratch:
    """reference: hs_alloc_scratch (src/scratch.c)."""
    del db  # capacity policy is database-independent for now
    return Scratch(capacity=capacity)


def clone_scratch(scratch: Scratch) -> Scratch:
    return scratch.clone()


def scratch_size(scratch: Scratch) -> int:
    """reference: hs_scratch_size. The device wrappers allocate their own
    buffers, so the scratch's host footprint is its match-capacity
    policy, counted as the JAX package counts it (pos + value rows,
    int32, plus the record sink bookkeeping)."""
    return scratch.capacity * 3 * 4


# --- serialization ----------------------------------------------------------


def serialize_database(db: Database) -> bytes:
    return db.serialize()


def deserialize_database(data: bytes) -> Database:
    return Database.deserialize(data)


def database_size(db: Database) -> int:
    return db.size()


def database_info(db: Database) -> str:
    return db.info()


def serialized_database_size(data: bytes) -> int:
    return len(data)


def serialized_database_info(data: bytes) -> str:
    return Database.deserialize(data).info()


# --- expression info ---------------------------------------------------------


def expression_info(expression: str, flags: int = 0) -> dict:
    """reference: hs_expression_info (src/hs.cpp). Returns width and
    behavior info for one pattern without building a database."""
    validate_flags(flags)
    node = _parse(expression, flags)
    g = build_nfa(node)
    min_w, max_w = _nfa_widths(g)
    return {
        "min_width": min_w,
        "max_width": max_w if max_w is not None else 0xFFFFFFFF,
        "unordered_matches": False,
        "matches_at_eod": bool(g.accept_eod)
        or any(eod for (_a, eod, _adj) in g.start_accepts),
        "matches_only_at_eod": bool(g.accept_eod) and not g.accept,
    }


def expression_ext_info(expression: str, flags: int = 0,
                        ext: Optional[ExprExt] = None) -> dict:
    """reference: hs_expression_ext_info — width info adjusted for the
    extended parameters (min/max offset clamp widths; edit/Hamming
    distance widens them, src/hs.cpp)."""
    info = expression_info(expression, flags)
    if ext is None:
        return info
    min_w, max_w = info["min_width"], info["max_width"]
    if ext.edit_distance:
        min_w = max(0, min_w - ext.edit_distance)
        if max_w != 0xFFFFFFFF:
            max_w = max_w + ext.edit_distance
    if ext.min_length:
        min_w = max(min_w, ext.min_length)
    if ext.max_offset != UNBOUNDED and max_w != 0xFFFFFFFF:
        # a match cannot be wider than its end offset bound
        max_w = min(max_w, ext.max_offset)
    if max_w != 0xFFFFFFFF and min_w > max_w:
        min_w = max_w
    info["min_width"], info["max_width"] = min_w, max_w
    return info


# --- lifecycle / size compat entry points ------------------------------------
# Memory is garbage-collected (host) / owned by torch (device), so the
# free_* calls are documented no-ops, exactly like the allocator hooks
# (reference: hs_free_database / hs_free_scratch / hs_free_compile_error,
# src/hs_common.h, src/hs_compile.h).


def free_database(db) -> None:
    """reference: hs_free_database — no-op (GC-owned)."""


def free_scratch(scratch) -> None:
    """reference: hs_free_scratch — no-op (GC-owned)."""


def free_compile_error(err) -> None:
    """reference: hs_free_compile_error — no-op (GC-owned)."""


def stream_size(db: Database) -> int:
    """Per-stream state footprint for this database (reference:
    hs_stream_size, src/hs_common.h:201): the compress_stream size of a
    stream whose history is at its maximum (history_required) with no
    dynamic chain/SOM evidence. Needs no device."""
    from .runtime.stream import history_required

    s = open_stream(db, device="cpu")
    s.history = b"\x00" * history_required(db)
    return len(compress_stream(s))


def deserialize_database_at(buf: bytes, db=None) -> Database:
    """reference: hs_deserialize_database_at (src/hs_common.h:143):
    deserialize into caller-provided storage. Python owns object
    memory, so this is deserialize_database; a `db` argument is
    ignored (compat shim, like the allocator hooks)."""
    return deserialize_database(buf)


# --- C-style aliases ---------------------------------------------------------

hs_set_allocator = set_allocator
hs_set_database_allocator = set_database_allocator
hs_set_misc_allocator = set_misc_allocator
hs_set_scratch_allocator = set_scratch_allocator
hs_set_stream_allocator = set_stream_allocator
hs_open_stream = open_stream
hs_scan_stream = scan_stream
hs_close_stream = close_stream
hs_reset_stream = reset_stream
hs_copy_stream = copy_stream
hs_compress_stream = compress_stream
hs_expand_stream = expand_stream
hs_reset_and_expand_stream = reset_and_expand_stream
hs_reset_and_copy_stream = reset_and_copy_stream
hs_free_database = free_database
hs_free_scratch = free_scratch
hs_free_compile_error = free_compile_error
hs_serialized_database_size = serialized_database_size
hs_stream_size = stream_size
hs_deserialize_database_at = deserialize_database_at
hs_scan_vector = scan_vector
hs_compile_ext_multi = compile_ext_multi
hs_alloc_scratch = alloc_scratch
hs_clone_scratch = clone_scratch
hs_database_size = database_size
hs_expression_info = expression_info
hs_populate_platform = populate_platform
hs_valid_platform = valid_platform
hs_compile = compile
hs_compile_multi = compile_multi
hs_compile_lit = compile_lit
hs_compile_lit_multi = compile_lit_multi
hs_scan = scan
hs_serialize_database = serialize_database
hs_deserialize_database = deserialize_database
hs_database_info = database_info
hs_version = version

