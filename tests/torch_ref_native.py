"""Build the JAX package's native library once, under a file lock, before
any test runs.

`hyperscan_tpu.native` compiles every process into the same
`libhstpu_<tag>.so.tmp` in its cache directory and then renames it, so
two test workers that start with a cold cache race, and one fails with
FileNotFoundError. The port's parity test files import this module, which
builds the library under a lock when it is first imported: every xdist
worker collects every file before it runs a test, so the first worker
builds the library and the others wait for it, then find the finished
`.so`.
"""

import fcntl
import os
import pathlib


def hold_build_lock() -> None:
    import hyperscan_tpu.native as native

    cache = pathlib.Path(
        os.environ.get("XDG_CACHE_HOME", os.path.expanduser("~/.cache"))
    ) / "hyperscan_tpu"
    cache.mkdir(parents=True, exist_ok=True)
    with open(cache / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            native.get_lib()
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


hold_build_lock()
