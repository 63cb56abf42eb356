"""Build and load the port's CUDA kernels.

Every `csrc/*.cu` source is compiled by `nvcc` for sm_90a into its own
shared library with a plain C interface, at first use, and loaded with
ctypes (`csrc/*.cuh` holds code that several sources include). Sources
that are not built yet are compiled all at once, one `nvcc` process
each. The libraries go to `hyperscan_tpu_torch/build/`
under a name keyed by a hash of the source, the shared headers and the
flags, so an edited source or header is rebuilt and an unchanged one is
reused. A failed build raises
with the compiler's output; nothing falls back to the plain versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, Optional

_PKG = pathlib.Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
# -split-compile=0: the device code of a source is optimised in as many
# threads as the host has cores (the sources with many template instances
# are the long pole of a cold build)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-split-compile=0", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}

# launches per kernel, counted by each wrapper where it launches its
# kernel and nowhere else (a run shows it went through the kernels)
LAUNCHES = {"teddy_filter_compact": 0, "teddy_hash_confirm": 0,
            "dfa_scan": 0, "dfa_scan_rows": 0, "nfa_layered": 0,
            "teddy_gate": 0,
            "teddy_rescan_rows": 0, "teddy_kconfirm": 0,
            "teddy_filter_plane": 0, "plane_extract": 0,
            "teddy_words_count": 0, "teddy_words_list": 0,
            "teddy_kconfirm_stage": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def sources() -> Dict[str, pathlib.Path]:
    """Kernel name -> source path, for every source in csrc/."""
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin and PATH)")
    return found


def library_path(name: str) -> pathlib.Path:
    src = sources()[name]
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    tag = hashlib.sha256(src.read_bytes() + headers
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}_{tag}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile the named kernels (all by default) that are not built yet,
    one nvcc process each, all started together. Returns the wall
    seconds of each compile that ran; the ptxas report of each build is
    kept beside its library as `<name>_<tag>.log`."""
    names = list(sources()) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        so = library_path(name)
        if so.exists():
            continue
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(sources()[name])]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT),
            time.perf_counter(), tmp, so)
    took = {}
    failed = []
    for name, (proc, t0, tmp, so) in procs.items():
        out, _ = proc.communicate()
        took[name] = time.perf_counter() - t0
        text = out.decode(errors="replace")
        if proc.returncode != 0:
            failed.append(f"{name}:\n{text}")
            continue
        so.with_suffix(".log").write_text(text)
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return took


def library(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built first if needed."""
    with _lock:
        if name not in _libs:
            build([name])
            _libs[name] = ctypes.CDLL(str(library_path(name)))
        return _libs[name]
