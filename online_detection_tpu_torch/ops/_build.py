"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface and loaded with ``ctypes``. The build runs at
first use, from the package's own sources, into ``_build/`` beside this
package; the library's file name carries a hash of its sources, so an edited
source is rebuilt and an unchanged one is loaded as it is.

Nothing here runs at import time: this module is imported on hosts with no
``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources(name: str):
    return [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh"))


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in _sources(name):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start_build(name: str):
    """Start nvcc for one library; returns (process, tmp path, final path),
    or None when the library is already built."""
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, out


def _finish_build(name: str, started) -> str:
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return log


def build_all(names: Iterable[str]) -> Dict[str, str]:
    """Build the named libraries in parallel (one nvcc each, all started
    together); returns each build's compiler log ("" where it was cached)."""
    names = list(names)
    started = {n: _start_build(n) for n in names}
    logs = {}
    try:
        for n in names:
            logs[n] = "" if started[n] is None else _finish_build(n, started[n])
    finally:
        for s in started.values():  # stop any nvcc left after a failure
            if s is not None and s[0].poll() is None:
                s[0].kill()
                s[0].wait()
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``lib<name>``, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(str(_lib_path(name)))
            _LIBS[name] = lib
        return lib


#: kernel name -> launches since the last reset. Each wrapper adds one where
#: it launches its kernel, and nowhere else.
LAUNCHES: Dict[str, int] = {"gaussian_mmv": 0, "tf32_split": 0, "stem_pool": 0,
                            "roi_align": 0, "roi_align_fused2": 0, "roi_align_backward": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def check(status: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status}")
