"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` compiles with nvcc into its own shared library with a
plain C interface, loaded with ctypes (no PyTorch headers, so a build takes
seconds). Builds happen at first use, into `build/kernels/` beside the
package (listed in .gitignore), named by a hash of the sources so an edited
source rebuilds. `build_all()` starts one nvcc per source, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("ray_kernels", "fused_mlp_t", "gather")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
    # no contraction of a*b+c into FMA: the kernels round like the plain
    # PyTorch versions they are held against
    "-fmad=false",
    "-Xptxas", "-v",
]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """-> (final path, Popen or None when already built)."""
    out = _lib_path(name)
    if out.exists():
        return out, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, (proc, tmp)


def _finish(name: str, out: Path, job) -> str:
    if job is None:
        return ""
    proc, tmp = job
    log, _ = proc.communicate()
    (BUILD_DIR / f"{name}.log").write_text(log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)
    return log


def build_all() -> Dict[str, str]:
    """Compile every kernel source in parallel; -> {name: nvcc log}."""
    with _lock:
        jobs = {n: _start(n) for n in SOURCES}
        return {n: _finish(n, *jobs[n]) for n in SOURCES}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            out, job = _start(name)
            _finish(name, out, job)
            lib = _libs[name] = ctypes.CDLL(str(out))
        return lib


def declare(lib: ctypes.CDLL, fn: str, argtypes: List) -> None:
    f = getattr(lib, fn)
    f.argtypes = argtypes
    f.restype = ctypes.c_int
