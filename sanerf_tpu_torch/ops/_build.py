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
SOURCES = ("ray_kernels", "fused_mlp_t", "gather", "hashgrid")
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


def _lib_path(name: str, csrc: Path = None, build_dir: Path = None) -> Path:
    csrc, build_dir = csrc or CSRC, build_dir or BUILD_DIR
    h = hashlib.sha256()
    for p in sorted(csrc.glob("*.cuh")) + [csrc / f"{name}.cu"]:
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str, csrc: Path = None, build_dir: Path = None):
    """-> (final path, Popen or None when already built): csrc/<name>.cu
    (CSRC by default) into build_dir (BUILD_DIR)."""
    csrc, build_dir = csrc or CSRC, build_dir or BUILD_DIR
    out = _lib_path(name, csrc, build_dir)
    if out.exists():
        return out, None
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(csrc / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, (proc, tmp)


def _finish(name: str, out: Path, job) -> str:
    """-> nvcc's log of the library at `out`, kept beside it (the same name,
    .log; and as <name>.log, the last build's): a library built before
    gives the log of its own build."""
    if job is None:
        log = out.with_suffix(".log")
        return log.read_text() if log.exists() else ""
    proc, tmp = job
    log, _ = proc.communicate()
    (out.parent / f"{name}.log").write_text(log)
    out.with_suffix(".log").write_text(log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)
    return log


def build_all() -> Dict[str, str]:
    """Compile every kernel source in parallel; -> {name: nvcc log} (of
    the build before, where the library was built already)."""
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
