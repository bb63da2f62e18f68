"""ctypes bindings for the native (C++) prefetching ray-batch sampler (JAX:
sanerf_tpu/data/native_loader.py).

`sanerf_tpu_torch/native/dataloader.cpp` is built with g++ at first use
into build/native/ (listed in .gitignore), named by a hash of the source,
the flags and the host's CPU model, so an edited source, or another
host's -march=native, rebuilds. `NativeRaySampler` is a drop-in
for a dataset's `collate_train`: worker threads draw (image, pixel)
samples, compute the rays with data/rays.py's conventions and keep a ring
of ready batches. Batch k is drawn from a xorshift RNG seeded from (seed,
k) alone and the batches come out in their order, so one seed gives the
same batches with any number of threads. `available()` is False when no
compiler or no build is there.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

import numpy as np

SRC = Path(__file__).resolve().parents[1] / "native" / "dataloader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
         "-pthread"]
_lock = threading.Lock()
_lib = None
_error: Optional[str] = None

_f32p = ctypes.POINTER(ctypes.c_float)


def _cpu() -> bytes:
    """The host's CPU model: a -march=native build runs only where it was
    built."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("model name", "flags")):
                    return line.encode()
    except OSError:
        pass
    return platform.processor().encode()


def _lib_path() -> Path:
    h = hashlib.sha256(SRC.read_bytes() + " ".join(FLAGS).encode() + _cpu())
    return BUILD_DIR / f"libsanerf_data-{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    subprocess.run(["g++", *FLAGS, str(SRC), "-o", str(tmp)], check=True,
                   capture_output=True, text=True)
    os.replace(tmp, out)


def load_library() -> Optional[ctypes.CDLL]:
    """Build (once) and dlopen the library; None if that fails (the
    reason in `build_error()`)."""
    global _lib, _error
    with _lock:
        if _lib is not None:
            return _lib
        try:
            out = _lib_path()
            if not out.exists():
                _build(out)
            lib = ctypes.CDLL(str(out))
        except (OSError, subprocess.CalledProcessError) as e:
            _error = (e.stderr if isinstance(e, subprocess.CalledProcessError)
                      else str(e))
            return None
        lib.snl_create.restype = ctypes.c_void_p
        lib.snl_create.argtypes = [
            _f32p, _f32p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_uint64,
            ctypes.c_int, ctypes.c_int]
        lib.snl_next.argtypes = [ctypes.c_void_p, _f32p, _f32p, _f32p,
                                 ctypes.POINTER(ctypes.c_int)]
        lib.snl_ready_count.restype = ctypes.c_int
        lib.snl_ready_count.argtypes = [ctypes.c_void_p]
        lib.snl_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    return load_library() is not None


def build_error() -> Optional[str]:
    return _error


class NativeRaySampler:
    """Background-threaded uniform ray-batch sampler over preloaded images.

    poses [M, 4, 4] OpenGL c2w; intrinsics [4] or [M, 4]; images
    [M, H, W, 3] float in [0, 1] or uint8 (kept as uint8: colours come back
    quantised to 1/255); other shapes raise ValueError."""

    def __init__(self, poses: np.ndarray, intrinsics: np.ndarray,
                 images: np.ndarray, num_rays: int, seed: int = 0,
                 prefetch_depth: int = 4, n_threads: int = 2):
        lib = load_library()
        if lib is None:
            raise RuntimeError(f"native dataloader unavailable: {_error}")
        self._lib = lib
        if images.ndim != 4 or images.shape[-1] != 3:
            # the sampler reads 3 bytes a pixel; an RGBA scene takes the
            # numpy collate, which composites the alpha
            raise ValueError(f"images of shape {images.shape}: the native "
                             "sampler takes [M, H, W, 3]")
        M, H, W = images.shape[:3]
        self.num_rays = num_rays
        self.H, self.W = H, W
        if images.dtype != np.uint8:
            images = (np.clip(images, 0, 1) * 255).astype(np.uint8)
        intr = np.asarray(intrinsics, np.float32)
        if intr.ndim == 1:
            intr = np.broadcast_to(intr, (M, 4))
        self._poses = np.ascontiguousarray(poses, np.float32).reshape(M, 16)
        self._intr = np.ascontiguousarray(intr, np.float32)
        self._imgs = np.ascontiguousarray(images)
        self._handle = lib.snl_create(
            self._poses.ctypes.data_as(_f32p), self._intr.ctypes.data_as(_f32p),
            self._imgs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            M, H, W, num_rays, max(1, seed), prefetch_depth, n_threads)

    def next_batch(self) -> Dict[str, np.ndarray]:
        n = self.num_rays
        rays_o = np.empty((n, 3), np.float32)
        rays_d = np.empty((n, 3), np.float32)
        rgb = np.empty((n, 3), np.float32)
        idx = ctypes.c_int(0)
        self._lib.snl_next(self._handle, rays_o.ctypes.data_as(_f32p),
                           rays_d.ctypes.data_as(_f32p),
                           rgb.ctypes.data_as(_f32p), ctypes.byref(idx))
        return {"rays_o": rays_o, "rays_d": rays_d, "images": rgb,
                "index": int(idx.value), "H": self.H, "W": self.W}

    def collate_train(self, rng=None, num_rays: Optional[int] = None):
        """The provider's signature; `rng` is unused (the native RNGs)."""
        return self.next_batch()

    def ready_count(self) -> int:
        return int(self._lib.snl_ready_count(self._handle))

    def close(self):
        if getattr(self, "_handle", None):
            self._lib.snl_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
