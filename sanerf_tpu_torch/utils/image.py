"""Image I/O and resizes without OpenCV (JAX package: cv2 in
data/provider.py:_load_image, data/rays.py:get_incoherent_mask,
models/sam/predictor.py:set_image).

- `read_png`: 8-bit gray / RGB / RGBA PNGs, non-interlaced, every filter
  (0-4), decoded with zlib and numpy; channels in RGB(A) order.
- `load_image`: what the provider's `_load_image` returns: RGB(A) uint8,
  gray repeated to three channels, an integer `downscale` by area.
  Formats other than PNG (JPEG, ...) go through PIL where it imports.
- `resize(img, (w, h), interpolation)`: cv2.resize's definitions for
  "linear", "area" and "nearest", on uint8 and float32 arrays [H, W] or
  [H, W, C]:
    * linear: half-pixel centres, src = (d + 0.5) * in / out - 0.5
      (uint8, and float32 of one row or column: rounded to float32, then
      its fraction; other float32: the fraction in float64, then
      rounded); columns
      clamped to the edge (weight 1 on the edge pixel), rows clamped by
      index with their unclamped weights, as cv2 does. uint8 in cv2's
      11-bit fixed point: horizontal taps round(w * 2048) summed in int,
      vertical ((h >> 4) * b >> 16) per tap, then (sum + 2) >> 2;
      float32 in float32. An exact 2x shrink on both axes is area.
    * area (shrinking only): an integer factor k averages k x k blocks
      (uint8: (sum + 2) >> 2 for k = 2, else rint(sum * (1 / k^2)) in
      float32); other factors weight each source pixel by its overlap.
    * nearest: src = floor(d * (1 / (out / in))), clamped.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Tuple

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}  # PNG colour type -> channels


def _unfilter(raw: np.ndarray, H: int, W: int, bpp: int) -> np.ndarray:
    stride = W * bpp
    rows = raw.reshape(H, stride + 1)
    out = np.zeros((H, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(H):
        ft, line = rows[y, 0], rows[y, 1:].astype(np.int32)
        if ft == 0:
            cur = line
        elif ft == 1:  # Sub: a running sum per channel
            cur = np.cumsum(line.reshape(W, bpp), axis=0).reshape(-1)
        elif ft == 2:  # Up
            cur = line + prev
        elif ft in (3, 4):  # Average, Paeth: sequential along the row
            cur = np.zeros(stride, np.int32)
            left = np.zeros(bpp, np.int32)
            for x in range(0, stride, bpp):
                up = prev[x:x + bpp]
                if ft == 3:
                    pred = (left + up) >> 1
                else:
                    ul = prev[x - bpp:x] if x else np.zeros(bpp, np.int32)
                    p = left + up - ul
                    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
                    pred = np.where((pa <= pb) & (pa <= pc), left,
                                    np.where(pb <= pc, up, ul))
                left = (line[x:x + bpp] + pred) & 255
                cur[x:x + bpp] = left
        else:
            raise ValueError(f"PNG filter type {ft} is not defined")
        cur = cur & 255
        out[y] = cur
        prev = cur
    return out


def read_png(path: str) -> np.ndarray:
    """An 8-bit, non-interlaced gray / RGB / RGBA PNG -> uint8 [H, W]
    (gray) or [H, W, 3 | 4] in RGB(A) order."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIG:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if hdr is None:
        raise ValueError(f"{path}: PNG without IHDR")
    W, H, depth, ctype, _, _, interlace = hdr
    if depth != 8 or ctype not in _CHANNELS or interlace:
        raise ValueError(
            f"{path}: PNG of bit depth {depth}, colour type {ctype}, "
            f"interlace {interlace}; read_png takes 8-bit gray / RGB / RGBA, "
            "non-interlaced")
    C = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    img = _unfilter(raw, H, W, C).reshape(H, W, C)
    return img[..., 0] if C == 1 else img


def _read_other(path: str) -> np.ndarray:
    """A non-PNG image as RGB(A) uint8 through PIL."""
    try:
        from PIL import Image
    except ImportError:
        raise RuntimeError(
            f"{path}: format {os.path.splitext(path)[1] or '(none)'} needs "
            "PIL, which does not import; PNG files are read without it"
        ) from None
    with Image.open(path) as im:
        if im.mode not in ("L", "RGB", "RGBA"):
            im = im.convert("RGBA" if "A" in im.mode else "RGB")
        return np.asarray(im)


def load_image(path: str, downscale: int = 1) -> np.ndarray:
    """The provider's image: uint8 [H, W, 3 | 4] RGB(A); gray repeated to
    three channels; `downscale` > 1 shrinks to (W // d, H // d) by area."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    with open(path, "rb") as f:
        is_png = f.read(8) == _PNG_SIG
    img = read_png(path) if is_png else _read_other(path)
    if img.ndim == 2:
        img = img[..., None].repeat(3, -1)
    if downscale > 1:
        img = resize(img, (img.shape[1] // downscale,
                           img.shape[0] // downscale), "area")
    return img


# -- resizes ------------------------------------------------------------------


def _linear_tab(src: int, dst: int, clamp: bool, early: bool):
    """(i0, i1, w0, w1) float32 weights of cv2's linear taps per output;
    the source coordinate is rounded to float32 before its fraction is
    taken with `early` (cv2's uint8 route), after it otherwise."""
    f = (np.arange(dst) + 0.5) * (src / dst) - 0.5
    if early:
        f = f.astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s).astype(np.float32)
    if clamp:  # columns: an edge output reads the edge pixel alone
        lo, hi = s < 0, s >= src - 1
        f[lo | hi] = 0
        s[lo] = 0
        s[hi] = src - 1
    w0, w1 = np.float32(1) - f, f
    return (np.clip(s, 0, src - 1), np.clip(s + 1, 0, src - 1), w0, w1)


def _linear(img: np.ndarray, w: int, h: int) -> np.ndarray:
    H, W = img.shape[:2]
    fixed = img.dtype == np.uint8
    # cv2 rounds the coordinate first also for a float32 source of one row
    # or column
    early = fixed or H == 1 or W == 1
    x0, x1, a0, a1 = _linear_tab(W, w, True, early)
    y0, y1, b0, b1 = _linear_tab(H, h, False, early)
    ext = (slice(None),) + (None,) * (img.ndim - 2)  # along columns
    vext = (slice(None),) + (None,) * (img.ndim - 1)  # along rows
    if fixed:
        q = lambda v: np.rint(v * np.float32(2048)).astype(np.int64)  # noqa
        a0, a1, b0, b1 = q(a0), q(a1), q(b0), q(b1)
        im = img.astype(np.int64)
        rows = (im[:, x0] * a0[(None,) + ext] + im[:, x1] * a1[(None,) + ext]
                ) >> 4
        out = (((rows[y0] * b0[vext]) >> 16) + ((rows[y1] * b1[vext]) >> 16)
               + 2) >> 2
        return np.clip(out, 0, 255).astype(np.uint8)
    im = img.astype(np.float32)
    rows = im[:, x0] * a0[(None,) + ext] + im[:, x1] * a1[(None,) + ext]
    return (rows[y0] * b0[vext] + rows[y1] * b1[vext]).astype(np.float32)


def _area_tab(src: int, dst: int):
    """cv2's computeResizeAreaTab: [(dst index, src index, weight)] in
    cv2's order."""
    scale = src / dst
    tab = []
    for dx in range(dst):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cellw = min(scale, src - fsx1)
        sx1, sx2 = int(np.ceil(fsx1)), int(np.floor(fsx2))
        sx2 = min(sx2, src - 1)
        sx1 = min(sx1, sx2)
        if sx1 - fsx1 > 1e-3:
            tab.append((dx, sx1 - 1, (sx1 - fsx1) / cellw))
        for sx in range(sx1, sx2):
            tab.append((dx, sx, 1.0 / cellw))
        if fsx2 - sx2 > 1e-3:
            tab.append((dx, sx2, min(min(fsx2 - sx2, 1.0), cellw) / cellw))
    return tab


def _area(img: np.ndarray, w: int, h: int) -> np.ndarray:
    H, W = img.shape[:2]
    if w > W or h > H:
        raise NotImplementedError("area resize only shrinks")
    kx, ky = W / w, H / h
    if kx == int(kx) and ky == int(ky):
        kx, ky = int(kx), int(ky)
        blocks = img[:h * ky, :w * kx].reshape(
            h, ky, w, kx, *img.shape[2:])
        if img.dtype == np.uint8:
            s = blocks.astype(np.int64).sum(axis=(1, 3))
            if kx == ky == 2:
                return ((s + 2) >> 2).astype(np.uint8)
            v = s.astype(np.float32) * np.float32(1.0 / (kx * ky))
            return np.clip(np.rint(v), 0, 255).astype(np.uint8)
        b = blocks.astype(np.float32)
        s = b[:, 0, :, 0]
        for dy in range(ky):
            for dx in range(kx):
                if dy or dx:
                    s = s + b[:, dy, :, dx]
        return (s * np.float32(1.0 / (kx * ky))).astype(np.float32)
    xt, yt = _area_tab(W, w), _area_tab(H, h)
    im = img.astype(np.float32)
    rows = np.zeros((H, w) + img.shape[2:], np.float32)
    for dx, sx, a in xt:
        rows[:, dx] += im[:, sx] * np.float32(a)
    out = np.zeros((h, w) + img.shape[2:], np.float32)
    for dy, sy, b in yt:
        out[dy] += rows[sy] * np.float32(b)
    if img.dtype == np.uint8:
        return np.clip(np.rint(out), 0, 255).astype(np.uint8)
    return out


def _nearest(img: np.ndarray, w: int, h: int) -> np.ndarray:
    H, W = img.shape[:2]
    # cv2 steps by 1 / (out / in), which can sit an ulp below in / out
    xs = np.minimum(np.floor(np.arange(w) * (1.0 / (w / W))).astype(np.int64),
                    W - 1)
    ys = np.minimum(np.floor(np.arange(h) * (1.0 / (h / H))).astype(np.int64),
                    H - 1)
    return img[ys][:, xs]


def resize(img: np.ndarray, dsize: Tuple[int, int],
           interpolation: str = "linear") -> np.ndarray:
    """cv2.resize(img, dsize=(w, h), interpolation) for "linear", "area"
    and "nearest" on uint8 / float32 [H, W] or [H, W, C] (module
    docstring)."""
    if img.dtype not in (np.uint8, np.float32):
        raise TypeError(f"resize takes uint8 or float32, not {img.dtype}")
    w, h = int(dsize[0]), int(dsize[1])
    H, W = img.shape[:2]
    if (h, w) == (H, W):
        return img.copy()
    if interpolation == "linear":
        if W == 2 * w and H == 2 * h:
            return _area(img, w, h)
        return _linear(img, w, h)
    if interpolation == "area":
        return _area(img, w, h)
    if interpolation == "nearest":
        return _nearest(img, w, h)
    raise ValueError(f"interpolation {interpolation!r}")
