"""Per-level ray geometry: `ray_level0` and `ray_level`, and the
`flatten3_nt` relayout (JAX: sanerf_tpu/ops/ray_kernels.py:275, :310 and
:247).

Each is a CUDA kernel (csrc/ray_kernels.cu) with its plain PyTorch version
beside it. A CPU tensor takes the plain version; a CUDA tensor launches
the kernel or raises. Outputs keep the JAX layouts: bins [N, T+1],
ts [N, T], dl [N, T] and contracted coordinates x3 [3, N, T], all float32;
with `pack_q > 0` also ts and dl as [N/q, q*T, 1] rows (q rays per row,
the packed composite's feed; `pick_pack_q` picks q).

The math is the JAX kernels': uniform s-space bins (optionally jittered
and clipped) or the inverse-CDF resample of the previous level (pdf =
(w + 0.01) / sum, cdf by running sum, F^-1(u) at u = (j + 0.5) / K as a
sum of clamped ramps), then spacing_fn_inv, midpoints, deltas and the
L-inf contraction with its x-over-y-over-z tie-break.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from sanerf_tpu_torch.ops import _build

#: Shared memory a block may use on the H100; ray_plan's only limit.
SMEM_LIMIT = 232448
#: csrc/ray_kernels.cu: warps a block of the warp-per-ray kernels, rays a
#: block of ray_level's thread-per-ray kernel (at most), samples a tile of
#: ray_level0's tile kernel (R T <= L0_SAMPLES, R % 4 == 0, R >= 4), and
#: the thread kernel's static rays8 rows
WARPS, RAYS, L0_SAMPLES, L0_MAX_RAYS = 8, 32, 1024, 256
THREAD_STATIC = RAYS * 8 * 4
QUEUE_B = "still to port: ROADMAP.md, queue B"

Out = Tuple[torch.Tensor, ...]


def ray_plan(T: int, T0: Optional[int] = None, jittered: bool = False,
             uniform_prev: bool = False) -> dict:
    """Whether the ray kernels take a level of T samples (ray_level0, or
    ray_level after a level of T0), and the plan they launch it with:
    ray_level0's tile of R rays and the shared memory of its tile and warp
    kernels; ray_level's warps a block of its warp kernel and rays a block
    of its thread kernel, each with its shared memory. The rays' rows sit
    in shared memory, so a level's length is bounded only by SMEM_LIMIT;
    past it this raises NotImplementedError naming ROADMAP.md's queue B.
    The wrappers launch through it."""
    if T < 1 or (T0 is not None and T0 < 1):
        raise ValueError(f"ray kernels: T={T}, T0={T0}")
    K = T + 1
    if T0 is None:
        R = max(4, min(L0_MAX_RAYS, L0_SAMPLES // T) & ~3)
        plan = {"R": R,
                "tile_smem": 4 * (R * K * (2 if jittered else 1) + 8 * R + K),
                "warp_smem": 4 * WARPS * K}
        fits = max(plan["tile_smem"], plan["warp_smem"]) <= SMEM_LIMIT
    else:
        per_warp = 4 * (4 * T0 + K + 2)
        per_ray = 4 * (((max(T0, T) + 1) | 1) + (K | 1)
                       + (0 if uniform_prev else (T0 + 1) | 1))
        plan = {"warps": min(WARPS, SMEM_LIMIT // per_warp),
                "rays": min(RAYS, (SMEM_LIMIT - THREAD_STATIC) // per_ray)}
        plan["warp_smem"] = plan["warps"] * per_warp
        plan["thread_smem"] = plan["rays"] * per_ray
        fits = plan["warps"] >= 1 and plan["rays"] >= 1
    if not fits:
        raise NotImplementedError(
            f"ray kernels: a level of T={T} samples (T0={T0}) does not fit "
            f"{SMEM_LIMIT} B of shared memory ({QUEUE_B})")
    return plan


def _div(x: torch.Tensor, k: int) -> torch.Tensor:
    """x / k rounded as one division, like the kernels. (PyTorch's CUDA
    division by a Python number multiplies by its rounded reciprocal, one
    ulp off for k that is not a power of two.)"""
    return x / torch.full((), float(k), dtype=x.dtype, device=x.device)


def _spacing_inv(x):
    return torch.where(x < 0.5, 2.0 * x,
                       1.0 / torch.clamp(2.0 - 2.0 * x, min=1e-12))


def _contract_planes(x, y, z):
    """L-inf contraction on [N, T] planes (JAX: ray_kernels.py:47-63)."""
    ax, ay, az = x.abs(), y.abs(), z.abs()
    mag = torch.maximum(torch.maximum(ax, ay), az)
    inv = 1.0 / torch.clamp(mag, min=1e-12)
    dom = (2.0 - inv) * inv
    is_x = ax == mag
    is_y = (ay == mag) & ~is_x
    is_z = ~(is_x | is_y)
    inside = mag < 1.0
    cx = torch.where(inside, x, x * torch.where(is_x, dom, inv))
    cy = torch.where(inside, y, y * torch.where(is_y, dom, inv))
    cz = torch.where(inside, z, z * torch.where(is_z, dom, inv))
    return cx, cy, cz


def _level_body(rays8, bins, contract: bool):
    sn, sf = rays8[:, 6:7], rays8[:, 7:8]
    rb = _spacing_inv(sn * (1.0 - bins) + sf * bins)
    ts = 0.5 * (rb[:, 1:] + rb[:, :-1])
    dl = rb[:, 1:] - rb[:, :-1]
    x = rays8[:, 0:1] + rays8[:, 3:4] * ts
    y = rays8[:, 1:2] + rays8[:, 4:5] * ts
    z = rays8[:, 2:3] + rays8[:, 5:6] * ts
    if contract:
        x, y, z = _contract_planes(x, y, z)
    return ts, dl, torch.stack([x, y, z])


def _resample(w_prev, bins_prev, K: int, u_jitter=None):
    """Inverse-CDF resample to K edges; bins_prev None = uniform [0, 1].

    The three sums over the previous level (pdf total, cdf, ramp sum) run
    in index order, as the kernel's do: the metric deltas downstream are
    differences of nearly equal edges, so a different summation order
    alone would move them by more than the 1e-5 the two are held to."""
    N, T0 = w_prev.shape
    w = w_prev + 0.01
    total = torch.zeros_like(w[:, 0])
    for i in range(T0):
        total = total + w[:, i]
    pdf = w / total[:, None]
    acc = torch.zeros_like(total)
    cols = [acc]
    for i in range(T0):
        acc = acc + pdf[:, i]
        cols.append(torch.clamp(acc, max=1.0))
    cdf = torch.stack(cols, dim=1)
    c_lo = cdf[:, :T0]
    recip = 1.0 / torch.clamp(cdf[:, 1:] - c_lo, min=1e-12)
    u = _div(torch.arange(K, dtype=torch.float32, device=w.device) + 0.5, K)
    u = u.expand(N, K)
    if u_jitter is not None:
        u = u + u_jitter
    db = None if bins_prev is None else bins_prev[:, 1:] - bins_prev[:, :-1]
    out = torch.zeros_like(u)
    for i in range(T0):  # one interval's ramps at a time: O(N K) memory
        frac = torch.clamp((u - c_lo[:, i:i + 1]) * recip[:, i:i + 1],
                           0.0, 1.0)
        out = out + (frac if db is None else frac * db[:, i:i + 1])
    return _div(out, T0) if db is None else bins_prev[:, 0:1] + out


def pick_pack_q(T: int, n_rays: int) -> int:
    """Packing factor of the packed epilogue: the largest power of two q
    with q*T <= 128, halved until it divides n_rays. 1 = no packing."""
    q = 1
    while 2 * q * T <= 128:
        q *= 2
    while q > 1 and n_rays % q:
        q //= 2
    return q


def _check_pack(N: int, pack_q: int) -> None:
    """The rule of the JAX `_pick_block`: a block holds whole packed rows,
    so q must divide the ray count."""
    if pack_q < 0 or (pack_q and N % pack_q):
        raise ValueError(f"pack_q={pack_q} must be 0 or divide N={N}")


def _pack_rows(v: torch.Tensor, q: int) -> torch.Tensor:
    """(N, T) -> (N/q, q*T, 1): ray n in slot n % q of row n / q."""
    N, T = v.shape
    return v.reshape(N // q, q * T, 1).clone()


def _with_packed(out, pack_q: int) -> Out:
    if not pack_q:
        return out
    _, ts, dl, _ = out
    return (*out, _pack_rows(ts, pack_q), _pack_rows(dl, pack_q))


def ray_level0_plain(rays8, T: int, contract: bool = True,
                     jitter: Optional[torch.Tensor] = None,
                     pack_q: int = 0) -> Out:
    N = rays8.shape[0]
    _check_pack(N, pack_q)
    bins = _div(torch.arange(T + 1, dtype=torch.float32, device=rays8.device),
                T).expand(N, T + 1)
    if jitter is not None:
        bins = torch.clamp(bins + jitter, 0.0, 1.0)
    ts, dl, x3 = _level_body(rays8, bins, contract)
    return _with_packed((bins.contiguous(), ts, dl, x3), pack_q)


def ray_level_plain(rays8, w_prev, bins_prev, T: int, contract: bool = True,
                    uniform_prev: bool = False,
                    jitter: Optional[torch.Tensor] = None,
                    pack_q: int = 0) -> Out:
    _check_pack(rays8.shape[0], pack_q)
    bins = _resample(w_prev, None if uniform_prev else bins_prev, T + 1,
                     jitter)
    ts, dl, x3 = _level_body(rays8, bins, contract)
    return _with_packed((bins, ts, dl, x3), pack_q)


def flatten3_nt_plain(x3: torch.Tensor) -> torch.Tensor:
    """[3, N, T] -> [3, N*T] as a new tensor."""
    return x3.reshape(3, -1).clone()


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _lib():
    lib = _build.load("ray_kernels")
    _build.declare(lib, "ray_level0_launch",
                   [_P, _P, _I, _I, _I, _P, _P, _P, _P, _I, _P, _P, _I, _P])
    _build.declare(lib, "ray_level_launch",
                   [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P,
                    _I, _P, _P, _I, _I, _P])
    _build.declare(lib, "flatten3_launch", [_P, ctypes.c_long, _P, _P])
    return lib


def _check(t: torch.Tensor, name: str, shape) -> None:
    if not t.is_cuda or t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(f"{name}: needs a contiguous float32 CUDA tensor, "
                         f"got {t.dtype} on {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")
    if t.device != torch.device("cuda", torch.cuda.current_device()):
        raise ValueError(f"{name}: on {t.device}, not the current device")


def _outputs(N: int, T: int, like: torch.Tensor, pack_q: int):
    e = lambda *s: torch.empty(s, dtype=torch.float32, device=like.device)  # noqa: E731
    outs = (e(N, T + 1), e(N, T), e(N, T), e(3, N, T))
    if pack_q:
        outs += (e(N // pack_q, pack_q * T, 1), e(N // pack_q, pack_q * T, 1))
    return outs


def _pack_args(outs, pack_q: int):
    if not pack_q:
        return [0, None, None]
    return [pack_q, outs[4].data_ptr(), outs[5].data_ptr()]


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _raise_on(code: int, fn: str) -> None:
    if code != 0:
        raise RuntimeError(f"{fn}: CUDA error {code} at launch")


def ray_level0(rays8: torch.Tensor, T: int, contract: bool = True,
               jitter: Optional[torch.Tensor] = None, pack_q: int = 0) -> Out:
    """Level-0 geometry. rays8 [N, 8] = (o, d, s_near, s_far); jitter
    optional [N, T+1] per-edge offsets ((u - 0.5) / T). -> (bins [N, T+1],
    ts [N, T], dl [N, T], x3 [3, N, T]), and with pack_q > 0 also
    (ts_p, dl_p) [N/q, q*T, 1]."""
    if not rays8.is_cuda:
        return ray_level0_plain(rays8, T, contract, jitter, pack_q)
    N = rays8.shape[0]
    plan = ray_plan(T, jittered=jitter is not None)
    _check_pack(N, pack_q)
    _check(rays8, "rays8", (N, 8))
    if jitter is not None:
        _check(jitter, "jitter", (N, T + 1))
    outs = _outputs(N, T, rays8, pack_q)
    if N:
        code = _lib().ray_level0_launch(
            rays8.data_ptr(), _ptr(jitter), N, T, int(contract),
            *[o.data_ptr() for o in outs[:4]], *_pack_args(outs, pack_q),
            plan["R"], torch.cuda.current_stream().cuda_stream)
        _raise_on(code, "ray_level0")
        ray_level0.launches += 1
        if pack_q:
            ray_level0.packed_launches += 1
    return outs


ray_level0.launches = 0
ray_level0.packed_launches = 0


def ray_level(rays8: torch.Tensor, w_prev: torch.Tensor,
              bins_prev: torch.Tensor, T: int, contract: bool = True,
              uniform_prev: bool = False,
              jitter: Optional[torch.Tensor] = None, pack_q: int = 0) -> Out:
    """Level i > 0: inverse-CDF resample against the previous level's
    weights [N, T0] and edges [N, T0+1] (`uniform_prev`: those edges are the
    analytic uniform grid), then the geometry of ray_level0. jitter:
    optional [N, T+1] offsets of u ((u - 0.5) / (T + 1)). pack_q as in
    ray_level0."""
    if not rays8.is_cuda:
        return ray_level_plain(rays8, w_prev, bins_prev, T, contract,
                               uniform_prev, jitter, pack_q)
    N, T0 = w_prev.shape
    plan = ray_plan(T, T0, uniform_prev=uniform_prev)
    _check_pack(N, pack_q)
    _check(rays8, "rays8", (N, 8))
    _check(w_prev, "w_prev", (N, T0))
    _check(bins_prev, "bins_prev", (N, T0 + 1))
    if jitter is not None:
        _check(jitter, "jitter", (N, T + 1))
    outs = _outputs(N, T, rays8, pack_q)
    if N:
        code = _lib().ray_level_launch(
            rays8.data_ptr(), w_prev.data_ptr(), bins_prev.data_ptr(),
            _ptr(jitter), N, T0, T, int(contract), int(uniform_prev),
            *[o.data_ptr() for o in outs[:4]], *_pack_args(outs, pack_q),
            plan["warps"], plan["rays"],
            torch.cuda.current_stream().cuda_stream)
        _raise_on(code, "ray_level")
        ray_level.launches += 1
        if pack_q:
            ray_level.packed_launches += 1
    return outs


ray_level.launches = 0
ray_level.packed_launches = 0


def flatten3_nt(x3: torch.Tensor) -> torch.Tensor:
    """[3, N, T] -> [3, N*T] float32, a new tensor (the ray kernels'
    coordinate planes as the MLP kernels' flat feed)."""
    if not x3.is_cuda:
        return flatten3_nt_plain(x3)
    if x3.dim() != 3 or x3.shape[0] != 3:
        raise ValueError(f"flatten3_nt: x3 must be [3, N, T], got "
                         f"{tuple(x3.shape)}")
    _check(x3, "x3", x3.shape)
    out = torch.empty(3, x3.shape[1] * x3.shape[2], dtype=torch.float32,
                      device=x3.device)
    if out.numel():
        code = _lib().flatten3_launch(x3.data_ptr(), out.numel(),
                                      out.data_ptr(),
                                      torch.cuda.current_stream().cuda_stream)
        _raise_on(code, "flatten3_nt")
        flatten3_nt.launches += 1
    return out


flatten3_nt.launches = 0
