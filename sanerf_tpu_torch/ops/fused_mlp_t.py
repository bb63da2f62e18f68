"""Fused encode + MLP chain: `run_tmlp` and `run_tmlp_composite`
(JAX: sanerf_tpu/ops/fused_mlp_t.py:481 and :978).

Each is a CUDA kernel (csrc/fused_mlp_t.cu) with its plain PyTorch version
beside it; both kernels share one device function for the encode and the
chain, as `_encode_and_chain` is shared in JAX. A CPU tensor takes the
plain version; a CUDA tensor launches the kernel or raises.

What they compute, per point x (contracted coordinates, [3, P] layout):
  - the Fourier encode by angle doubling: z = x * pi / bound, one sin and
    one cos (= sin(z + pi/2)) at the base frequency, then s' = 2sc,
    c' = c^2 - s^2 for each further frequency, in the tight column order of
    ops/freq.py: [z, s_0, c_0, s_1, c_1, ...]; or with `angle_double=False`
    the dense-sin encode of the JAX package's make_enc_consts, the same
    columns as sin(z 2^f) and sin(z 2^f + pi/2);
  - optional factorized-grid features appended to the encoding, in the
    order of fields.position_features: CP line features of each level of a
    CP ladder (coarse -> fine), then VM plane x line features of each level
    of a VM ladder (3 modes each); the component sums of the sigma-CP and
    sigma-VM tables added to output row 0 (direct density);
  - the MLP chain, the skip layer as a second product over the encoding,
    an optional float32 bias added to each layer's sum, leaky 0.01 or ReLU
    between layers; activations are rounded to the weight type between
    layers, the products accumulate in float32. Layers may be up to 512
    wide (MAX_WIDTH), nets up to MAX_LAYERS deep.
`run_tmlp` returns the last layer transposed, [kout, P]. The composite
variant treats P = N * T points as N rays of T samples and returns per-ray
sums: density softplus(row0 - 1), alpha (last sample opaque when asked),
exclusive-cumsum transmittance, NaN weights -> 0, gsum [N, kout], depth
[N], weights_sum [N]; with a view MLP also the SH (degree <= 4) + view MLP
head on the per-ray sums and its sigmoid, rgb [N, 3]. With `pack_q > 1` the
composite reads dl/ts as the ray kernels' packed [N/q, q*T, 1] rows. Rays
of any T, up to MAX_GSUM outputs, view heads up to MAX_VIEW_WIDTH wide.

`kernel_plan` is the guard every launch goes through: whether the kernels
take a net (with a view head and rays of T samples for the composite) and
the plan they launch it with; past the limits that stay it raises
NotImplementedError naming ROADMAP.md's queue B.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Sequence

import numpy as np
import torch

from sanerf_tpu_torch.ops import _build
from sanerf_tpu_torch.ops.composite import exclusive_cumsum
from sanerf_tpu_torch.ops.freq import HALF_PI
from sanerf_tpu_torch.ops.sh import sh_components
from sanerf_tpu_torch.ops.vmgrid import vm_read

#: The most layers a net may have: the layer table is a kernel parameter,
#: and the parameter space's budget sets this (csrc/fused_mlp_t.cu:
#: MAX_LAYERS).
MAX_LAYERS = 32
#: Widest layer output the kernels take: one accumulator of 16 n-tiles of 8
#: holds 128, a wider layer runs as up to four such chunks.
MAX_WIDTH = 512
#: floats per layer of the kernels' bias rows (csrc/fused_mlp_t.cu:BIAS_LD)
BIAS_LD = MAX_WIDTH
#: The composite's general epilogue: per-ray sums of up to MAX_GSUM outputs
#: (16 lanes, a column of each 16-column group a lane) and a view head of up
#: to MAX_VIEW_WIDTH hidden units (32 a lane group, four groups).
MAX_GSUM = 64
MAX_VIEW_WIDTH = 128
#: Shared memory a block may use on the H100.
SMEM_LIMIT = 232448
#: Where a limit of the kernels stays, what it says.
QUEUE_B = "still to port: ROADMAP.md, queue B"

# the kernels' fixed shapes (csrc/fused_mlp_t.cu): points a warpgroup tile,
# accumulators a thread, outputs a chunk of a wide layer, the float32
# encoding's row padding; the composite's whole-ray steps take at most
# MAX_STEP points, longer rays run in segments of SEGMENTS points (the
# largest whose buffers fit); a streamed V_WIDE weight unit is UNIT_K
# columns of a chunk
TILE, NA, CHUNK, PAD, MAX_STEP = 64, 64, 128, 8, 448
SEGMENTS = (256, 128, 64)
UNIT_K = 64
W_GLOBAL, W_ALL, W_STREAM = 0, 1, 2
V_SERVED, V_BRANCHES, V_WIDE = 0, 1, 2
SMALL_K, SMALL_N = 64, 32


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _f32(v: float) -> float:
    return float(np.float32(v))


def _scale_off(R: int, bound: float):
    """[-bound, bound] -> [0, R-1] grid coordinate affine, as float32."""
    return _f32((R - 1) / (2.0 * bound)), _f32((R - 1) / 2.0)


def _levels(t) -> list:
    """A table or a ladder (list of levels) -> list of levels."""
    if t is None:
        return []
    return list(t) if isinstance(t, (list, tuple)) else [t]


class TransposedFieldMLP:
    """One encode + MLP chain, checked once and packed once for the kernel.

    layers: [{"w": [in, out], "b": [out] (optional)}, ...]; layer `l in
    skip_layers` takes [hidden, encoding] as input; biases are kept in
    float32, as the JAX package's pack_tmlp keeps them. `angle_double`
    False takes the dense-sin encode (no grid tables then, as in JAX). The factorized grids, each a table or a
    ladder (a list of levels, coarse -> fine): cp_lines [3, R, K];
    vm_planes [3, R, R, K] with vm_lines [3, Rl, K]; sigma_cp_lines and
    sigma_vm_planes / sigma_vm_lines single tables. The encoding is [Fourier,
    CP levels, VM levels (3 modes each)]; the sigma tables' component sum
    goes to output row 0. All weights and tables share one dtype (float32
    or bfloat16)."""

    def __init__(self, layers, enc_freqs: int, bound: float,
                 skip_layers: Sequence[int] = (), leaky: bool = False,
                 cp_lines=None, sigma_cp_lines: Optional[torch.Tensor] = None,
                 vm_planes=None, vm_lines=None,
                 sigma_vm_planes: Optional[torch.Tensor] = None,
                 sigma_vm_lines: Optional[torch.Tensor] = None,
                 angle_double: bool = True):
        self.ws = [p["w"] for p in layers]
        self.bs = ([p.get("b") for p in layers]
                   if any("b" in p for p in layers) else None)
        self.angle_double = bool(angle_double)
        self.enc_freqs = enc_freqs
        self.bound = bound
        self.skip = tuple(skip_layers)
        self.leaky = leaky
        self.scale = _f32(math.pi / bound)
        self.F = 3 * (1 + 2 * enc_freqs)
        self.cp = _levels(cp_lines)
        planes, lines = _levels(vm_planes), _levels(vm_lines)
        if len(planes) != len(lines):
            raise ValueError("vm_planes and vm_lines need as many levels")
        self.vm = list(zip(planes, lines))
        self.scp = sigma_cp_lines
        self.svm = (None if sigma_vm_planes is None
                    else (sigma_vm_planes, sigma_vm_lines))
        if (sigma_vm_planes is None) != (sigma_vm_lines is None):
            raise ValueError("sigma_vm_planes and sigma_vm_lines go together")
        for p, l in self.vm + ([self.svm] if self.svm else []):
            if (p.dim() != 4 or l.dim() != 3 or p.shape[0] != 3
                    or p.shape[1] != p.shape[2] or l.shape[0] != 3
                    or l.shape[2] != p.shape[3]):
                raise ValueError(f"VM level: planes {tuple(p.shape)} and "
                                 f"lines {tuple(l.shape)} do not match")
        if not self.angle_double and self.tables:
            raise ValueError("grid features require the angle-doubling "
                             "encode")
        self.dtype = self.ws[0].dtype
        for t in self.ws + self.tables:
            if t.dtype != self.dtype:
                raise ValueError("weights and tables must share one dtype")
        self.kc = (sum(int(t.shape[2]) for t in self.cp)
                   + sum(3 * int(p.shape[3]) for p, _ in self.vm))
        if self.ws[0].shape[0] != self.F + self.kc:
            raise ValueError(f"layer 0 takes {self.ws[0].shape[0]} inputs, "
                             f"the encoding has {self.F + self.kc}")
        self.kout = int(self.ws[-1].shape[1])
        self._packed = self._bias = self._layout = self._levels = None
        self._plans = {}
        self._parks = {}

    @property
    def tables(self):
        """Every grid table, in the order of the kernel's descriptor."""
        out = list(self.cp) + [t for pl in self.vm for t in pl]
        if self.scp is not None:
            out.append(self.scp)
        if self.svm is not None:
            out += list(self.svm)
        return out

    @property
    def table_bytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.tables)

    # -- plain PyTorch version ------------------------------------------------

    def forward_plain(self, xT: torch.Tensor,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """xT [3, P] -> last layer [P, kout] in `dtype`, the arithmetic
        from the float32 coordinates on (float64: the reference that float32
        chains are measured against); activations are rounded to the weight
        type between layers in either."""
        rnd = lambda v: v.to(self.dtype).to(dtype)  # noqa: E731
        x = xT.float().T
        z = (x * self.scale).to(dtype)
        s, c = torch.sin(z), torch.sin(z + HALF_PI)
        cols = [z]
        for f in range(self.enc_freqs):
            if not self.angle_double:  # z 2^f is exact
                s, c = torch.sin(z * 2.0 ** f), torch.sin(z * 2.0 ** f
                                                          + HALF_PI)
            elif f:
                s, c = 2.0 * s * c, c * c - s * s
            cols += [s, c]
        cols += [_cp_plain(t, x, self.bound, dtype) for t in self.cp]
        cols += [_vm_plain(p, l, x, self.bound, dtype) for p, l in self.vm]
        enc = rnd(torch.cat(cols, dim=1))
        sig = None
        if self.scp is not None:
            sig = _cp_plain(self.scp, x, self.bound, dtype).sum(dim=1)
        if self.svm is not None:
            s_vm = _vm_plain(*self.svm, x, self.bound, dtype).sum(dim=1)
            sig = s_vm if sig is None else sig + s_vm
        h = enc
        for l, w in enumerate(self.ws):
            w = w.to(dtype)
            if l in self.skip:
                hid = h.shape[1]
                acc = h @ w[:hid] + enc @ w[hid:]
            else:
                acc = h @ w
            if self.bs is not None and self.bs[l] is not None:
                acc = acc + self.bs[l].float().to(dtype)
            if l == len(self.ws) - 1:
                if sig is not None:
                    acc = torch.cat([acc[:, :1] + sig[:, None], acc[:, 1:]], 1)
                return acc
            acc = (torch.where(acc >= 0, acc, 0.01 * acc) if self.leaky
                   else torch.clamp(acc, min=0.0))
            h = rnd(acc)
        raise AssertionError("unreachable")

    # -- kernel operands --------------------------------------------------------

    def layout(self):
        """(int32 descriptor, weight elements) of the packed net: the
        header [n_layers, leaky, enc_freqs, F, ke, hmax] and per layer
        [kin_h, kin_e, kout, kout_real, w_off, w_ld] (packed())."""
        if self._layout is not None:
            return self._layout
        n = len(self.ws)
        ke = _round_up(self.F + self.kc, 16)
        desc, off, kprev, kprev_real = [], 0, ke, None
        for l, w in enumerate(self.ws):
            fin, fout = (int(d) for d in w.shape)
            kin_h = kprev
            kin_e = ke if l in self.skip and l > 0 else 0
            if kin_e and fin != kprev_real + self.F + self.kc:
                raise ValueError(f"skip layer {l} takes {fin} inputs")
            if not kin_e and l and fin != kprev_real:
                raise ValueError(f"layer {l} takes {fin} inputs, "
                                 f"layer {l - 1} gives {kprev_real}")
            kout = _round_up(fout, 16)
            ld = kin_h + kin_e
            desc += [kin_h, kin_e, kout, fout, off, ld]
            off += _round_up(kout * ld, 64)
            kprev, kprev_real = kout, fout
        hmax = max(desc[6 * l + 2] for l in range(n))
        head = [n, int(self.leaky), self.enc_freqs, self.F, ke, hmax]
        self._layout = (np.asarray(head + desc, np.int32), off)
        return self._layout

    def packed(self, device: torch.device):
        """(flat weights, int32 descriptor) for csrc/fused_mlp_t.cu, built
        once per device. Each layer is its transpose W^T [kout_pad][kin_h +
        kin_e], the skip layer's encoding block from column kin_h; the
        encoding width is padded to ke = 16k. Every slab is `core_matrices`
        (w_ld = kin_h + kin_e), 128-byte aligned: what wgmma reads B from in
        bfloat16, and in float32 what the 3xTF32 chain's lanes read their
        mma.sync B fragments from (lane 4g + t the float2 at 2 lane of a
        block: W^T row 8 nt + g, columns 8 s + 2t and 8 s + 2t + 1)."""
        if self._packed is not None and self._packed[0].device == device:
            return self._packed
        desc, w_elems = self.layout()
        slabs = []
        for l, w in enumerate(self.ws):
            kin_h, kin_e, kout, fout, _, ld = (
                int(v) for v in desc[6 + 6 * l:12 + 6 * l])
            fin = int(w.shape[0])
            wt = torch.zeros(kout, ld, dtype=torch.float32)
            wf = w.detach().float().cpu()
            if kin_e:
                hid = int(desc[6 + 6 * (l - 1) + 3])
                wt[:fout, :hid] = wf[:hid].T
                wt[:fout, kin_h:kin_h + fin - hid] = wf[hid:].T
            else:
                wt[:fout, :fin] = wf.T
            slabs.append(core_matrices(wt))
            slabs.append(torch.zeros(_round_up(kout * ld, 64) - kout * ld))
        flat = torch.cat(slabs).to(self.dtype).to(device)
        assert flat.numel() == w_elems
        self._packed = (flat, desc)
        return self._packed

    def grid_levels(self, device: torch.device) -> torch.Tensor:
        """The ladders' levels past the descriptor's slots, CP then VM, as
        the kernels read them from device memory (csrc/fused_mlp_t.cu:
        Grids.cp_more, vm_more), built once per device."""
        if self._levels is None or self._levels.device != device:
            raw = bytes(_levels_array(self))
            self._levels = torch.frombuffer(bytearray(raw) or bytearray(1),
                                            dtype=torch.uint8).to(device)
        return self._levels

    def bias_rows(self, device: torch.device) -> Optional[torch.Tensor]:
        """The biases as the kernels read them, float32 [n_layers, BIAS_LD]
        zero-padded (a layer without one zero), or None for a bias-free net;
        built once per device."""
        if self.bs is None:
            return None
        if self._bias is None or self._bias.device != device:
            rows = torch.zeros(len(self.ws), BIAS_LD)
            for l, b in enumerate(self.bs):
                if b is not None:
                    rows[l, :b.numel()] = b.detach().float().cpu()
            self._bias = rows.to(device)
        return self._bias


def encode_probes(tm: TransposedFieldMLP) -> list:
    """One-layer nets over tm's tables that read its encoding back: output
    row j + 1 of probe i is encoding column 15 i + j (zero past the
    encoding's width), row 0 the sigma tables' sum alone. Through them a
    kernel is held feature by feature against the plain version, where
    tm's own chain can flatten a wrong feature into a small error."""
    width = tm.F + tm.kc
    grids = dict(cp_lines=tm.cp, vm_planes=[p for p, _ in tm.vm],
                 vm_lines=[l for _, l in tm.vm], sigma_cp_lines=tm.scp,
                 sigma_vm_planes=tm.svm[0] if tm.svm else None,
                 sigma_vm_lines=tm.svm[1] if tm.svm else None)
    probes = []
    for c0 in range(0, width, 15):
        w = torch.zeros(width, 16)
        for j in range(min(15, width - c0)):
            w[c0 + j, j + 1] = 1.0
        probes.append(TransposedFieldMLP(
            [{"w": w.to(tm.dtype).to(tm.ws[0].device)}], tm.enc_freqs,
            tm.bound, angle_double=tm.angle_double, **grids))
    return probes


def core_matrices(wt: torch.Tensor) -> torch.Tensor:
    """W^T [N, K] (both multiples of 8) -> flat, as wgmma reads B from shared
    memory K-major without swizzle (csrc/wgmma.cuh), and as the float32
    chain's lanes read mma.sync's B fragments: 8x8 core matrices of rows
    8n.. and columns 8k.., each row-major, core matrix (k, n) at element
    (k * N/8 + n) * 64."""
    N, K = wt.shape
    return wt.reshape(N // 8, 8, K // 8, 8).permute(2, 0, 1, 3).reshape(-1)


def _grid_coords(x: torch.Tensor, R: int, bound: float):
    """u = clamp(x * s + o, 0, R - 1), the kernel's affine -> (i0, i1 [P, 3]
    long, frac [P, 3])."""
    s_, o_ = _scale_off(R, bound)
    u = torch.clamp(x * s_ + o_, 0.0, R - 1.0)
    fl = torch.floor(u)
    i0 = fl.long()
    return i0, torch.clamp(i0 + 1, max=R - 1), u - fl


def _vm_plain(planes: torch.Tensor, lines: torch.Tensor, x: torch.Tensor,
              bound: float, dtype: torch.dtype = torch.float32):
    """VM features [P, 3K] (ops/vmgrid.py:vm_read) at the kernel's
    affine."""
    return vm_read(planes, lines, _grid_coords(x, planes.shape[1], bound),
                   _grid_coords(x, lines.shape[1], bound), dtype)


def _cp_plain(lines: torch.Tensor, x: torch.Tensor, bound: float,
              dtype: torch.dtype = torch.float32):
    """CP features [P, K] by 2-tap interpolation at u = x * s + o, the
    kernel's affine (ops/cpgrid.py:line_features rounds u another way; at
    millions of points the 1-ulp difference in u shows in the float32
    comparison of the kernel with this version)."""
    i0, i1, f = _grid_coords(x, lines.shape[1], bound)
    f = f.to(dtype)
    feat = None
    for a in range(3):
        la = lines[a].to(dtype)
        fa = la[i0[:, a]] * (1.0 - f[:, a:a + 1]) + la[i1[:, a]] * f[:, a:a + 1]
        feat = fa if feat is None else feat * fa
    return feat


class ViewMLP:
    """Per-ray view head of the composite epilogue: SH(degree) of the
    normalized ray direction scaled by weights_sum, concatenated after the
    geo-feature sums (gsum columns 1..kout-1), then a bias-free ReLU MLP."""

    def __init__(self, view_layers, kout: int, sh_degree: int = 4):
        if any("b" in p for p in view_layers):
            raise NotImplementedError("biased layers are not in the port")
        self.w1 = view_layers[0]["w"]
        self.rest = [p["w"] for p in view_layers[1:]]
        self.degree = sh_degree
        self.sh_dim = sh_degree * sh_degree
        self.geo = kout - 1
        self.H = int(self.w1.shape[1])
        if self.w1.shape[0] != self.geo + self.sh_dim:
            raise ValueError("view layer 0 must take [geo, sh] inputs")
        if not self.rest or int(self.rest[-1].shape[1]) != 3:
            raise ValueError("the view MLP must end in 3 outputs")
        self.dtype = self.w1.dtype
        self._packed = None

    def forward_plain(self, gsum, wsum, rays8, dtype=torch.float32):
        rnd = lambda x: x.to(self.dtype).to(dtype)  # noqa: E731
        d = rays8[:, 3:6].to(dtype)
        dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
        inv = torch.rsqrt(dx * dx + dy * dy + dz * dz + 1e-20)
        sh = torch.stack(sh_components(dx * inv, dy * inv, dz * inv,
                                       self.degree), dim=1)
        w1 = self.w1.to(dtype)
        h = (rnd(gsum[:, 1:1 + self.geo]) @ w1[:self.geo]
             + rnd(wsum[:, None] * sh) @ w1[self.geo:])
        for w in self.rest:
            h = rnd(torch.clamp(h, min=0.0)) @ w.to(dtype)
        return 1.0 / (1.0 + torch.exp(-h))

    def elems(self) -> int:
        """Elements of packed()'s flat weights."""
        H = self.H
        return _round_up((self.geo + 1 + self.sh_dim) * H
                         + len(self.rest) * H * H, 8)

    def packed(self, device: torch.device):
        """[VG (geo+1 rows, row 0 zero) | VS (sh_dim rows) | rest layers
        padded to H x H], all [in][out]; plus (H, n_rest, sh_dim, degree)."""
        if self._packed is not None and self._packed[0].device == device:
            return self._packed
        H = self.H
        w1 = self.w1.detach().float().cpu()
        vg = torch.zeros(self.geo + 1, H)
        vg[1:] = w1[:self.geo]
        parts = [vg.reshape(-1), w1[self.geo:].reshape(-1)]
        for w in self.rest:
            wf = w.detach().float().cpu()
            if wf.shape[0] != H or wf.shape[1] > H:
                raise NotImplementedError("view layers must be H x (<= H)")
            slab = torch.zeros(H, H)
            slab[:, :wf.shape[1]] = wf
            parts.append(slab.reshape(-1))
        flat = torch.cat(parts)
        flat = torch.cat([flat, torch.zeros(_round_up(flat.numel(), 8)
                                            - flat.numel())])
        assert flat.numel() == self.elems()
        self._packed = (flat.to(self.dtype).to(device),
                        np.asarray([H, len(self.rest), self.sh_dim,
                                    self.degree], np.int32))
        return self._packed


# ---------------------------------------------------------------------------
# plain versions of the two kernels
# ---------------------------------------------------------------------------


def run_tmlp_plain(xT: torch.Tensor, tm: TransposedFieldMLP,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The plain version, in `dtype` arithmetic (TransposedFieldMLP.
    forward_plain)."""
    return tm.forward_plain(xT, dtype).T.contiguous()


def _unpack_rows(v: torch.Tensor, pack_q: int, T: Optional[int]):
    """dl/ts operand -> [N, T]: packed [N/q, q*T, 1] rows hold ray n in slot
    n % q of row n / q, so the [N, T] view is their row-major reshape."""
    if pack_q <= 1:
        return v
    if T is None:
        raise ValueError("pack_q > 1 needs T")
    if v.dim() != 3 or v.shape[1] != pack_q * T or v.shape[2] != 1:
        raise ValueError(f"packed operand must be [N/{pack_q}, {pack_q * T}, "
                         f"1], got {tuple(v.shape)}")
    return v.reshape(v.shape[0] * pack_q, T)


def run_tmlp_composite_plain(xT, dl, ts, tm: TransposedFieldMLP,
                             opaque: bool = True,
                             view: Optional[ViewMLP] = None, rays8=None,
                             pack_q: int = 1, T: Optional[int] = None,
                             dtype: torch.dtype = torch.float32):
    """The plain version, in `dtype` arithmetic from the float32 operands
    on (TransposedFieldMLP.forward_plain)."""
    dl, ts = _unpack_rows(dl, pack_q, T), _unpack_rows(ts, pack_q, T)
    dl, ts = dl.to(dtype), ts.to(dtype)
    N, T = dl.shape
    h3 = tm.forward_plain(xT, dtype).reshape(N, T, tm.kout)
    s = h3[..., 0] - 1.0
    sigma = torch.clamp(s, min=0.0) + torch.log1p(torch.exp(-s.abs()))
    ds = dl * sigma
    ds_a = ds
    if opaque:
        last = torch.arange(T, device=ds.device) == T - 1
        ds_a = torch.where(last, torch.full_like(ds, float("inf")), ds)
    alphas = 1.0 - torch.exp(-ds_a)
    w = alphas * torch.exp(-exclusive_cumsum(ds))
    w = torch.where(torch.isnan(w), torch.zeros_like(w), w)
    gsum = (h3 * w[..., None]).sum(dim=1)
    depth = (w * ts).sum(dim=1)
    wsum = w.sum(dim=1)
    if view is None:
        return gsum, depth, wsum
    return gsum, depth, wsum, view.forward_plain(gsum, wsum, rays8, dtype)


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_long, ctypes.c_float


class _Grid(ctypes.Structure):
    """A CP level (csrc/fused_mlp_t.cu:Grid): lines [3, R, K], u = x s + o."""
    _fields_ = [("table", _P), ("R", _I), ("K", _I), ("s", _F), ("o", _F)]


class _VMGrid(ctypes.Structure):
    """A VM level (csrc/fused_mlp_t.cu:VMGrid): planes [3, R, R, K] at
    u = x s + o, lines [3, Rl, K] at x sl + ol."""
    _fields_ = [("planes", _P), ("lines", _P), ("R", _I), ("Rl", _I),
                ("K", _I), ("s", _F), ("o", _F), ("sl", _F), ("ol", _F)]


#: Levels of a CP or a VM ladder the kernels' grid descriptor holds in its
#: fixed slots (kernel parameters); a ladder's levels past them are read
#: from device memory (TransposedFieldMLP.grid_levels).
INLINE_LEVELS = 8


class Grids(ctypes.Structure):
    """The kernels' grid descriptor, csrc/fused_mlp_t.cu:Grids: the first
    INLINE_LEVELS CP and VM levels in fixed slots (unused slots zero), the
    sigma tables (a null table is none), and the counts and device
    addresses of the levels past the slots (TransposedFieldMLP.
    grid_levels; null where there are none)."""
    _fields_ = [("n_cp", _I), ("n_vm", _I),
                ("cp", _Grid * INLINE_LEVELS),
                ("vm", _VMGrid * INLINE_LEVELS),
                ("scp", _Grid), ("svm", _VMGrid),
                ("n_cp_more", _I), ("n_vm_more", _I),
                ("cp_more", _P), ("vm_more", _P)]


class KernelPlan(ctypes.Structure):
    """The launch plan of a field kernel, csrc/fused_mlp_t.cu:Plan (made by
    kernel_plan): the shared-memory carve of a block (row strides, buffer
    bytes, warpgroups, where the weights and the view head live), the
    composite's steps (M points of R whole rays, or one ray in nseg
    segments of M), the V_WIDE weight unit and parked chunks, and the
    kernel: its variant, small_kernel, the general composite epilogue."""
    _fields_ = [(name, _I) for name in (
        "lde", "ldo", "M", "R", "ldh", "wgs", "w_mode", "w_bytes", "v_bytes",
        "enc_b", "h_b", "out_b", "sig_b", "wts_b", "ts_b", "vin_b", "per_wg",
        "total", "nseg", "vld", "unit_k", "park_chunks", "variant", "small",
        "general")]

    def as_dict(self) -> dict:
        return {name: getattr(self, name) for name, _ in self._fields_}

    def __repr__(self):
        return f"KernelPlan({self.as_dict()})"


def _align16(b: int) -> int:
    return (b + 15) & ~15


def _round_tile(n: int) -> int:
    return _round_up(n, TILE)


def _layer_rows(desc) -> list:
    """[(kin_h, kin_e, kout, kout_real, w_off, w_ld)] of a layout()."""
    return [tuple(int(v) for v in desc[6 + 6 * l:12 + 6 * l])
            for l in range(int(desc[0]))]


def _max_wgs(bf16: bool, composite: bool, variant: int) -> int:
    """csrc/fused_mlp_t.cu:wgs_of: the warpgroups a block starts from."""
    if variant == V_WIDE:
        return 2
    if bf16:
        return 4 if composite else 3
    return 2 if composite else 3


def _make_plan(layers, ke, es, w_elems, v_elems, wgs, M, R, ldo, composite,
               wide, w_mode, v_smem, unit_k=0, nseg=1, vld=128):
    """The shared-memory plan of one choice (csrc/fused_mlp_t.cu reads it as
    it is): the weights (all, or the largest streamed unit: a layer, a
    V_WIDE chunk of 128 rows, or unit_k columns of one), the view head,
    and per warpgroup the encoding, the hidden activations (V_WIDE), the
    last layer's outputs of a step, the sigma sums and the composite's
    weights, midpoints and view scratch."""
    p = KernelPlan(wgs=wgs, M=M, R=R, ldo=ldo, w_mode=w_mode, unit_k=unit_k,
                   nseg=nseg, vld=vld)
    p.lde = ke if es == 2 else ke + PAD
    rows_max = CHUNK if wide else MAX_WIDTH
    cols_max = unit_k if wide and unit_k else 1 << 30
    hw = max([L[2] for L in layers[:-1]], default=0)
    if w_mode == W_ALL:
        p.w_bytes = _align16(w_elems * es)
    elif w_mode == W_STREAM:
        p.w_bytes = max(_align16(min(L[2], rows_max) * min(L[5], cols_max)
                                 * es) for L in layers)
    p.v_bytes = _align16(v_elems * es) if v_elems and v_smem else 0
    p.enc_b = _align16(TILE * p.lde * es)
    p.ldh = hw if es == 2 else hw + PAD
    p.h_b = _align16(TILE * p.ldh * es) if wide else 0
    p.out_b = _align16(M * ldo * 4)
    p.sig_b = _align16(TILE * 4)
    p.wts_b = p.ts_b = _align16(M * 4) if composite else 0
    p.vin_b = 4 * vld * 4 if composite else 0
    p.per_wg = (p.enc_b + p.h_b + p.out_b + p.sig_b + p.wts_b + p.ts_b
                + p.vin_b)
    p.total = p.w_bytes + p.v_bytes + wgs * p.per_wg
    p.park_chunks = max(0, -(-hw // CHUNK) - 2) if wide else 0
    return p


def _fit(layers, ke, bf16, w_elems, v_elems, max_wgs, M, R, ldo, composite,
         wide, **kw):
    """The first plan that fits SMEM_LIMIT, or None. bf16 (wgmma reads B
    from shared memory) and V_WIDE nets: all the weights, with fewer
    warpgroups if need be, else streamed (bf16 V_WIDE: whole chunks, then
    units of UNIT_K columns), else (float32 only) read through L2. float32
    nets up to 128 wide: as many warpgroups as fit, with all the weights,
    else one layer at a time, else the weights read through L2. The view
    head in shared memory where it fits."""
    es = 2 if bf16 else 4

    def fits(w_mode, unit_k, wgs):
        for v_smem in ((True, False) if v_elems else (False,)):
            p = _make_plan(layers, ke, es, w_elems, v_elems, wgs, M, R, ldo,
                           composite, wide, w_mode, v_smem, unit_k, **kw)
            if p.total <= SMEM_LIMIT:
                return p
        return None

    wgs_down = range(max_wgs, 0, -1)
    if bf16 or wide:
        modes = [(W_ALL, 0)]
        if bf16:
            modes += [(W_STREAM, 0)] + ([(W_STREAM, UNIT_K)] if wide else [])
        else:
            modes += [(W_STREAM, UNIT_K), (W_GLOBAL, 0)]
        tries = [(m, u, w) for m, u in modes for w in wgs_down]
    else:
        tries = [(m, 0, w) for w in wgs_down
                 for m in (W_ALL, W_STREAM, W_GLOBAL)]
    for m, u, w in tries:
        p = fits(m, u, w)
        if p is not None:
            return p
    return None


def _step_of(T: int):
    """(M, R) of a whole-ray composite step: lcm(64, T) points where that
    is at most MAX_STEP; else the R whole rays of at most MAX_STEP points
    whose last tile has the smallest padded share, M = R T rounded up to
    whole tiles."""
    M = TILE // math.gcd(TILE, T) * T
    if M <= MAX_STEP:
        return M, M // T
    R = 1
    for r in range(2, MAX_STEP // T + 1):
        if r * _round_tile(R * T) > R * _round_tile(r * T):
            R = r
    return _round_tile(R * T), R


def _composite_steps(T: int, general: bool) -> list:
    """(M, R, nseg) choices of a composite step, in order of preference:
    whole rays (T <= 128), then with the general epilogue one ray a step in
    nseg segments of M points, the largest SEGMENTS first."""
    out = [(*_step_of(T), 1)] if T <= 128 else []
    if general:
        for seg in SEGMENTS:
            m = min(seg, _round_tile(T))
            c = (m, 1, -(-T // m))
            if c not in out:
                out.append(c)
    return out


def _view_scratch(G: int, H: int) -> int:
    """Floats of a warp's view scratch in the general epilogue
    (csrc/fused_mlp_t.cu:composite_kernel: rounded gsum, SH row, hidden
    activations, wsum)."""
    vh = (64 if G > 32 else 32) + 32
    return vh + max(48, H) + 16


def _is_small(tm: "TransposedFieldMLP", layers) -> bool:
    """The proposal nets' small_kernel: bf16, two layers no wider than 32
    over an encoding of at most 64, no tables, no bias, angle doubling."""
    return (tm.dtype == torch.bfloat16 and len(layers) == 2 and not tm.tables
            and tm.bs is None and tm.angle_double
            and layers[0][0] <= SMALL_K and layers[0][2] <= SMALL_N
            and not layers[1][1] and layers[1][2] <= SMALL_N)


def _refuse(what: str):
    raise NotImplementedError(f"field kernels: {what} ({QUEUE_B})")


def kernel_plan(tm: "TransposedFieldMLP", T: Optional[int] = None,
                view: Optional["ViewMLP"] = None) -> KernelPlan:
    """Whether the field kernels take tm, and the plan they launch it with:
    run_tmlp (T None), or run_tmlp_composite over rays of T samples with the
    view head `view`. Raises NotImplementedError, naming ROADMAP.md's queue
    B, for what they do not take; the wrappers launch through it, so no
    configuration reaches a kernel without a plan. Cached per net."""
    vkey = None if view is None else (view.H, len(view.rest), view.sh_dim,
                                      view.degree, view.elems())
    key = (T, vkey)
    if key in tm._plans:
        return tm._plans[key]
    if tm.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"kernel weights must be float32 or bfloat16, "
                         f"got {tm.dtype}")
    desc, w_elems = tm.layout()
    layers = _layer_rows(desc)
    if len(layers) > MAX_LAYERS:
        _refuse(f"{len(layers)} layers, the layer table holds {MAX_LAYERS}")
    hmax = int(desc[5])
    if hmax > MAX_WIDTH:
        _refuse(f"a layer of {hmax} outputs, past {MAX_WIDTH}")
    bf16 = tm.dtype == torch.bfloat16
    # the served variant: no bias, angle doubling, ladders within the
    # descriptor's slots (csrc/fused_mlp_t.cu: Variant)
    long_ladder = max(len(tm.cp), len(tm.vm)) > INLINE_LEVELS
    variant = (V_WIDE if hmax > CHUNK else
               V_BRANCHES if (tm.bs is not None or not tm.angle_double
                              or long_ladder) else V_SERVED)
    wide, ke = variant == V_WIDE, int(desc[4])
    kout, G = layers[-1][2], layers[-1][3]
    plan = None
    if T is None:
        if _is_small(tm, layers):
            plan = KernelPlan(small=1, M=TILE, nseg=1)
        else:
            plan = _fit(layers, ke, bf16, w_elems, 0,
                        _max_wgs(bf16, False, variant), TILE, 0, kout + 1,
                        False, wide)
    else:
        if T < 1:
            raise ValueError(f"composite: T={T}")
        H = v_elems = 0
        if view is not None:
            if view.dtype != tm.dtype or view.geo + 1 != tm.kout:
                raise ValueError("view head does not match the field")
            if view.degree > 4:
                raise NotImplementedError(
                    f"SH degree {view.degree} in the view head: the kernels "
                    f"of both packages evaluate degrees 1-4 "
                    f"(sanerf_tpu/ops/fused_mlp_t.py:653)")
            if view.H > MAX_VIEW_WIDTH:
                _refuse(f"a view head {view.H} wide, past {MAX_VIEW_WIDTH}")
            H, v_elems = view.H, view.elems()
        if G > MAX_GSUM:
            _refuse(f"a composite of {G} outputs, past {MAX_GSUM}")
        # the served composite: 16 outputs, a view head of at most 32,
        # whole rays of T <= 128, no parked chunks (hidden layers <= 256)
        hw = max([L[2] for L in layers[:-1]], default=0)
        needs_general = T > 128 or kout != 16 or H > 32 or hw > 2 * CHUNK
        for general in ((True,) if needs_general else (False, True)):
            for M, R, nseg in _composite_steps(T, general):
                plan = _fit(layers, ke, bf16, w_elems, v_elems,
                            _max_wgs(bf16, True, variant), M, R, kout + 1,
                            True, wide, nseg=nseg,
                            vld=_view_scratch(G, H) if general else 128)
                if plan is not None:
                    plan.general = int(general)
                    break
            if plan is not None:
                break
    if plan is None:
        _refuse(f"the buffers of one warpgroup do not fit {SMEM_LIMIT} B "
                f"of shared memory")
    plan.variant = variant
    tm._plans[key] = plan
    return plan


@functools.cache
def _lib():
    lib = _build.load("fused_mlp_t")
    if lib.grids_size() != ctypes.sizeof(Grids):
        raise RuntimeError("csrc/fused_mlp_t.cu:Grids and its ctypes mirror "
                           "differ in size")
    if lib.plan_size() != ctypes.sizeof(KernelPlan):
        raise RuntimeError("csrc/fused_mlp_t.cu:Plan and its ctypes mirror "
                           "differ in size")
    # bf16, layer descriptor, weights, their count, encode scale, angle
    # doubling, bias rows, &Grids, &Plan
    net = [_I, _P, _P, _I, _F, _I, _P, _P, _P]
    # ... xT, P, out, out rows, park, park bytes, stream
    _build.declare(lib, "tmlp_launch", net + [_P, _L, _P, _I, _P, _L, _P])
    # view (weights, count, descriptor), xT, dl, ts, rays8, N, T, pack_q,
    # opaque, gsum, depth, wsum, rgb, park, park bytes, stream
    _build.declare(lib, "tmlp_composite_launch",
                   net + [_P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                          _P, _P, _P, _P, _P, _L, _P])
    # bf16, composite, &Plan -> resident blocks
    _build.declare(lib, "park_blocks", [_I, _I, _P])
    lib.park_blocks.restype = _L
    return lib


def _check(t: torch.Tensor, name: str, shape, dtype=torch.float32) -> None:
    if not t.is_cuda or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name}: needs a contiguous {dtype} CUDA tensor, "
                         f"got {t.dtype} on {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")
    if t.device != torch.device("cuda", torch.cuda.current_device()):
        raise ValueError(f"{name}: on {t.device}, not the current device")


def _cp_grid(t: torch.Tensor, bound: float) -> _Grid:
    R = int(t.shape[1])
    return _Grid(t.data_ptr(), R, int(t.shape[2]), *_scale_off(R, bound))


def _vm_grid(planes: torch.Tensor, lines: torch.Tensor,
             bound: float) -> _VMGrid:
    R, Rl = int(planes.shape[1]), int(lines.shape[1])
    return _VMGrid(planes.data_ptr(), lines.data_ptr(), R, Rl,
                   int(planes.shape[3]), *_scale_off(R, bound),
                   *_scale_off(Rl, bound))


def _levels_array(tm: "TransposedFieldMLP") -> bytes:
    """The CP levels past the descriptor's slots as a Grid array, then the
    VM levels past them as a VMGrid array, each with its table addresses
    and the affine u = x * s + o of _scale_off."""
    cps = [_cp_grid(t, tm.bound) for t in tm.cp[INLINE_LEVELS:]]
    vms = [_vm_grid(p, l, tm.bound) for p, l in tm.vm[INLINE_LEVELS:]]
    return (bytes((_Grid * len(cps))(*cps))
            + bytes((_VMGrid * len(vms))(*vms)))


def grids_of(tm: TransposedFieldMLP, device=None) -> Grids:
    """tm's tables as the kernels' grid descriptor: the first INLINE_LEVELS
    levels of each ladder in the slots, the rest in tm.grid_levels(device)
    (the tables' device by default), the sigma tables in theirs."""
    cps, vms = tm.cp[:INLINE_LEVELS], tm.vm[:INLINE_LEVELS]
    g = Grids(n_cp=len(cps), n_vm=len(vms))
    for i, t in enumerate(cps):
        g.cp[i] = _cp_grid(t, tm.bound)
    for i, pl in enumerate(vms):
        g.vm[i] = _vm_grid(*pl, tm.bound)
    g.n_cp_more = len(tm.cp) - len(cps)
    g.n_vm_more = len(tm.vm) - len(vms)
    if g.n_cp_more or g.n_vm_more:
        base = tm.grid_levels(device or tm.tables[0].device).data_ptr()
        g.cp_more = base if g.n_cp_more else None
        g.vm_more = (base + ctypes.sizeof(_Grid) * g.n_cp_more
                     if g.n_vm_more else None)
    if tm.scp is not None:
        g.scp = _cp_grid(tm.scp, tm.bound)
    if tm.svm is not None:
        g.svm = _vm_grid(*tm.svm, tm.bound)
    return g


def _net_args(tm: TransposedFieldMLP, plan: KernelPlan, device):
    for t in tm.tables:
        _check(t, "grid table", t.shape, tm.dtype)
    flat, desc = tm.packed(device)
    bias = tm.bias_rows(device)
    grids = grids_of(tm, device)
    args = [int(tm.dtype == torch.bfloat16), desc.ctypes.data,
            flat.data_ptr(), flat.numel(), tm.scale, int(tm.angle_double),
            None if bias is None else bias.data_ptr(),
            ctypes.addressof(grids), ctypes.addressof(plan)]
    more = grids.n_cp_more or grids.n_vm_more
    return args, (flat, desc, bias, grids,
                  tm.grid_levels(device) if more else None)


def park_buffer(tm: TransposedFieldMLP, plan: KernelPlan, device,
                composite: bool):
    """(buffer, bytes) for the V_WIDE kernels' parked chunks: a slot of
    plan.park_chunks chunks for every warpgroup of the blocks the launch
    keeps resident (csrc/fused_mlp_t.cu:park_slot, park_blocks), built once
    per net, plan, device and stream (launches on one stream run in turn);
    or (None, 0)."""
    if not plan.park_chunks:
        return None, 0
    key = (bytes(plan), composite, device,
           torch.cuda.current_stream(device).cuda_stream)
    if key not in tm._parks:
        words = NA // 2 if tm.dtype == torch.bfloat16 else NA
        blocks = _lib().park_blocks(int(tm.dtype == torch.bfloat16),
                                    int(composite), ctypes.addressof(plan))
        nbytes = blocks * plan.wgs * plan.park_chunks * words * 128 * 4
        tm._parks[key] = (torch.empty(nbytes // 4, dtype=torch.int32,
                                      device=device), nbytes)
    return tm._parks[key]


def _raise_on(code: int, fn: str) -> None:
    if code == -1:
        raise RuntimeError(f"{fn}: the kernel refused its plan")
    if code != 0:
        raise RuntimeError(f"{fn}: CUDA error {code} at launch")


def run_tmlp(x: torch.Tensor, tm: TransposedFieldMLP,
             transposed: bool = False) -> torch.Tensor:
    """x [P, 3] (or [3, P] with `transposed`) -> [kout, P] float32: row 0
    is the density logit (plus the sigma-CP sum), the rest the features."""
    xT = x if transposed else x.T
    if not x.is_cuda:
        return run_tmlp_plain(xT, tm)
    xT = xT.contiguous()
    P = xT.shape[1]
    _check(xT, "xT", (3, P))
    plan = kernel_plan(tm)
    out = torch.empty(tm.kout, P, dtype=torch.float32, device=x.device)
    if P:
        args, keep = _net_args(tm, plan, x.device)
        park, park_bytes = park_buffer(tm, plan, x.device, False)
        code = _lib().tmlp_launch(
            *args, xT.data_ptr(), P, out.data_ptr(), tm.kout,
            None if park is None else park.data_ptr(), park_bytes,
            torch.cuda.current_stream().cuda_stream)
        _raise_on(code, "run_tmlp")
        run_tmlp.launches += 1
        del keep
    return out


run_tmlp.launches = 0


def run_tmlp_composite(xT: torch.Tensor, dl: torch.Tensor, ts: torch.Tensor,
                       tm: TransposedFieldMLP, opaque: bool = True,
                       view: Optional[ViewMLP] = None,
                       rays8: Optional[torch.Tensor] = None,
                       pack_q: int = 1, T: Optional[int] = None):
    """Final-level field query + alpha composite. xT [3, N*T] contracted
    sample coordinates, dl/ts [N, T] metric deltas/midpoints (with
    pack_q > 1 the ray kernels' packed [N/q, q*T, 1] rows, and T given).
    -> (gsum [N, kout], depth [N], weights_sum [N]) and, with `view` and
    `rays8` ([N, 8], directions in columns 3:6), rgb [N, 3] (sigmoid
    applied, background not blended)."""
    if view is not None and rays8 is None:
        raise ValueError("the view head needs rays8")
    if not xT.is_cuda:
        return run_tmlp_composite_plain(xT, dl, ts, tm, opaque, view, rays8,
                                        pack_q, T)
    pack_q = max(1, int(pack_q))
    N, T = _unpack_rows(dl, pack_q, T).shape
    plan = kernel_plan(tm, T, view)
    rows = (N, T) if pack_q == 1 else (N // pack_q, pack_q * T, 1)
    _check(xT, "xT", (3, N * T))
    _check(dl, "dl", rows)
    _check(ts, "ts", rows)
    e = lambda *s: torch.empty(s, dtype=torch.float32, device=xT.device)  # noqa: E731
    gsum, depth, wsum = e(N, tm.kout), e(N), e(N)
    rgb = None
    vflat = vdesc = None
    if view is not None:
        _check(rays8, "rays8", (N, 8))
        vflat, vdesc = view.packed(xT.device)
        rgb = e(N, 3)
    if N:
        args, keep = _net_args(tm, plan, xT.device)
        park, park_bytes = park_buffer(tm, plan, xT.device, True)
        code = _lib().tmlp_composite_launch(
            *args,
            None if vflat is None else vflat.data_ptr(),
            0 if vflat is None else vflat.numel(),
            None if vdesc is None else vdesc.ctypes.data,
            xT.data_ptr(), dl.data_ptr(), ts.data_ptr(),
            None if rays8 is None or view is None else rays8.data_ptr(),
            N, T, pack_q, int(opaque), gsum.data_ptr(), depth.data_ptr(),
            wsum.data_ptr(), None if rgb is None else rgb.data_ptr(),
            None if park is None else park.data_ptr(), park_bytes,
            torch.cuda.current_stream().cuda_stream)
        _raise_on(code, "run_tmlp_composite")
        run_tmlp_composite.launches += 1
        if pack_q > 1:
            run_tmlp_composite.packed_launches += 1
        del keep
    if view is None:
        return gsum, depth, wsum
    return gsum, depth, wsum, rgb


run_tmlp_composite.launches = 0
run_tmlp_composite.packed_launches = 0
