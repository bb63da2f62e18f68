"""VM (vector-matrix) factorized grid features, TensoRF's VM mode, and
their training side (JAX: sanerf_tpu/ops/vmgrid.py: init_vm, init_vm_multi,
vm_features_gather, vm_features_multi, resize_vm,
grad_total_variation_planes).

Per mode m a feature plane over the two other axes and a line along m:

    feat_m,k(x) = P_m[u(x_a), u(x_b), k] * L_m[u(x_m), k],
    a = (m + 1) % 3 (plane rows), b = (m + 2) % 3 (plane columns),

planes [3, R, R, K], lines [3, Rl, K] (Rl may differ from R), the three
modes concatenated: [N, 3K]. The plane is read bilinearly at its 4 corner
rows, the line linearly at its 2 taps, with the grid coordinates of
ops/cpgrid.py at each table's own resolution. A ladder is a list of levels
coarse -> fine (cpgrid.level_resolutions), each with rank / levels.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from sanerf_tpu_torch.ops.cpgrid import level_resolutions, linresize


def init_vm(g: torch.Generator, res: int, rank: int,
            line_res: Optional[int] = None, scale: float = 0.2,
            device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """([3, R, R, K] planes, [3, Rl, K] lines), scale * N(0, 1)."""
    line_res = res if line_res is None else line_res
    planes = scale * torch.randn(3, res, res, rank, generator=g)
    lines = scale * torch.randn(3, line_res, rank, generator=g)
    return planes.to(device), lines.to(device)


def init_vm_multi(g: torch.Generator, res: int, rank: int, levels: int,
                  scale: float = 0.2, device=None
                  ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """A ladder of `levels` VM levels ending at `res`, rank / levels each:
    (planes list, lines list), coarse -> fine."""
    if rank % levels:
        raise ValueError(f"rank {rank} does not split into {levels} levels")
    pairs = [init_vm(g, r, rank // levels, scale=scale, device=device)
             for r in level_resolutions(res, levels)]
    return [p for p, _ in pairs], [l for _, l in pairs]


def _coords(x: torch.Tensor, bound: float, R: int):
    """-> (i0, i1 [N, 3] long, frac [N, 3] float32) at resolution R."""
    u = torch.clamp((x.float() / bound * 0.5 + 0.5) * (R - 1), 0.0, R - 1)
    fl = torch.floor(u)
    i0 = fl.long()
    return i0, torch.clamp(i0 + 1, max=R - 1), u - fl


def vm_read(planes: torch.Tensor, lines: torch.Tensor, plane_taps,
            line_taps, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """VM features [N, 3K] in `dtype` from the taps (i0, i1 [N, 3] long,
    frac [N, 3]) of the planes' and of the lines' resolution: per mode the
    bilinear plane read times the linear line read, in the order of
    operations of the kernels' encode (csrc/fused_mlp_t.cu:vm_level)."""
    _, R, _, K = planes.shape
    i0p, i1p, fp = plane_taps
    i0l, i1l, fl = line_taps
    feats = []
    for m in range(3):
        a, b = (m + 1) % 3, (m + 2) % 3
        P = planes[m].reshape(R * R, K).to(dtype)
        r0, r1 = i0p[:, a] * R, i1p[:, a] * R
        v00, v01 = P[r0 + i0p[:, b]], P[r0 + i1p[:, b]]
        v10, v11 = P[r1 + i0p[:, b]], P[r1 + i1p[:, b]]
        fa, fb = fp[:, a:a + 1].to(dtype), fp[:, b:b + 1].to(dtype)
        pf = ((v00 * (1 - fb) + v01 * fb) * (1 - fa)
              + (v10 * (1 - fb) + v11 * fb) * fa)
        L = lines[m].to(dtype)
        f = fl[:, m:m + 1].to(dtype)
        lf = L[i0l[:, m]] * (1 - f) + L[i1l[:, m]] * f
        feats.append(pf * lf)
    return torch.cat(feats, dim=-1)


def vm_features_gather(planes: torch.Tensor, lines: torch.Tensor,
                       x: torch.Tensor, bound: float) -> torch.Tensor:
    """planes [3, R, R, K], lines [3, Rl, K], x [N, 3] in [-bound, bound]
    -> [N, 3K] float32."""
    return vm_read(planes, lines, _coords(x, bound, planes.shape[1]),
                   _coords(x, bound, lines.shape[1]))


def vm_features_multi(planes_list: Sequence[torch.Tensor],
                      lines_list: Sequence[torch.Tensor], x: torch.Tensor,
                      bound: float, level_weights: Optional[Sequence] = None
                      ) -> torch.Tensor:
    """Per-level VM features concatenated coarse -> fine, [N, 3 sum K_i];
    `level_weights` ([L] scalars) scales each level (None = all 1)."""
    feats = [vm_features_gather(p, l, x, bound)
             for p, l in zip(planes_list, lines_list)]
    if level_weights is not None:
        feats = [f * level_weights[i] for i, f in enumerate(feats)]
    return torch.cat(feats, dim=-1)


def resize_vm(planes: torch.Tensor, lines: torch.Tensor, new_res: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bilinear resample of a VM level to plane resolution `new_res` (two
    separable linear passes); the line resolution scales by the same
    factor."""
    old = planes.shape[1]
    p = linresize(linresize(planes, new_res, axis=1), new_res, axis=2)
    new_line = max(2, int(round(lines.shape[1] * new_res / old)))
    return p, linresize(lines, new_line, axis=1)


def grad_total_variation_planes(planes: torch.Tensor,
                                weight: float) -> torch.Tensor:
    """Gradient of weight * sum (P[i+1, j] - P[i, j])^2 + (P[i, j+1] -
    P[i, j])^2 over every plane and rank of planes [3, R, R, K]."""
    g = torch.zeros_like(planes)
    dr = planes[:, 1:, :, :] - planes[:, :-1, :, :]
    g[:, 1:, :, :] += 2.0 * weight * dr
    g[:, :-1, :, :] += -2.0 * weight * dr
    dc = planes[:, :, 1:, :] - planes[:, :, :-1, :]
    g[:, :, 1:, :] += 2.0 * weight * dc
    g[:, :, :-1, :] += -2.0 * weight * dc
    return g
