"""The collectives of the data-parallel steps, in one place.

Every collective of the port goes through this module, over a `dp.Mesh`
(a process group, this rank's index and the group's size):

- `all_reduce_mean`: the JAX package's `pmean` of a tree (gradients, the
  step's metrics). All leaves of one dtype are flattened into one bucket,
  reduced by one `all_reduce` (SUM) and divided by the group's size;
- `all_reduce_sum`: `psum` of a tensor, differentiable. Its backward is
  psum's transpose, the sum of every rank's cotangent: the loss after it is
  computed the same way on every rank, so the cotangent is the same there,
  and the sum is `size` times this rank's (no communication in the
  backward pass);
- `all_gather`: `all_gather(tiled=True)` along dim 0 in rank order,
  differentiable. Its backward is the transpose, `psum_scatter`: for the
  same reason, `size` times this rank's slice of the cotangent. A step
  that averages its gradients afterwards (`all_reduce_mean`) thus gets the
  gradient of the global loss, as JAX's `pmean` after `all_gather` does;
- `broadcast` from rank 0, `barrier`, and `broadcast_object` /
  `gather_bytes` for the few small values the ranks exchange (a path, a
  shape, the replica digests), as byte tensors through the same calls.

Every rank's tensors lie on the mesh's device, and each collective is the
same call on every backend: NCCL and gloo run one code path.

gloo and CUDA tensors: gloo takes CUDA tensors for all_reduce, broadcast
and all_gather, staging them through the host itself (chip_smoke's E3
probe on the H100; PERF.md §6, PR 14), so the tensors go to either
backend as they are; NCCL refuses CPU tensors.
"""

from __future__ import annotations

import pickle
from typing import Any, Dict, List, Tuple

import torch
import torch.distributed as dist

from sanerf_tpu_torch.train.tree import leaves_with_paths, map_with_path


def _all_reduce_(mesh, t: torch.Tensor) -> torch.Tensor:
    """In-place SUM of a contiguous tensor over the mesh."""
    dist.all_reduce(t, group=mesh.group)
    return t


def broadcast(mesh, t: torch.Tensor, src: int = 0) -> torch.Tensor:
    """`t` of rank `src` on every rank (in place; returns `t`)."""
    dist.broadcast(t, src, group=mesh.group)
    return t


def _gather(mesh, t: torch.Tensor) -> torch.Tensor:
    """[size * n, ...]: every rank's [n, ...] in rank order."""
    t = t.contiguous()
    out = t.new_empty((mesh.size * t.shape[0],) + tuple(t.shape[1:]))
    dist.all_gather(list(out.chunk(mesh.size)), t, group=mesh.group)
    return out


def barrier(mesh) -> None:
    """Returns once every rank has reached it: a one-element all_reduce on
    the mesh's device, waited for (the same call on every backend)."""
    _all_reduce_(mesh, torch.zeros(1, device=mesh.device)).item()


def all_reduce_mean(mesh, tree: Any) -> Any:
    """The tree with every tensor leaf averaged over the mesh (None leaves
    stay None, Python numbers pass through, lists and dicts are walked):
    one flattened all_reduce per dtype, on the mesh's device."""
    groups: Dict[torch.dtype, List[Tuple[str, torch.Tensor]]] = {}
    for p, t in leaves_with_paths(tree):
        if isinstance(t, torch.Tensor):
            groups.setdefault(t.dtype, []).append((p, t))
    out: Dict[str, torch.Tensor] = {}
    for items in groups.values():
        bucket = torch.cat([t.detach().reshape(-1).to(mesh.device)
                            for _, t in items])
        _all_reduce_(mesh, bucket)
        bucket.div_(mesh.size)
        head = 0
        for p, t in items:
            out[p] = bucket[head:head + t.numel()].view(t.shape).to(t.device)
            head += t.numel()
    return map_with_path(lambda p, t: out.get(p, t), tree)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh):
        ctx.size = mesh.size
        return _all_reduce_(mesh, t.detach().clone().contiguous())

    @staticmethod
    def backward(ctx, g):
        return g * ctx.size, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh):
        ctx.size, ctx.rank, ctx.n = mesh.size, mesh.rank, t.shape[0]
        return _gather(mesh, t.detach())

    @staticmethod
    def backward(ctx, g):
        n = ctx.n
        return g[ctx.rank * n:(ctx.rank + 1) * n] * ctx.size, None


def all_reduce_sum(mesh, t: torch.Tensor) -> torch.Tensor:
    """psum of `t` over the mesh, differentiable (module docstring)."""
    return _AllReduceSum.apply(t, mesh)


def all_gather(mesh, t: torch.Tensor) -> torch.Tensor:
    """Every rank's `t` concatenated along dim 0 in rank order,
    differentiable (module docstring)."""
    return _AllGather.apply(t, mesh)


def broadcast_object(mesh, obj: Any, src: int = 0) -> Any:
    """Rank `src`'s picklable `obj` on every rank (a path, a shape),
    pickled into a byte tensor on the mesh's device: its length, then its
    bytes, by `broadcast`."""
    data = pickle.dumps(obj) if mesh.rank == src else b""
    n = broadcast(mesh, torch.tensor([len(data)], dtype=torch.int64,
                                     device=mesh.device), src)
    buf = torch.zeros(int(n.item()), dtype=torch.uint8, device=mesh.device)
    if mesh.rank == src:
        buf.copy_(torch.frombuffer(bytearray(data), dtype=torch.uint8))
    return pickle.loads(broadcast(mesh, buf, src).cpu().numpy().tobytes())


def gather_bytes(mesh, data: bytes) -> List[bytes]:
    """Every rank's `data` (of one length on every rank: a digest), in
    rank order, by `_gather`."""
    t = torch.frombuffer(bytearray(data), dtype=torch.uint8)
    got = _gather(mesh, t.to(mesh.device)[None]).cpu().numpy()
    return [row.tobytes() for row in got]
