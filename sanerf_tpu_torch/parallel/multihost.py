"""Multi-process helpers (JAX: sanerf_tpu/parallel/multihost.py).

The JAX package bootstraps `jax.distributed` and shards the dataset's
views across processes so that each host loads and samples its share. The
port runs one process per device anyway, so a process is a rank:
`initialize` brings up the torch.distributed default group (a no-op in a
single process, as in JAX), `process_shard_indices` splits the views
round-robin, and `distribute_batch` takes this rank's locally sampled
batch as its shard of the global one (the step then averages gradients
over all ranks as for a sharded global batch).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist


def default_backend(device) -> str:
    """NCCL for CUDA devices, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None,
               backend: Optional[str] = None, device=None,
               store=None) -> None:
    """Bring up the default process group; nothing in a single process
    (world_size 1 and no WORLD_SIZE in the environment) or where it is
    already up. `init_method` (e.g. tcp://localhost:PORT or file://...)
    or `store` as torch.distributed takes them; by default torchrun's
    environment (env://). The backend is `backend`, else NCCL for a CUDA
    `device` and gloo for the CPU; a failure to initialise raises."""
    if dist.is_initialized():
        return
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if world_size <= 1:
        return
    if rank is None:
        rank = int(os.environ["RANK"])
    if backend is None:
        from sanerf_tpu_torch.device import resolve_device

        backend = default_backend(resolve_device(device))
    kw = ({"store": store} if store is not None
          else {"init_method": init_method or "env://"})
    dist.init_process_group(backend, world_size=world_size, rank=rank, **kw)


def _rank_and_size():
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def process_shard_indices(n_items: int) -> np.ndarray:
    """This process's views: a round-robin split of range(n_items)."""
    rank, size = _rank_and_size()
    return np.arange(rank, n_items, size)


def local_batch_size(global_batch: int) -> int:
    rank, size = _rank_and_size()
    if global_batch % size:
        raise ValueError(f"global batch {global_batch} does not divide the "
                         f"{size} processes")
    return global_batch // size


def global_mesh(device=None):
    """The mesh over every rank of the default group."""
    from sanerf_tpu_torch.parallel import dp

    return dp.make_mesh(None, device)


def distribute_batch(batch: Dict, mesh) -> Dict[str, torch.Tensor]:
    """This rank's locally sampled batch as its shard of the global batch,
    on its device. A per-view cam_near_far [1, 2] differs across ranks
    (each samples its own views), so it is broadcast to per-ray [n, 2] and
    shards with the rays, as the JAX package does."""
    arrays = {k: np.asarray(v) for k, v in batch.items()
              if isinstance(v, (np.ndarray, torch.Tensor))}
    n_rays = next((v.shape[0] for v in arrays.values()
                   if v.ndim >= 1 and v.shape[0] > 1), None)
    out = {}
    for k, v in arrays.items():
        if k == "cam_near_far" and v.shape[0] == 1 and n_rays:
            v = np.broadcast_to(v, (n_rays,) + v.shape[1:]).copy()
        out[k] = torch.as_tensor(v).to(mesh.device)
    return out
