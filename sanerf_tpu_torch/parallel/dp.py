"""Data parallelism over torch.distributed (JAX: sanerf_tpu/parallel/dp.py).

One process per device, PyTorch's idiom for data-parallel training, in
place of the JAX package's single-controller mesh:

- a `Mesh` is a process group with this rank's index, the group's size and
  this rank's device (JAX's `mesh.devices.size` is `mesh.size`);
- every rank collates the same global batch from the same host generator
  and keeps its contiguous slice (`shard_batch`; an entry of leading
  dimension 1, e.g. a shared cam_near_far [1, 2], replicates), as
  shard_map splits the leading axis;
- the steps call the single-device step bodies with the mesh: each rank
  renders its rays, the gradients and metrics are averaged over the ranks
  (`collectives.all_reduce_mean`, JAX's `pmean`), and every rank applies
  the same optimizer update, so the replicas stay equal bit for bit. The
  render and background draws are per rank (`rank_generator`, JAX's
  `fold_in(key, axis_index)`); the regularizer's draws come from one
  generator seeded alike on every rank;
- sharded renders pad the rays to a multiple of the mesh's size, render
  this rank's slice and gather the outputs in rank order.

No step is wrapped in DistributedDataParallel: the step bodies are
functional (`state.value_and_grads`), and one bucket a dtype is all DDP's
reducer would do for them.
"""

from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from sanerf_tpu_torch.config import TrainConfig
from sanerf_tpu_torch.device import resolve_device
from sanerf_tpu_torch.models import renderer
from sanerf_tpu_torch.models.fields import NerfModel, Params
from sanerf_tpu_torch.parallel import collectives
from sanerf_tpu_torch.train import state as state_lib
from sanerf_tpu_torch.train.state import TrainState
from sanerf_tpu_torch.train.tree import leaves_with_paths, map_with_path


@dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's view of a 1-D data-parallel group."""

    group: Any  # a torch.distributed ProcessGroup (None: the default group)
    rank: int
    size: int
    device: torch.device

    @property
    def backend(self) -> str:
        return str(dist.get_backend(self.group))

    def barrier(self) -> None:
        collectives.barrier(self)


def local_device(device=None) -> torch.device:
    """This rank's device: `device` as given, except that a CUDA device
    without an index becomes card LOCAL_RANK (else the rank) modulo the
    card count, so that torchrun's ranks take a card each and ranks that
    outnumber the cards share them."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()
                                   if dist.is_initialized() else 0))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    return dev


def make_mesh(n_devices: Optional[int] = None, device=None) -> Mesh:
    """A mesh over the first `n_devices` ranks of the initialised default
    group (all of them by default). Raises where no group is initialised
    or it has fewer ranks; a rank outside the first n_devices raises after
    the subgroup is made (every rank must call this)."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            f"make_mesh({n_devices}): no torch.distributed process group "
            "is initialised (multihost.initialize, torchrun, or "
            "`python -m sanerf_tpu_torch.apps.main ... --n_devices N`)")
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if n > world:
        raise ValueError(f"n_devices={n} but the process group has {world} "
                         "ranks")
    group = None if n == world else dist.new_group(list(range(n)))
    rank = dist.get_rank()
    if rank >= n:
        raise ValueError(f"rank {rank} is outside the {n}-rank mesh")
    return Mesh(group, rank, n, local_device(device))


def rank_generator(seed: int, mesh: Optional[Mesh], device) -> torch.Generator:
    """A generator of its own for each rank: seeded with `seed` on a
    single device and on rank 0, with seed + 7919 * rank elsewhere."""
    rank = 0 if mesh is None else mesh.rank
    return torch.Generator(device=device).manual_seed(seed + 7919 * rank)


def batch_pspec(batch: Dict) -> Dict[str, bool]:
    """Per entry: True where its leading (ray) axis shards, False where it
    replicates (a leading dimension of 1, a scalar)."""
    return {k: bool(np.ndim(v) >= 1 and np.shape(v)[0] > 1)
            for k, v in batch.items()}


def _slice(n: int, mesh: Mesh) -> slice:
    if n % mesh.size:
        raise ValueError(f"{n} rays do not divide the {mesh.size}-rank mesh")
    per = n // mesh.size
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def shard_batch(batch: Dict, mesh: Mesh) -> Dict[str, torch.Tensor]:
    """This rank's part of a global batch, on its device: the contiguous
    slice of every sharded entry, the replicated entries whole. Host
    scalars (H, W, index) are dropped, as the trainers' device batches
    drop them."""
    out = {}
    for k, sharded in batch_pspec(batch).items():
        v = batch[k]
        if not isinstance(v, (np.ndarray, torch.Tensor)):
            continue
        v = torch.as_tensor(v)
        if sharded:
            v = v[_slice(v.shape[0], mesh)]
        out[k] = v.to(mesh.device)
    return out


def replicate_state(state: TrainState, mesh: Mesh) -> TrainState:
    """Rank 0's state on every rank: its params, EMA and Adam moments
    broadcast (one bucket a dtype), the counts taken from rank 0."""
    def bcast(tree):
        leaves = [(p, t) for p, t in leaves_with_paths(tree)
                  if isinstance(t, torch.Tensor)]
        if not leaves:
            return tree
        got = {}
        by_dtype: Dict[torch.dtype, list] = {}
        for p, t in leaves:
            by_dtype.setdefault(t.dtype, []).append((p, t))
        for items in by_dtype.values():
            bucket = torch.cat([t.detach().reshape(-1) for _, t in items])
            collectives.broadcast(mesh, bucket)
            head = 0
            for p, t in items:
                got[p] = bucket[head:head + t.numel()].view(t.shape).clone()
                head += t.numel()
        return map_with_path(lambda p, t: got.get(p, t), tree)

    counts = torch.tensor([state.opt_state.count, state.step],
                          dtype=torch.int64, device=mesh.device)
    collectives.broadcast(mesh, counts)
    count, step = (int(v) for v in counts.cpu())
    opt = state_lib.AdamState(count, bcast(state.opt_state.mu),
                              bcast(state.opt_state.nu))
    return TrainState(bcast(state.params), bcast(state.ema_params), opt,
                      step)


def replica_digest(state: TrainState) -> bytes:
    """sha256 of the params, the EMA and the Adam moments, leaf by leaf in
    path order, and of the counts."""
    h = hashlib.sha256()
    for tree in (state.params, state.ema_params, state.opt_state.mu,
                 state.opt_state.nu):
        for p, t in leaves_with_paths(tree):
            h.update(p.encode())
            h.update(t.detach().cpu().reshape(-1).view(torch.uint8)
                     .numpy().tobytes())
    h.update(f"{state.opt_state.count}/{state.step}".encode())
    return h.digest()


def check_replicas(state: TrainState, mesh: Mesh, what: str = ""
                   ) -> List[bytes]:
    """Raises unless every rank holds the same state bit for bit; -> the
    ranks' digests (`replica_digest`), in rank order."""
    digests = collectives.gather_bytes(mesh, replica_digest(state))
    if len(set(digests)) != 1:
        raise RuntimeError(f"the replicas differ across the {mesh.size} "
                           f"ranks{': ' + what if what else ''}: "
                           + " ".join(d.hex()[:16] for d in digests))
    return digests


def make_dp_train_step(model: NerfModel, cfg: TrainConfig, mesh: Mesh,
                       trainable: Optional[Params] = None):
    """The sharded stage-1 step around the single-device body:
    step(state, local_batch, local_draws, update_proposal=True) ->
    (state, aux). `local_batch` is `shard_batch` of the global batch,
    `local_draws` this rank's draws for its rays (`draw_step` with a
    `rank_generator`) with the regularizer's points shared."""
    opt = state_lib.make_optimizer(cfg, trainable)

    def step(state: TrainState, batch: Dict[str, torch.Tensor],
             draws: state_lib.StepDraws, update_proposal: bool = True):
        return state_lib.rgb_step_body(model, cfg, opt, state, batch, draws,
                                       update_proposal, mesh=mesh)

    return step


def make_dp_sam_train_step(model: NerfModel, cfg, mesh: Mesh,
                           trainable: Optional[Params] = None, h: int = 32,
                           w: int = 32):
    """The sharded stage-2 student step: each rank renders its strip of
    the h x w feature rays, the strips are gathered before the resize and
    the MSE, the gradients averaged. step(state, local_batch, gt) ->
    (state, aux)."""
    from sanerf_tpu_torch.train.distill import sam_step_body

    opt = state_lib.make_optimizer(cfg.train, trainable)

    def step(state: TrainState, batch: Dict[str, torch.Tensor],
             gt: torch.Tensor):
        return sam_step_body(model, cfg, opt, state, batch, gt, h, w,
                             mesh=mesh)

    return step


def make_dp_mask_train_step(model: NerfModel, cfg, mesh: Mesh,
                            trainable: Optional[Params] = None):
    """The sharded stage-3 step around `mask_step_body`. The batch is this
    rank's block of `shard_mask_batch` and `num_global` the per-rank
    global-ray count. step(state, local_batch, num_global, use_similarity,
    gumbel=None) -> (state, aux) with aux's pred and error gathered back
    into the global order."""
    from sanerf_tpu_torch.train.mask_trainer import mask_step_body

    opt = state_lib.make_optimizer(cfg.train, trainable)

    def step(state: TrainState, batch: Dict[str, torch.Tensor],
             num_global: int, use_similarity: bool,
             gumbel: Optional[torch.Tensor] = None):
        return mask_step_body(model, cfg, opt, state, batch, num_global,
                              use_similarity, gumbel, mesh=mesh)

    return step


def mask_batch_layout(batch: Dict, n: int, num_global: int,
                      patch_pixels: int) -> Tuple[Dict, int]:
    """A stage-3 batch [globals | patches] reordered into per-rank blocks
    [g_0 p_0 | g_1 p_1 | ...] (JAX dp.shard_mask_batch's order), so that
    a contiguous split gives every rank its globals and whole patches.
    Entries that are not per-ray (cam_near_far [1, 2]) stay as they are.
    -> (the reordered host batch, the per-rank global count)."""
    total = np.shape(batch["masks"])[0]
    n_patch_px = total - num_global
    if num_global % n:
        raise ValueError(f"{num_global} global rays on {n} ranks")
    if n_patch_px and n_patch_px % (patch_pixels * n):
        raise ValueError(f"{n_patch_px} patch rays in patches of "
                         f"{patch_pixels} on {n} ranks")
    gn, ln = num_global // n, n_patch_px // n
    out = {}
    for k, v in batch.items():
        if not hasattr(v, "shape") or np.ndim(v) < 1 or v.shape[0] != total:
            if hasattr(v, "shape"):
                out[k] = v
            continue
        v = np.asarray(v)
        g, l = v[:num_global], v[num_global:]
        out[k] = np.concatenate(
            [part for i in range(n)
             for part in (g[i * gn:(i + 1) * gn], l[i * ln:(i + 1) * ln])],
            axis=0)
    return out, gn


def shard_mask_batch(batch: Dict, mesh: Mesh, num_global: int,
                     patch_pixels: int) -> Tuple[Dict[str, torch.Tensor],
                                                 int]:
    """This rank's block of `mask_batch_layout` on its device, and the
    per-rank global count."""
    laid, gn = mask_batch_layout(batch, mesh.size, num_global, patch_pixels)
    return shard_batch(laid, mesh), gn


_FRAME_KEYS = ("image", "depth", "weights_sum")


def make_dp_render(model: NerfModel, mesh: Mesh, **render_kwargs):
    """Sharded full-frame inference: fn(params, rays_o, rays_d,
    cam_near_far=None) renders this rank's contiguous slice of the rays
    (`render_staged`) and gathers image, depth and weights_sum (and samvit
    / instance_mask_logits with return_feats / return_mask) in rank
    order. The ray count must divide the mesh (`render_frame_dp` pads);
    cam_near_far is shared ([1, 2]) or None."""
    keys = _FRAME_KEYS
    if render_kwargs.get("return_feats"):
        keys = keys + ("samvit",)
    if render_kwargs.get("return_mask"):
        keys = keys + ("instance_mask_logits",)

    @torch.no_grad()
    def fn(params: Params, rays_o, rays_d, cam_near_far=None):
        sl = _slice(rays_o.shape[0], mesh)
        out = renderer.render_staged(model, params, rays_o[sl], rays_d[sl],
                                     cam_near_far=cam_near_far,
                                     **render_kwargs)
        return {k: collectives.all_gather(mesh, out[k]) for k in keys}

    return fn


def render_frame_dp(model: NerfModel, mesh: Mesh, render_fn, params, rays_o,
                    rays_d, cam_near_far=None) -> Dict[str, torch.Tensor]:
    """Pad the rays (repeating the last) to a multiple of the mesh's size,
    run `render_fn` (from make_dp_render), trim."""
    N = rays_o.shape[0]
    M = -(-N // mesh.size) * mesh.size
    if M != N:
        rays_o = torch.cat([rays_o, rays_o[-1:].expand(M - N, 3)])
        rays_d = torch.cat([rays_d, rays_d[-1:].expand(M - N, 3)])
    out = render_fn(params, rays_o, rays_d, cam_near_far)
    return {k: v[:N] for k, v in out.items()}
