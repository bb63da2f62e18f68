"""Parity: the port's data parallelism (sanerf_tpu_torch/parallel/) against
the JAX package's 8-device CPU mesh (tests/test_parallel.py's sizes: RC,
MC, TC), with the port's ranks as gloo processes on the CPU.

The JAX references are computed once in this process and reach the ranks
as numpy files; each rank writes its results to files that the tests read.
The ranks of one world size run once for the module (`ranks` fixture): 2
ranks for every part, 4 for the parts where the shard count matters (the
render, the gradients, the stage-2 and stage-3 steps). Every spawn is under
a join timeout and is killed when it expires; the ranks meet through a
FileStore under the test's temporary directory (never a fixed port).

Tolerances are tests/test_parallel.py's: the render rtol 1e-4 with atol
1e-5 (image) and 1e-4 (depth); the averaged shard gradients rtol 2e-3,
atol 2e-5 (stage 1, 2 and 3); one step's loss rtol 1e-5; stage 3's error
in the original order rtol 1e-3, atol 1e-5; the stage-3 batch layout bit
for bit; the sharded interactive frame within 1 uint8 level of the
single-device frame, its depth rtol 1e-4, atol 1e-4. Replicas are compared
by a sha256 of their params, EMA and Adam moments: bit for bit.
"""

import dataclasses
import os
import tempfile
import time
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from sanerf_tpu_torch import config
from sanerf_tpu_torch.data.synthetic import SyntheticSphereDataset
from sanerf_tpu_torch.models import fields
from sanerf_tpu_torch.models.asset import params_from_jax
from sanerf_tpu_torch.parallel import collectives, dp, multihost
from sanerf_tpu_torch.train import state as state_lib
from sanerf_tpu_torch.train.checkpoints import flatten_tree

torch.set_num_threads(1)

RC = dict(num_steps=(8, 4), bound=4.0, contract=True)
MC = dict(field_type="mlp", prop_resolutions=(32,), mlp_enc_freqs=4,
          mlp_field_width=32, mlp_field_depth=4, mlp_prop_enc_freqs=3,
          mlp_prop_width=16, mlp_prop_depth=2)
TC = dict(iters=100, num_rays=512, adaptive_num_rays=False)
SAM_MC = dict(MC, with_sam=True, sam_use_view_direction=True,
              sam_feat_dim=32, mlp_sam_width=32, mlp_sam_depth=2,
              mlp_sam_feat_dim=32, samvit_mlp_hidden=32)
MASK_MC = dict(MC, with_mask=True, n_inst=2)
MASK_CFG = dict(label_regularization_weight=0.1, patch_size=4)
PATCH_CFG = dict(mixed_sampling=True, rgb_similarity_loss_weight=0.1,
                 rgb_similarity_iter=0, local_sample_patch_size=2,
                 num_local_sample=8)
HASH_MC = dict(field_type="hashgrid", grid_num_levels=8, grid_log2_hashmap=13,
               grid_desired_resolution=128, prop_num_levels=4,
               prop_log2_hashmap=10, prop_resolutions=(64,))
N_RENDER, SAM_HW, N_MASK = 64, 8, 128
#: the interactive frame of tests/test_parallel.py:417-452
FH = FW = 16
FRAME_POSE = np.array([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 2.0],
                       [0, 0, 0, 1]], np.float32)
#: a rank's processes, and the whole module's, time out after this
JOIN_TIMEOUT_S = 240


def _model(mkw, rkw=RC):
    return fields.make_model(config.ModelConfig(**mkw),
                             config.RenderConfig(**rkw))


def _cfg(mkw, mask=None, **tkw):
    return config.Config(render=config.RenderConfig(**RC),
                         model=config.ModelConfig(**mkw),
                         train=config.TrainConfig(**dict(TC, **tkw)),
                         mask=config.MaskTrainConfig(**(mask or {})))


def _load(d, name):
    with np.load(os.path.join(d, name)) as z:
        return {k: z[k] for k in z.files}


def _save(d, name, **arrays):
    np.savez(os.path.join(d, name), **arrays)


# -- the ranks' parts ---------------------------------------------------------

def _render(mesh, d):
    model = _model(MC)
    params = params_from_jax(_load(d, "mlp_params.npz"), model, "cpu")
    ref = _load(d, "render_ref.npz")
    ro, rd = torch.from_numpy(ref["ro"]), torch.from_numpy(ref["rd"])
    fn = dp.make_dp_render(model, mesh)
    out = fn(params, ro, rd)
    pad = dp.render_frame_dp(model, mesh, fn, params, ro[:-1], rd[:-1])
    return {"image": out["image"], "depth": out["depth"],
            "weights_sum": out["weights_sum"], "pad_image": pad["image"],
            "pad_depth": pad["depth"]}


def _grads(mesh, d):
    model = _model(MC)
    params = params_from_jax(_load(d, "mlp_params.npz"), model, "cpu")
    b = dp.shard_batch(_load(d, "grads_batch.npz"), mesh)

    def loss_fn(p):
        from sanerf_tpu_torch.models.renderer import run_rays

        out = run_rays(model, p, b["rays_o"], b["rays_d"], None,
                       training=True)
        loss = ((out["image"] - b["images"]) ** 2).mean()
        return loss, {}

    _, _, g = state_lib.value_and_grads(loss_fn, params)
    g = collectives.all_reduce_mean(mesh, g)
    return {f"g/{k}": v for k, v in flatten_tree(g).items()}


def _sam(mesh, d):
    from sanerf_tpu_torch.train.distill import sam_loss_fn

    model = _model(SAM_MC)
    cfg = _cfg(SAM_MC)
    params = params_from_jax(_load(d, "sam_params.npz"), model, "cpu")
    ref = _load(d, "sam_batch.npz")
    gt = torch.from_numpy(ref["gt"])
    local = dp.shard_batch({"rays_o_lr": ref["ro"], "rays_d_lr": ref["rd"]},
                           mesh)
    _, _, g = state_lib.value_and_grads(
        lambda p: sam_loss_fn(model, p, local, gt, SAM_HW, SAM_HW, mesh),
        params)
    g = collectives.all_reduce_mean(mesh, g)
    step = dp.make_dp_sam_train_step(model, cfg, mesh, None, h=SAM_HW,
                                     w=SAM_HW)
    s = dp.replicate_state(state_lib.create_train_state(
        model, cfg.train, params=params), mesh)
    s, aux = step(s, local, gt)
    dp.check_replicas(s, mesh, "stage 2")
    return {"loss": aux["loss"],
            **{f"g/{k}": v for k, v in flatten_tree(g).items()}}


def _mask(mesh, d):
    from sanerf_tpu_torch.train.mask_trainer import mask_loss_fn

    model = _model(MASK_MC)
    cfg = _cfg(MASK_MC, MASK_CFG)
    params = params_from_jax(_load(d, "mask_params.npz"), model, "cpu")
    host = _load(d, "mask_batch.npz")
    local, gn = dp.shard_mask_batch(host, mesh, N_MASK, 1)
    _, _, g = state_lib.value_and_grads(
        lambda p: mask_loss_fn(model, cfg, p, local, gn, False, None, mesh),
        params)
    g = collectives.all_reduce_mean(mesh, g)
    step = dp.make_dp_mask_train_step(model, cfg, mesh, None)
    s = dp.replicate_state(state_lib.create_train_state(
        model, cfg.train, params=params), mesh)
    s, aux = step(s, local, gn, False)
    dp.check_replicas(s, mesh, "stage 3")
    # the patched batch's per-rank blocks, for the layout test
    patched, pgn = dp.shard_mask_batch(_load(d, "patched_batch.npz"), mesh,
                                       64, 4)
    return {"loss": aux["loss"], "error": aux["error"], "pred": aux["pred"],
            "block_masks": patched["masks"], "block_rays": patched["rays_o"],
            "block_gn": torch.tensor(pgn),
            **{f"g/{k}": v for k, v in flatten_tree(g).items()}}


def _patched_mask(mesh, d):
    model = _model(MASK_MC)
    cfg = _cfg(MASK_MC, PATCH_CFG)
    params = fields.init_params(model, torch.Generator().manual_seed(0))
    local, gn = dp.shard_mask_batch(_load(d, "patched_batch.npz"), mesh,
                                    64, 4)
    gen = dp.rank_generator(1, mesh, "cpu")
    from sanerf_tpu_torch.train.mask_trainer import draw_gumbel

    gumbel = draw_gumbel(cfg, len(local["masks"]), gn, gen, "cpu")
    step = dp.make_dp_mask_train_step(model, cfg, mesh, None)
    s = dp.replicate_state(state_lib.create_train_state(
        model, cfg.train, params=params), mesh)
    s, aux = step(s, local, gn, True, gumbel)
    return {"loss": aux["loss"], "digest": _digest(s)}


def _digest(s):
    return torch.frombuffer(bytearray(dp.replica_digest(s)),
                            dtype=torch.uint8)


def _replicas(mesh, d, mkw):
    model = _model(mkw)
    tc = config.TrainConfig(**TC)
    s = dp.replicate_state(state_lib.create_train_state(
        model, tc, torch.Generator().manual_seed(0), device="cpu"), mesh)
    step = dp.make_dp_train_step(model, tc, mesh)
    ds = SyntheticSphereDataset(H=32, W=32, n_views=4)
    rng = np.random.default_rng(0)
    gen = dp.rank_generator(0, mesh, "cpu")
    shared = torch.Generator().manual_seed(7)
    losses = []
    for _ in range(8):
        b = dp.shard_batch(ds.collate_train(rng, tc.num_rays), mesh)
        draws = state_lib.draw_step(model, tc, b["rays_o"].shape[0], gen,
                                    "cpu", shared=shared)
        s, aux = step(s, b, draws)
        losses.append(float(aux["loss"]))
    return {"losses": torch.tensor(losses), "step": torch.tensor(s.step),
            "digest": _digest(s)}


def _trainer(mesh, d):
    from sanerf_tpu_torch.train.trainer import Trainer

    ds = SyntheticSphereDataset(H=32, W=32, n_views=6)
    rc = dict(RC, max_ray_batch=2048)
    out = {}
    for n_dev in (1, 2):
        if n_dev == 1 and mesh.rank != 0:
            continue
        ws = os.path.join(d, f"ws{n_dev}")
        tc = config.TrainConfig(**dict(TC, iters=40, save_cnt=1, eval_cnt=1,
                                       n_devices=n_dev,
                                       use_native_loader=False))
        cfg = config.Config(workspace=ws, render=config.RenderConfig(**rc),
                            model=config.ModelConfig(**MC), train=tc)
        model = _model(MC, rc)
        tr = Trainer("dp", cfg, model, use_checkpoint="scratch",
                     device="cpu")
        tr.train(ds, valid_dataset=None, max_epoch=2, steps_per_epoch=30)
        out[f"psnr{n_dev}"] = torch.tensor(tr.evaluate_one_epoch(
            ds, save_artifacts=False)["PSNRMeter"])
        if n_dev == 1:
            continue
        assert tr.global_step == 60 and tr.mesh.size == 2
        tr.save_checkpoint(full=True)
        tr2 = Trainer("dp", cfg, model, use_checkpoint="latest",
                      device="cpu")
        out.update(step=torch.tensor(tr.global_step),
                   resumed_step=torch.tensor(tr2.global_step),
                   digest=_digest(tr.state), resumed=_digest(tr2.state),
                   ckpts=torch.tensor(len(tr.ckpt_mgr.list_checkpoints())))
    return out


def _frame(mesh, d, spec):
    from sanerf_tpu_torch.apps.frame_pipeline import FramePipeline
    from sanerf_tpu_torch.apps.interactive import InteractiveSession
    from sanerf_tpu_torch.models.sam import predictor

    model = _model(dict(MC, with_sam=True, sam_use_view_direction=True,
                        sam_feat_dim=32))
    params = params_from_jax(_load(d, "frame_params.npz"), model, "cpu")
    sam_params = predictor.params_from_jax(_load(d, "tiny_sam.npz"),
                                           spec["sam"])
    intr = np.asarray([0.5 * FH, 0.5 * FH, FW / 2, FH / 2], np.float32)
    # a follower renders its feature rows without a SAM decoder
    lead = mesh.rank == 0
    pipe = FramePipeline(model, params, spec["sam"] if lead else None,
                         sam_params if lead else None, FH, FW, 8, 8,
                         device="cpu", mesh=mesh)
    session = InteractiveSession(None, model, params,
                                 types.SimpleNamespace(cfg=spec["sam"],
                                                       params=sam_params)
                                 if lead else None,
                                 H=32, W=32, fetch_format="rgb8",
                                 device="cpu", mesh=mesh)
    if not lead:
        pipe.follow()
        session.follow()
        return {}
    single = FramePipeline(model, params, spec["sam"], sam_params, FH, FW,
                           8, 8, device="cpu")
    p3, act = single.pad_points([[0.0, 0.0, 0.0]])
    out = {}
    for name, p in (("single", single), ("sharded", pipe)):
        img, depth, mask, pts2d, valid = p.render_sync(FRAME_POSE, intr, p3,
                                                       act)
        out[f"{name}_img"] = torch.from_numpy(img)
        out[f"{name}_depth"] = depth
        out[f"{name}_valid"] = torch.as_tensor(valid)
    out["dispatches"] = torch.tensor(pipe.dispatch_count)
    pipe.close()
    single_session = InteractiveSession(
        None, model, params, types.SimpleNamespace(cfg=spec["sam"],
                                                   params=sam_params),
        H=32, W=32, fetch_format="rgb8", device="cpu")
    for name, sess in (("single_session", single_session),
                       ("sharded_session", session)):
        r = sess.step(FRAME_POSE, click=(16.0, 16.0), pipelined=False)
        r = sess.step(FRAME_POSE, downscale=2, pipelined=False)
        out[f"{name}_img"] = torch.from_numpy(r.rgb_u8)
        out[f"{name}_depth"] = r.depth
    session.close()
    return out


def _viewer(mesh, d):
    """The viewer on a 2-rank Trainer: rank 0 drives HeadlessViewer with
    live training, rank 1 follows (follow_gui): the frames, the training
    steps between them, a save."""
    from sanerf_tpu_torch.apps.gui import HeadlessViewer, follow_gui
    from sanerf_tpu_torch.apps.interactive import InteractiveSession
    from sanerf_tpu_torch.train.trainer import Trainer

    ds = SyntheticSphereDataset(H=16, W=16, n_views=4)
    cfg = config.Config(
        workspace=os.path.join(d, "ws_viewer"),
        render=config.RenderConfig(**RC), model=config.ModelConfig(**MC),
        train=config.TrainConfig(**dict(TC, num_rays=128, n_devices=2,
                                        use_native_loader=False)))
    tr = Trainer("v", cfg, _model(MC), use_checkpoint="scratch",
                 device="cpu")
    # 16 x 32: every downscale the controller may pick (1..8) leaves an
    # even ray count, which 2 ranks divide
    session = InteractiveSession(cfg, tr.model, tr.eval_params(), None,
                                 H=16, W=32, fetch_format="rgb8",
                                 device="cpu", mesh=tr.mesh)
    out = {}
    if mesh.rank != 0:
        follow_gui(cfg, session, tr, ds)
    else:
        viewer = HeadlessViewer(cfg, session, tr, ds)
        for i in range(3):
            viewer.orbit(30, 0)
            out[f"frame{i}"] = torch.from_numpy(viewer.frame().rgb_u8)
        viewer.save_checkpoint()
        session.close()
    return {**out, "step": torch.tensor(tr.global_step),
            "digest": _digest(tr.state)}


def _multihost(mesh, d):
    """tests/test_multihost.py on the port: views split between the two
    processes, each samples half the global batch, distribute_batch, 3
    steps of the DP step."""
    model = _model(MC)
    tc = config.TrainConfig(**dict(TC, iters=10, num_rays=256,
                                   use_native_loader=False))
    s = dp.replicate_state(state_lib.create_train_state(
        model, tc, torch.Generator().manual_seed(0), device="cpu"), mesh)
    step = dp.make_dp_train_step(model, tc, mesh)
    ds = SyntheticSphereDataset(H=16, W=16, n_views=4)
    views = multihost.process_shard_indices(4)
    rng = np.random.default_rng(mesh.rank)
    gen = dp.rank_generator(0, mesh, "cpu")
    losses = []
    for _ in range(3):
        local = ds.collate_train(rng, multihost.local_batch_size(
            tc.num_rays))
        b = multihost.distribute_batch(local, mesh)
        draws = state_lib.draw_step(model, tc, b["rays_o"].shape[0], gen,
                                    "cpu")
        s, aux = step(s, b, draws)
        losses.append(float(aux["loss"]))
    return {"views": torch.as_tensor(views), "losses": torch.tensor(losses),
            "digest": _digest(s)}


def _collectives(mesh, d):
    """all_gather and all_reduce_sum forward and backward on tensors that
    differ by rank."""
    x = (torch.arange(6.0) + 10 * mesh.rank).reshape(3, 2)
    x.requires_grad_(True)
    w = torch.arange(6.0 * mesh.size).reshape(3 * mesh.size, 2)
    (collectives.all_gather(mesh, x) * w).sum().backward()
    y = torch.tensor(float(mesh.rank + 1), requires_grad=True)
    s = collectives.all_reduce_sum(mesh, y * y)
    s.backward()
    mean = collectives.all_reduce_mean(
        mesh, {"a": x.detach(), "b": [None, torch.tensor(mesh.rank * 2.0)]})
    return {"gathered": collectives.all_gather(mesh, x.detach()),
            "gather_grad": x.grad, "sum": s.detach(), "sum_grad": y.grad,
            "mean_a": mean["a"], "mean_b": mean["b"][1],
            "bytes": torch.tensor([list(b) for b in collectives.gather_bytes(
                mesh, bytes([mesh.rank, 7]))]),
            "broadcast": torch.tensor(collectives.broadcast_object(
                mesh, [mesh.rank + 5]))}


def _worker(rank, n, store_path, d, jobs, spec):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, n),
                            rank=rank, world_size=n)
    try:
        mesh = dp.make_mesh(n, "cpu")
        parts = {"render": _render, "grads": _grads, "sam": _sam,
                 "mask": _mask, "patched_mask": _patched_mask,
                 "replicas_mlp": lambda m, d: _replicas(m, d, MC),
                 "replicas_hashgrid": lambda m, d: _replicas(m, d, HASH_MC),
                 "trainer": _trainer,
                 "frame": lambda m, d: _frame(m, d, spec),
                 "viewer": _viewer,
                 "multihost": _multihost, "collectives": _collectives}
        for job in jobs:
            out = parts[job](mesh, d)
            _save(d, f"{job}_{n}_{rank}.npz",
                  **{k: torch.as_tensor(v).detach().numpy()
                     for k, v in out.items()})
            mesh.barrier()
    finally:
        dist.destroy_process_group()


def _spawn(n, d, jobs, spec):
    store = tempfile.mkdtemp(dir=d)
    ctx = mp.start_processes(_worker, args=(n, os.path.join(store, "s"), d,
                                            jobs, spec),
                             nprocs=n, join=False, start_method="spawn")
    deadline = time.time() + JOIN_TIMEOUT_S
    try:
        while not ctx.join(timeout=5):
            if time.time() > deadline:
                raise TimeoutError(f"{n} ranks did not end in "
                                   f"{JOIN_TIMEOUT_S} s ({jobs})")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()


# -- the JAX references -------------------------------------------------------

def _jax_references(d):
    """The JAX package's sharded results on its 8-device CPU mesh, and the
    inputs both sides share, as numpy files under `d`."""
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from sanerf_tpu import config as jc
    from sanerf_tpu.data.rays import sample_rays
    from sanerf_tpu.data.synthetic import SyntheticSphereDataset as JDS
    from sanerf_tpu.models import fields as jf
    from sanerf_tpu.models.renderer import run_rays
    from sanerf_tpu.models.sam import predictor as jpred
    from sanerf_tpu.ops import label_regularization
    from sanerf_tpu.parallel import dp as jdp
    from sanerf_tpu.train import checkpoints as jckpt
    from sanerf_tpu.train import distill, mask_trainer
    from sanerf_tpu.train import state as jstate
    from tests.test_sam import TINY_SAM
    from tests.test_torch_sam import port_cfg

    mesh = jdp.make_mesh()
    assert mesh.devices.size == 8
    jrc, jtc = jc.RenderConfig(**RC), jc.TrainConfig(**TC)
    flat = lambda t, p="params/": jckpt.flatten_tree(t, p)  # noqa: E731

    def grads_of(g):
        return {k: np.asarray(v) for k, v in flat(g, "").items()}

    # the render (tests/test_parallel.py:27-41), and padded
    model = jf.make_model(jc.ModelConfig(**MC), jrc)
    jp = jf.init_params(model, jax.random.key(0))
    _save(d, "mlp_params.npz", **flat(jp))
    rng = np.random.default_rng(0)
    ro = rng.normal(0, 0.5, (N_RENDER, 3)).astype(np.float32)
    rd = rng.normal(0, 1, (N_RENDER, 3)).astype(np.float32)
    render = jdp.make_dp_render(model, mesh)
    out = render(jp, jnp.asarray(ro), jnp.asarray(rd))
    pad = jdp.render_frame_dp(model, mesh, render, jp, jnp.asarray(ro[:-1]),
                              jnp.asarray(rd[:-1]))
    _save(d, "render_ref.npz", ro=ro, rd=rd,
          **{k: np.asarray(v) for k, v in out.items()},
          pad_image=np.asarray(pad["image"]),
          pad_depth=np.asarray(pad["depth"]))

    # the averaged shard gradients (tests/test_parallel.py:69-102)
    ds = JDS(H=32, W=32, n_views=4)
    batch = ds.collate_train(np.random.default_rng(1), 512)
    host = {k: batch[k] for k in ("rays_o", "rays_d", "images")}
    _save(d, "grads_batch.npz", **host)
    dev = {k: jnp.asarray(v) for k, v in host.items()}

    def shard_grads(params, b):
        def loss_fn(p):
            o = run_rays(model, p, b["rays_o"], b["rays_d"], training=True,
                         perturb=False)
            return jnp.mean((o["image"] - b["images"]) ** 2)
        return jax.lax.pmean(jax.grad(loss_fn)(params), "data")

    g = jax.jit(shard_map(shard_grads, mesh=mesh,
                          in_specs=(P(), jdp.batch_pspec(dev)),
                          out_specs=P(), check_vma=False))(jp, dev)
    _save(d, "grads_ref.npz", **grads_of(g))

    # stage 2 (tests/test_parallel.py:114-179)
    smc = jc.ModelConfig(**SAM_MC)
    smodel = jf.make_model(smc, jrc)
    sp = jf.init_params(smodel, jax.random.key(0))
    intr = ds.intrinsics * (SAM_HW / ds.H)
    intr[2:] = SAM_HW / 2
    rb = sample_rays(ds.poses[0], intr, SAM_HW, SAM_HW, N=-1)
    gt = np.random.default_rng(2).normal(0, 1, (16, 16, 32)).astype(
        np.float32)
    _save(d, "sam_params.npz", **flat(sp))
    _save(d, "sam_batch.npz", ro=rb.rays_o, rd=rb.rays_d, gt=gt)
    sro, srd, sgt = (jnp.asarray(rb.rays_o), jnp.asarray(rb.rays_d),
                     jnp.asarray(gt))

    def sam_grads(params, ro_, rd_):
        def loss_fn(p):
            o = run_rays(smodel, p, ro_, rd_, None, training=True,
                         return_feats=True, update_proposal=False)
            feats = jax.lax.all_gather(o["samvit"], "data", axis=0,
                                       tiled=True)
            pred = jax.image.resize(feats.reshape(SAM_HW, SAM_HW, -1),
                                    (16, 16, 32), "bilinear")
            return jnp.mean((pred - sgt) ** 2)
        return jax.lax.pmean(jax.grad(loss_fn)(params), "data")

    g = jax.jit(shard_map(sam_grads, mesh=mesh,
                          in_specs=(P(), P("data"), P("data")),
                          out_specs=P(), check_vma=False))(sp, sro, srd)
    scfg = jc.Config(render=jrc, model=smc, train=jtc)
    step = jdp.make_dp_sam_train_step(smodel, scfg, mesh, None, h=SAM_HW,
                                      w=SAM_HW)
    s8 = jdp.replicate_state(jstate.create_train_state(
        smodel, jtc, jax.random.key(0), params=sp), mesh)
    _, aux = step(s8, jdp.shard_batch({"rays_o_lr": sro, "rays_d_lr": srd},
                                      mesh), sgt, jax.random.key(0))
    _save(d, "sam_ref.npz", loss=np.asarray(aux["loss"]), **grads_of(g))
    del distill

    # stage 3 (tests/test_parallel.py:182-267)
    mmc = jc.ModelConfig(**MASK_MC)
    mmodel = jf.make_model(mmc, jrc)
    mp_ = jf.init_params(mmodel, jax.random.key(0))
    mcfg = jc.MaskTrainConfig(**MASK_CFG)
    cfg = jc.Config(render=jrc, model=mmc, train=jtc, mask=mcfg)
    mb = ds.collate_mask(np.random.default_rng(3), N_MASK)
    mhost = {k: mb[k] for k in ("rays_o", "rays_d", "masks")}
    _save(d, "mask_params.npz", **flat(mp_))
    _save(d, "mask_batch.npz", **mhost)
    mdev = {k: jnp.asarray(v) for k, v in mhost.items()}

    def mask_loss(params, b, num_global, axis_name=None):
        o = run_rays(mmodel, params, b["rays_o"], b["rays_d"], None,
                     training=True, return_mask=True)
        probs = jnp.clip(jax.nn.softmax(o["instance_mask_logits"], -1),
                         mcfg.epsilon, 1 - mcfg.epsilon)
        gtm = b["masks"]
        labeled = gtm != -1
        onehot = jax.nn.one_hot(jnp.maximum(gtm, 0), 2)
        nll = jnp.where(labeled, -jnp.log(jnp.sum(onehot * probs, -1)), 0.0)
        nll_sum, n_lab = jnp.sum(nll), jnp.sum(labeled)
        if axis_name:
            nll_sum = jax.lax.psum(nll_sum, axis_name)
            n_lab = jax.lax.psum(n_lab, axis_name)
        loss = nll_sum / jnp.maximum(n_lab, 1)
        lr_loss = label_regularization(
            jax.lax.stop_gradient(o["depth"]), probs, 4, 2,
            axis_name=axis_name)
        return loss + 0.1 * lr_loss

    def mask_grads(params, b):
        return jax.lax.pmean(jax.grad(mask_loss)(
            params, b, N_MASK // 8, axis_name="data"), "data")

    g = jax.jit(shard_map(mask_grads, mesh=mesh,
                          in_specs=(P(), jdp.batch_pspec(mdev)),
                          out_specs=P(), check_vma=False))(mp_, mdev)
    step_1 = mask_trainer.make_mask_train_step(mmodel, cfg, None)
    s1 = jstate.create_train_state(mmodel, jtc, jax.random.key(0),
                                   params=mp_)
    _, aux1 = step_1(s1, mdev, jax.random.key(1), num_global=N_MASK,
                     use_similarity=False)
    _save(d, "mask_ref.npz", loss=np.asarray(aux1["loss"]),
          error=np.asarray(aux1["error"]), pred=np.asarray(aux1["pred"]),
          **grads_of(g))

    # a batch with patches (tests/test_parallel.py:270-308) and JAX's
    # per-chip layout of it on 2, 4 and 8 devices
    pb = ds.collate_mask(np.random.default_rng(4), 64)
    prb = sample_rays(ds.poses[0], ds.intrinsics, 32, 32, N=32,
                      rng=np.random.default_rng(5), patch_size=2)
    patched = {
        "rays_o": np.concatenate([pb["rays_o"], prb.rays_o]),
        "rays_d": np.concatenate([pb["rays_d"], prb.rays_d]),
        "masks": np.concatenate([pb["masks"],
                                 np.zeros(32, pb["masks"].dtype)]),
        "incoherent_masks": np.zeros(96, np.float32),
        "cam_near_far": np.asarray([[0.1, 6.0]], np.float32)}
    _save(d, "patched_batch.npz", **patched)
    layouts = {}
    for n in (2, 4, 8):
        laid, gn = jdp.shard_mask_batch(patched, jdp.make_mesh(n), 64, 4)
        layouts.update({f"{n}/{k}": np.asarray(v) for k, v in laid.items()})
        layouts[f"{n}/gn"] = np.asarray(gn)
    _save(d, "layout_ref.npz", **layouts)

    # the interactive frame's weights and the tiny SAM decoder
    fmodel = jf.make_model(jc.ModelConfig(**dict(
        MC, with_sam=True, sam_use_view_direction=True, sam_feat_dim=32)),
        jrc)
    _save(d, "frame_params.npz", **flat(jf.init_params(fmodel,
                                                        jax.random.key(0))))
    _save(d, "tiny_sam.npz", **flat(jpred.init_params(
        TINY_SAM, jax.random.key(1)), ""))
    return {"sam": port_cfg(TINY_SAM)}


ALL_JOBS = ("collectives", "render", "grads", "sam", "mask", "patched_mask",
            "replicas_mlp", "replicas_hashgrid", "trainer", "frame",
            "viewer", "multihost")
FOUR_RANK_JOBS = ("render", "grads", "sam", "mask")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """-> (dir, read(job, n) -> [per-rank dict]) after the JAX references
    and the 2- and 4-rank runs."""
    d = str(tmp_path_factory.mktemp("parallel"))
    spec = _jax_references(d)
    _spawn(2, d, ALL_JOBS, spec)
    _spawn(4, d, FOUR_RANK_JOBS, spec)

    def read(job, n=2):
        return [_load(d, f"{job}_{n}_{r}.npz") for r in range(n)]

    return types.SimpleNamespace(dir=d, read=read,
                                 ref=lambda name: _load(d, name))


# -- the tests ----------------------------------------------------------------

def test_make_mesh_needs_a_process_group():
    """No silent 1-rank mesh: without an initialised group make_mesh
    raises, and so does a Trainer asked for 2 devices; initialize is a
    no-op in a single process, as in JAX."""
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="no torch.distributed"):
        dp.make_mesh(2, "cpu")
    multihost.initialize()
    assert not dist.is_initialized()
    np.testing.assert_array_equal(multihost.process_shard_indices(10),
                                  np.arange(10))
    assert multihost.local_batch_size(64) == 64


def test_collectives(ranks):
    for n in (2,):
        got = ranks.read("collectives", n)
        want = np.concatenate([(np.arange(6.0) + 10 * r).reshape(3, 2)
                               for r in range(n)])
        w = np.arange(6.0 * n).reshape(3 * n, 2)
        for r, g in enumerate(got):
            np.testing.assert_array_equal(g["gathered"], want)
            # psum_scatter of n identical cotangents: n x this rank's rows
            np.testing.assert_array_equal(g["gather_grad"],
                                          n * w[3 * r:3 * r + 3])
            assert g["sum"] == sum((k + 1) ** 2 for k in range(n))
            assert g["sum_grad"] == n * 2 * (r + 1)
            np.testing.assert_array_equal(
                g["mean_a"], want.reshape(n, 3, 2).mean(0))
            assert g["mean_b"] == (n - 1)
            np.testing.assert_array_equal(g["bytes"],
                                          [(k, 7) for k in range(n)])
            np.testing.assert_array_equal(g["broadcast"], [5])


@pytest.mark.parametrize("n", [2, 4])
def test_dp_render_matches_jax(ranks, n):
    ref = ranks.ref("render_ref.npz")
    for got in ranks.read("render", n):
        np.testing.assert_allclose(got["image"], ref["image"], rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(got["depth"], ref["depth"], rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(got["weights_sum"], ref["weights_sum"],
                                   rtol=1e-4, atol=1e-5)
        # 63 rays: padded to the mesh, trimmed
        assert got["pad_image"].shape == (N_RENDER - 1, 3)
        np.testing.assert_allclose(got["pad_image"], ref["pad_image"],
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got["pad_depth"], ref["pad_depth"],
                                   rtol=1e-4, atol=1e-4)


def _same_grads(got, ref):
    keys = sorted(k[2:] for k in got if k.startswith("g/"))
    assert keys == sorted(ref), (keys, sorted(ref))
    for k in ref:
        np.testing.assert_allclose(got["g/" + k], ref[k], rtol=2e-3,
                                   atol=2e-5, err_msg=k)


@pytest.mark.parametrize("n", [2, 4])
def test_dp_grads_match_jax_pmean(ranks, n):
    ref = ranks.ref("grads_ref.npz")
    got = ranks.read("grads", n)
    for g in got:
        _same_grads(g, ref)
    for g in got[1:]:  # the averaged gradients are the same on every rank
        for k in g:
            np.testing.assert_array_equal(g[k], got[0][k], k)


@pytest.mark.parametrize("n", [2, 4])
def test_dp_sam_step_matches_jax(ranks, n):
    ref = ranks.ref("sam_ref.npz")
    for got in ranks.read("sam", n):
        _same_grads(got, {k: v for k, v in ref.items() if k != "loss"})
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_mask_batch_layout_is_jaxs(ranks, n):
    """dp.mask_batch_layout against JAX dp.shard_mask_batch, bit for bit
    (8 with no ranks: the layout is a pure function)."""
    ref = ranks.ref("layout_ref.npz")
    laid, gn = dp.mask_batch_layout(ranks.ref("patched_batch.npz"), n, 64, 4)
    assert gn == int(ref[f"{n}/gn"])
    for k, v in laid.items():
        # JAX holds int64 labels as int32 (x64 off): the values are compared
        assert v.dtype.kind == ref[f"{n}/{k}"].dtype.kind, k
        np.testing.assert_array_equal(v, ref[f"{n}/{k}"], k)
    if n == 2:  # the ranks' blocks, in rank order, are the layout
        blocks = ranks.read("mask", 2)
        np.testing.assert_array_equal(
            np.concatenate([b["block_masks"] for b in blocks]),
            ref["2/masks"])
        np.testing.assert_array_equal(
            np.concatenate([b["block_rays"] for b in blocks]),
            ref["2/rays_o"])
        assert all(int(b["block_gn"]) == gn for b in blocks)


@pytest.mark.parametrize("n", [2, 4])
def test_dp_mask_step_matches_jax(ranks, n):
    ref = ranks.ref("mask_ref.npz")
    for got in ranks.read("mask", n):
        _same_grads(got, {k: v for k, v in ref.items()
                          if k not in ("loss", "error", "pred")})
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
        np.testing.assert_allclose(got["error"], ref["error"], rtol=1e-3,
                                   atol=1e-5)
        assert got["pred"].shape == ref["pred"].shape


def test_dp_mask_step_with_patches_runs(ranks):
    got = ranks.read("patched_mask")
    assert all(np.isfinite(g["loss"]) for g in got)
    assert got[0]["digest"].tobytes() == got[1]["digest"].tobytes()


@pytest.mark.parametrize("family", ["mlp", "hashgrid"])
def test_replicas_stay_equal(ranks, family):
    """8 steps: every rank's params, EMA and Adam moments equal bit for bit
    (the hash grid's table gradient sums in another order on each rank;
    the all-reduced gradient is the same everywhere)."""
    got = ranks.read(f"replicas_{family}")
    assert all(int(g["step"]) == 8 for g in got)
    assert got[0]["digest"].tobytes() == got[1]["digest"].tobytes()
    losses = got[0]["losses"]
    assert np.isfinite(losses).all()
    np.testing.assert_array_equal(losses, got[1]["losses"])
    assert np.mean(losses[-3:]) < losses[0] * 1.5


def test_trainer_dp_trains_evaluates_and_resumes(ranks):
    """Trainer(n_devices=2): 60 steps, a sharded evaluation, a checkpoint
    written by rank 0 and resumed on both ranks with equal replicas; its
    PSNR within 3 dB of the single-device Trainer's on the same steps
    (tests/test_parallel.py:372)."""
    got = ranks.read("trainer")
    for g in got:
        assert int(g["step"]) == int(g["resumed_step"]) == 60
        assert g["digest"].tobytes() == g["resumed"].tobytes()
        assert int(g["ckpts"]) >= 1
    assert got[0]["digest"].tobytes() == got[1]["digest"].tobytes()
    assert got[0]["psnr2"] == got[1]["psnr2"]
    assert np.isfinite(got[0]["psnr1"]) and np.isfinite(got[0]["psnr2"])
    assert abs(float(got[0]["psnr1"]) - float(got[0]["psnr2"])) < 3.0
    logs = os.listdir(os.path.join(ranks.dir, "ws2"))
    assert "log_dp.txt" in logs and "metrics_dp.jsonl" in logs
    with open(os.path.join(ranks.dir, "ws2", "log_dp.txt")) as f:
        saves = [line.split(":", 1)[1].split() for line in f
                 if line.startswith("[ckpt] replica digests")]
    assert saves and all(len(d) == 2 and d[0] == d[1] for d in saves)


def test_frame_pipeline_sharded_matches_single(ranks):
    """The interactive frame over 2 ranks (rank 1 following) against the
    single-device frame: FramePipeline and InteractiveSession (a click,
    then a downscaled frame)."""
    g = ranks.read("frame")[0]
    for a, b in (("single", "sharded"),
                 ("single_session", "sharded_session")):
        d = np.abs(g[f"{a}_img"].astype(np.int32)
                   - g[f"{b}_img"].astype(np.int32))
        assert d.max() <= 1, (a, d.max())
        np.testing.assert_allclose(g[f"{a}_depth"], g[f"{b}_depth"],
                                   rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(g["single_valid"], g["sharded_valid"])
    assert int(g["dispatches"]) == 1


def test_viewer_trains_with_a_follower(ranks):
    """Rank 1 takes the training steps rank 0's viewer takes between its
    frames (16 a frame to start, then the controller's), and the save: the
    same step count and replicas."""
    got = ranks.read("viewer")
    assert int(got[0]["step"]) == int(got[1]["step"]) >= 3 * 4
    assert got[0]["digest"].tobytes() == got[1]["digest"].tobytes()
    assert all(got[0][f"frame{i}"].shape == (16, 32, 3) for i in range(3))
    assert os.listdir(os.path.join(ranks.dir, "ws_viewer", "checkpoints"))


def test_native_loader_gives_every_rank_one_global_batch():
    """The Trainer's native loader on a mesh (one worker thread, the same
    seed on every rank) draws the same batches in the same order on every
    rank, so that each rank's slice is a slice of one global batch."""
    from sanerf_tpu_torch.data.native_loader import NativeRaySampler

    ds = SyntheticSphereDataset(H=16, W=16, n_views=4)
    samplers = [NativeRaySampler(ds.poses, ds.intrinsics, ds.images, 64,
                                 seed=3, prefetch_depth=6, n_threads=1)
                for _ in range(2)]
    try:
        for _ in range(4):
            a, b = (s.collate_train() for s in samplers)
            for k in ("rays_o", "rays_d", "images"):
                np.testing.assert_array_equal(a[k], b[k])
            assert a["index"] == b["index"]
    finally:
        for s in samplers:
            s.close()


def test_frame_pipeline_refuses_a_frame_that_does_not_divide():
    from sanerf_tpu_torch.apps.frame_pipeline import FramePipeline

    mesh = types.SimpleNamespace(size=2, rank=0,
                                 device=torch.device("cpu"))
    with pytest.raises(ValueError, match="divide"):
        FramePipeline(_model(MC), None, None, None, 15, 15, mesh=mesh)


def test_two_process_multihost(ranks):
    """tests/test_multihost.py's protocol: 2 views a process, local
    batches through distribute_batch, 3 steps, identical replicas."""
    got = ranks.read("multihost")
    np.testing.assert_array_equal(got[0]["views"], [0, 2])
    np.testing.assert_array_equal(got[1]["views"], [1, 3])
    assert got[0]["digest"].tobytes() == got[1]["digest"].tobytes()
    assert np.isfinite(got[0]["losses"]).all()


def test_distribute_batch_broadcasts_per_view_near_far():
    mesh = types.SimpleNamespace(device=torch.device("cpu"))
    b = multihost.distribute_batch(
        {"rays_o": np.zeros((6, 3), np.float32), "H": 4,
         "cam_near_far": np.asarray([[0.5, 3.0]], np.float32)}, mesh)
    assert sorted(b) == ["cam_near_far", "rays_o"]
    assert b["cam_near_far"].shape == (6, 2)
    assert (b["cam_near_far"] == torch.tensor([0.5, 3.0])).all()


def test_shard_batch_slices_and_replicates():
    batch = {"rays_o": np.arange(12, dtype=np.float32).reshape(4, 3),
             "cam_near_far": np.ones((1, 2), np.float32), "H": 2}
    assert dp.batch_pspec(batch) == {"rays_o": True, "cam_near_far": False,
                                     "H": False}
    for r in range(2):
        mesh = dp.Mesh(None, r, 2, torch.device("cpu"))
        got = dp.shard_batch(batch, mesh)
        np.testing.assert_array_equal(got["rays_o"],
                                      batch["rays_o"][2 * r:2 * r + 2])
        assert got["cam_near_far"].shape == (1, 2) and "H" not in got
    with pytest.raises(ValueError, match="divide"):
        dp.shard_batch({"rays_o": np.zeros((3, 3))},
                       dp.Mesh(None, 0, 2, torch.device("cpu")))
