"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. build the CUDA kernels from sanerf_tpu_torch/csrc (one nvcc per source,
     all started together) and print the card's name and power limit;
  2. hold each kernel against its plain PyTorch version on the card, at the
     shapes the main path gives it (captured from 512^2 frames of the
     shipped asset at the (32, 16) and (128, 64, 32) hierarchies) and at
     small ragged shapes. Ray kernels: 1e-5 (|d| <= tol + tol |ref|). MLP
     kernels: with the serving bf16 weights the JAX suite's 0.05 (see
     MLP_TOL), and with float32 weights the JAX suite's float32 bounds,
     element by element;
  3. drive the main path: a 512^2 frame of assets/serving_student through
     render_frame at (32, 16) and at (128, 64, 32) with bf16 params, with
     every launch counter set to 0 just before and read just after; then
     the fast path against the plain path with float32 params (2e-3, see
     PATH_TOL) and frame times;
  4. held-out PSNR on the textured fixture (bench.py:149-170 protocol)
     against the JAX package's value for the same protocol;
  5. the interactive segmentation frame (bench.py's product loop): the
     asset with a seeded SAM feature head and SAM's full decoder
     (`SamConfig()`, seeded bf16 weights), one 3D point at the origin,
     512^2 through `InteractiveSession.step` at (32, 16) and (128, 64, 32),
     launch counters set to 0 just before a frame and read just after,
     finite depth / samvit [32, 32, 256] / mask logits;
  6. the render options on the same frames: `flatten_kernel` (flatten3_nt
     launches, pixels identical to the default) and `packed_epilogue` on
     the RGB frame (within 1e-6 of the default), each path driven with the
     counters set to 0; flatten3_nt and the packed variants of ray_level0,
     ray_level and run_tmlp_composite held against their plain versions at
     those frames' shapes and at ragged ones;
  7. mask mIoU of assets/serving_student_mask through the port's fast path
     (bench.py:173-225 protocol) against the JAX package's value;
  8. interactive frame times (bench.py:_drive protocol), pipelined and sync;
  9. the table gather `gather_rows` at the shapes of the eight Pallas probes
     of tools/probe_gather.py (2^19-row tables, 2^21 indices; C = 2, 128
     and 8-row blocks; float32 and bf16), bit for bit against its plain
     version, with the out-of-range fill, times, bounds and
     `torch.index_select`'s time;
 10. the hash-grid family's interactive frame: `ModelConfig(field_type=
     "hashgrid", with_sam=True)` at full width, tables redrawn
     U(-TABLE_STD, TABLE_STD), bf16, 512^2 through `InteractiveSession.step`
     at (128, 64, 32) with SAM's seeded decoder, the gather's counter set to
     0 just before a frame and read just after (HASHGRID_LAUNCHES), finite
     depth / samvit [32, 32, 256] / mask logits, every gather of that frame
     bit for bit against the plain version, frame times;
 11. the same RGB frame with float32 params, with the gather swapped for
     its plain version inside this script: identical to the kernel's frame;
 12. a 64^2 frame of the same model with the numpy-seeded params of
     port_tools/hashgrid_params.py against the JAX package's values
     (JAX_HASHGRID, 2e-3);
 13. `run_rays(return_mask=True)` at 512^2 with the default mask head
     (MASK_LAUNCHES gathers, finite logits);
 14. one {"kernels": [...]} line, one {"frames": ...} line, one
     {"interactive": ...} line, one {"hashgrid": ...} line, and last
     {"ok": true, "device": {...}}.
Needs no network; builds into build/kernels/.
"""

import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

#: Held-out PSNR of the shipped asset through the JAX package's XLA path
#: (use_fused_mlp=False) on the CPU, bf16 params, (32, 16) hierarchy, the
#: bench.py:149-170 protocol; from
#: `JAX_PLATFORMS=cpu python port_tools/jax_psnr_reference.py`.
JAX_PSNR_32_16_BF16 = 21.203517998498757
#: the same at the full (128, 64, 32) hierarchy
JAX_PSNR_FULL_BF16 = 21.39814067011814
PSNR_TOL_DB = 0.2
#: Held-out mask mIoU of assets/serving_student_mask through the JAX
#: package's XLA path on the CPU, bf16 params, (32, 16), bench.py:173-225
#: protocol; from `JAX_PLATFORMS=cpu python port_tools/jax_miou_reference.py`.
JAX_MIOU_32_16_BF16 = 0.9080225199611455
MIOU_TOL = 0.005
#: packed epilogue against the default frame (the JAX suite's bound,
#: tests/test_ray_kernels.py:197-226)
PACKED_TOL = 1e-6
RAY_TOL = 1e-5
#: bf16 MLP kernels against their plain versions: the JAX suite's bf16
#: bound, |d| <= 0.05 + 0.05 |ref| element by element
#: (tests/test_fused_mlp_t.py), on all but FLIP_SHARE of the outputs, and
#: those few within MLP_TOL * max|ref|. Both versions round the hidden
#: activations to bf16 after a float32 sum taken in another order
#: (tensor-core MMA against cuBLAS); among millions of points a few
#: activations land on the other side of a rounding boundary, and each such
#: flip moves an output by one bf16 step of that activation (0.25 at 32-64),
#: whatever the size of the output it lands in. The float32-weight check
#: below holds the same kernels element by element.
MLP_TOL = 0.05
FLIP_SHARE = 1e-5
#: float32 weights: the JAX suite's float32 bounds (tests/test_fused_mlp_t.py)
MLP_F32_TOL = {"run_tmlp": 3e-4, "run_tmlp_composite": 1e-3}
#: fast path against the plain path, float32 params: 2e-3 element by element
#: (the JAX suite's bound, tests/test_ray_kernels.py:74-148) for image and
#: weights_sum on every ray, and for depth on all but DEPTH_SHARE of the
#: rays, those within DEPTH_MAX. The two paths compute the frame by
#: different arithmetic (angle-doubling against dense Fourier features, the
#: clamped-ramp resample against sample_pdf), and on a few rays whose weight
#: sits between two depths the depth moves by more than 2e-3: the JAX
#: package's own two paths do the same on this frame
#: (`JAX_PLATFORMS=cpu python port_tools/jax_path_gap.py`).
PATH_TOL = 2e-3
DEPTH_SHARE = 5e-4
DEPTH_MAX = 0.05
#: H100 SXM (NVIDIA data sheet, dense, at 700 W): 3.35 TB/s HBM3,
#: 989 TFLOP/s bf16 tensor cores, 67 TFLOP/s float32 outside them.
HBM_BPS, BF16_FLOPS, F32_FLOPS = 3.35e12, 989e12, 67e12
SERVE_POSE = [[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 2.0], [0, 0, 0, 1]]
SIZE = 512
HIERARCHIES = {"32,16": (32, 16), "128,64,32": (128, 64, 32)}
KERNELS = ("ray_level0", "ray_level", "run_tmlp", "run_tmlp_composite")
#: launches per interactive frame (RGB render + 32^2 feature render) of
#: ray_level0 / ray_level / run_tmlp / run_tmlp_composite / flatten3_nt
INTERACTIVE_LAUNCHES = {"32,16": [2, 2, 3, 1, 0],
                        "128,64,32": [2, 4, 5, 1, 0]}
#: flatten3_nt launches per interactive frame under flatten_kernel
FLATTEN_LAUNCHES = {"32,16": 4, "128,64,32": 6}
#: gathers per 512^2 hash-grid interactive frame at (128, 64, 32), one
#: launch per grid level: the RGB render (5 + 5 proposal levels + 16 field
#: levels) and the 32^2 feature render (the same 26 + 16 s_grid levels)
HASHGRID_LAUNCHES = 26 + 42
#: gathers of one return_mask frame: the RGB render's 26 + 16 m_grid levels
MASK_LAUNCHES = 26 + 16
#: The 64^2 frame of ModelConfig(field_type="hashgrid", with_sam=True),
#: RenderConfig() defaults, float32 params of
#: port_tools/hashgrid_params.py:make_flat(shapes, 0) (TABLE_STD 2.0),
#: through the JAX package's run_rays(return_feats=True) on the CPU; from
#: `JAX_PLATFORMS=cpu python port_tools/jax_hashgrid_reference.py`.
JAX_HASHGRID = {
    "pixels": [0, 650, 1500, 2015, 2080, 2700, 3333, 4095],
    "channels": [0, 1, 128, 255],
    "mean": {"image": 0.5037444182986898, "depth": 1.243341827444965,
             "weights_sum": 1.000000001047738,
             "samvit": 1.7307304743009733e-10},
    "image": [[0.49564194679260254, 0.5094882845878601, 0.5137070417404175],
              [0.49897682666778564, 0.5119962692260742, 0.5117372870445251],
              [0.5011422038078308, 0.5100667476654053, 0.512299120426178],
              [0.5014047026634216, 0.5072685480117798, 0.5100390911102295],
              [0.5010114908218384, 0.5068326592445374, 0.5094492435455322],
              [0.49927613139152527, 0.5050472617149353, 0.5087454319000244],
              [0.49737322330474854, 0.5017687082290649, 0.5110596418380737],
              [0.4961124062538147, 0.5009494423866272, 0.5003986358642578]],
    "depth": [1.2447432279586792, 1.2623270750045776, 1.2497308254241943,
              1.2582191228866577, 1.2572133541107178, 1.2506392002105713,
              1.2629318237304688, 1.2255713939666748],
    "weights_sum": [1.0000001192092896, 0.9999999403953552,
                    0.9999998211860657, 1.0, 1.0, 0.9999998807907104,
                    0.9999999403953552, 1.0000001192092896],
    "samvit": [[0.31635668873786926, -1.5217617750167847, -0.9209179282188416,
                -0.808202862739563],
               [0.13284479081630707, -1.7957218885421753, -0.540861964225769,
                -0.7752104997634888],
               [0.4856792688369751, -1.773276448249817, -0.7730880379676819,
                -0.7996563911437988],
               [0.6615070104598999, -1.4945847988128662, -1.1283538341522217,
                -0.7630659341812134],
               [0.6404577493667603, -1.5550992488861084, -1.0329889059066772,
                -0.7169311046600342],
               [1.055557370185852, -1.727152943611145, -1.3863506317138672,
                -0.6143483519554138],
               [0.7812843322753906, -1.2480156421661377, -0.8907264471054077,
                -0.756634533405304],
               [0.38222193717956543, -1.5014022588729858, -1.0049128532409668,
                -0.7024018168449402]],
}
JAX_HASHGRID_TOL = 2e-3
#: the eight Pallas probes of tools/probe_gather.py as gathers of a
#: 2^19-row table at 2^21 seeded indices: (name, probe line, row width C,
#: table rows used (None = all), index form, block_rows).
#: pallas_take_small and p_blk cannot run as written (operands in the
#: reverse order of their in_specs; a 1-D index read as i[:n, 0]); these
#: rows compute their evident intent.
PROBE_ROWS, PROBE_IDX = 2 ** 19, 2 ** 21
PROBES = (
    ("pallas_dynloop", 90, 2, None, "blocks", 1),
    ("pallas_dynloop_vmem", 109, 2, None, "blocks", 1),
    ("pallas_take", 125, 2, None, "blocks", 1),
    ("pallas_take_small", 142, 128, 4096, "mod4096", 1),
    ("p_loop", 185, 2, None, "flat", 1),
    ("p2_take", 202, 2, None, "flat", 1),
    ("p_loop8", 226, 2, None, "flat", 1),
    ("p_blk", 244, 2, None, "div8", 8),
)
SOURCES = {
    "ray_level0": ("sanerf_tpu_torch/csrc/ray_kernels.cu",
                   "sanerf_tpu/ops/ray_kernels.py:275"),
    "ray_level": ("sanerf_tpu_torch/csrc/ray_kernels.cu",
                  "sanerf_tpu/ops/ray_kernels.py:310"),
    "run_tmlp": ("sanerf_tpu_torch/csrc/fused_mlp_t.cu",
                 "sanerf_tpu/ops/fused_mlp_t.py:1077"),
    "run_tmlp_composite": ("sanerf_tpu_torch/csrc/fused_mlp_t.cu",
                           "sanerf_tpu/ops/fused_mlp_t.py:885"),
    "flatten3_nt": ("sanerf_tpu_torch/csrc/ray_kernels.cu",
                    "sanerf_tpu/ops/ray_kernels.py:247"),
    "packed_epilogue": ("sanerf_tpu_torch/csrc/fused_mlp_t.cu",
                        "sanerf_tpu/ops/fused_mlp_t.py:757"),
}


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    if not os.path.isdir(os.path.join(ROOT, "sanerf_tpu_torch")):
        fail("run from a checkout of the repository (sanerf_tpu_torch/ missing)")
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import dataclasses

    import numpy as np

    from sanerf_tpu_torch.data.rays import full_frame_rays
    from sanerf_tpu_torch.data.synthetic import SyntheticSphereDataset
    from sanerf_tpu_torch.models import fields, renderer
    from sanerf_tpu_torch.models.asset import load_asset
    from sanerf_tpu_torch.ops import _build
    from sanerf_tpu_torch.ops import fused_mlp_t as fm
    from sanerf_tpu_torch.ops import ray_kernels as rk
    from sanerf_tpu_torch.train.metrics import PSNRMeter
    from sanerf_tpu_torch.utils.camera import fov_to_focal

    # -- 1. build + card --------------------------------------------------
    t0 = time.time()
    logs = _build.build_all()
    log(f"build: {time.time() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)

    mc, rc, params32 = load_asset(os.path.join(ROOT, "assets",
                                               "serving_student"), device=dev)
    params = fields.cast_params(params32, torch.bfloat16)

    def model_at(steps, **kw):
        return fields.make_model(mc, dataclasses.replace(
            rc, num_steps=steps, max_ray_batch=SIZE * SIZE, **kw))

    focal = fov_to_focal(60.0, SIZE)
    intr = [focal, focal, SIZE / 2, SIZE / 2]
    rays_o, rays_d = full_frame_rays(np.asarray(SERVE_POSE, np.float32),
                                     np.asarray(intr, np.float32), SIZE, SIZE,
                                     device=dev)
    models = {h: model_at(s) for h, s in HIERARCHIES.items()}
    # the packed weights depend on the params only, not on the hierarchy
    nets = fields.KernelNets(models["32,16"], params)
    nets32 = fields.KernelNets(models["32,16"], params32)
    twin = {id(a): b for a, b in zip([*nets.props, nets.field, nets.view],
                                     [*nets32.props, nets32.field,
                                      nets32.view])}

    # -- 2. kernels against their plain versions ---------------------------
    kern_fn = {"ray_level0": rk.ray_level0, "ray_level": rk.ray_level,
               "run_tmlp": fm.run_tmlp,
               "run_tmlp_composite": fm.run_tmlp_composite,
               "flatten3_nt": rk.flatten3_nt}
    plain_fn = {
        "ray_level0": rk.ray_level0_plain,
        "ray_level": rk.ray_level_plain,
        "run_tmlp": lambda x, tm, transposed: fm.run_tmlp_plain(x, tm),
        "run_tmlp_composite": fm.run_tmlp_composite_plain,
        "flatten3_nt": rk.flatten3_nt_plain,
    }
    # first call of each kernel in one frame per hierarchy: (args, kwargs)
    seen = {}
    spied = {"ray_level0": renderer, "ray_level": renderer,
             "run_tmlp": fields, "run_tmlp_composite": fields}
    for h, model in models.items():
        def spy(name, fn):
            def wrapped(*a, **k):
                seen.setdefault((h, name), (a, k))
                return fn(*a, **k)
            return wrapped

        for n, m in spied.items():
            setattr(m, n, spy(n, kern_fn[n]))
        try:
            renderer.render_frame(model, params, rays_o, rays_d,
                                  chunk=SIZE * SIZE, nets=nets)
        finally:
            for n, m in spied.items():
                setattr(m, n, kern_fn[n])
        torch.cuda.synchronize()
        check({n for (hh, n) in seen if hh == h} == set(KERNELS),
              f"{h}: the main path missed a kernel: {sorted(seen)}")

    def compare(name, a, k, tol, flips):
        """Kernel vs plain on the same inputs -> (max abs err, outputs past
        tol + tol |ref|). Fails where
        |d| > tol + tol |ref|; with `flips` (bf16 weights), on more than
        FLIP_SHARE of the outputs or past tol * max|ref| (see MLP_TOL)."""
        got = kern_fn[name](*a, **k)
        ref = plain_fn[name](*a, **k)
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        err, past = 0.0, 0
        for g, r in zip(got, ref):
            check(g.shape == r.shape, f"{name}: shape {g.shape} vs {r.shape}")
            check(bool(torch.isfinite(g).all()), f"{name}: non-finite output")
            if not r.numel():
                continue
            d = (g - r).abs()
            e = float(d.max())
            err = max(err, e)
            n_over = int((d > tol + tol * r.abs()).sum())
            past += n_over
            if flips:
                ok = (n_over <= math.ceil(FLIP_SHARE * r.numel())
                      and e <= tol * max(1.0, float(r.abs().max())))
            else:
                ok = n_over == 0
            check(ok, f"{name}: kernel disagrees with its plain version "
                      f"(max abs err {e:.3g}, {n_over} of {r.numel()} "
                      f"outputs past {tol} + {tol} |ref|)")
        del got, ref
        torch.cuda.empty_cache()
        return err, past

    def to_f32(a, k):
        return (tuple(twin.get(id(v), v) for v in a),
                {kk: twin.get(id(v), v) for kk, v in k.items()})

    errs = {n: {} for n in KERNELS}
    errs32 = {n: {} for n in KERNELS}
    flipped = {n: {} for n in KERNELS}
    for (h, name), (a, k) in seen.items():
        if name.startswith("ray"):
            errs[name][h], _ = compare(name, a, k, RAY_TOL, flips=False)
        else:
            errs[name][h], flipped[name][h] = compare(name, a, k, MLP_TOL,
                                                      flips=True)
            errs32[name][h], _ = compare(name, *to_f32(a, k),
                                         MLP_F32_TOL[name], flips=False)
    log(f"main-path shapes: max abs err bf16 {errs} f32 {errs32}, "
        f"bf16 outputs past the elementwise bound {flipped}")

    # small ragged shapes, and the options the main path does not take
    g = torch.Generator(device=dev).manual_seed(0)
    n_r = 997
    r8 = seen[("32,16", "ray_level0")][0][0][:n_r].contiguous()
    b0, _, _, _ = rk.ray_level0(r8, 128, True)
    w0 = torch.rand(n_r, 128, generator=g, device=dev)
    w0[::7] = 0.0
    compare("ray_level0", (r8, 128, True),
            {"jitter": (torch.rand(n_r, 129, generator=g, device=dev) - .5)
             / 128}, RAY_TOL, flips=False)
    compare("ray_level0", (r8, 7, False), {}, RAY_TOL, flips=False)
    for uniform_prev in (False, True):
        compare("ray_level", (r8, w0, b0, 64, True),
                {"uniform_prev": uniform_prev,
                 "jitter": (torch.rand(n_r, 65, generator=g, device=dev) - .5)
                 / 65}, RAY_TOL, flips=False)
    xr = torch.rand(3, n_r * 16 + 5, generator=g, device=dev) * 4 - 2
    for tm in (nets.props[0], nets.field):
        compare("run_tmlp", (xr, tm), {"transposed": True}, MLP_TOL,
                flips=True)
        compare("run_tmlp", *to_f32((xr, tm), {"transposed": True}),
                MLP_F32_TOL["run_tmlp"], flips=False)
    for T, opaque, view in ((16, True, nets.view), (32, False, nets.view),
                            (4, True, None)):
        xT = torch.rand(3, n_r * T, generator=g, device=dev) * 4 - 2
        dl = torch.rand(n_r, T, generator=g, device=dev) * 0.1
        ts = torch.cumsum(dl, 1) + 0.5
        a = (xT, dl, ts, nets.field)
        k = {"opaque": opaque, "view": view, "rays8": r8}
        compare("run_tmlp_composite", a, k, MLP_TOL, flips=True)
        compare("run_tmlp_composite", *to_f32(a, k),
                MLP_F32_TOL["run_tmlp_composite"], flips=False)
    log("ragged shapes: ok")

    # -- 3. the main path --------------------------------------------------
    counters = [kern_fn[n] for n in KERNELS]
    for c in counters:
        c.launches = 0
    per_frame, frames = {}, {}
    for h, model in models.items():
        before = [c.launches for c in counters]
        frames[h] = renderer.render_frame(model, params, rays_o, rays_d,
                                          chunk=SIZE * SIZE)
        torch.cuda.synchronize()
        per_frame[h] = [c.launches - b for c, b in zip(counters, before)]
    launches = [c.launches for c in counters]
    check(all(n > 0 for n in launches), f"a kernel never ran: {launches}")
    for h, out in frames.items():
        check(out["image"].shape == (SIZE * SIZE, 3), f"{h}: image shape")
        for k, v in out.items():
            check(bool(torch.isfinite(v).all()), f"{h}: {k} not finite")
        check(float(out["weights_sum"].min()) > 0.5,
              f"{h}: weights_sum {float(out['weights_sum'].min())}")
    log(f"launches per frame {per_frame}")
    del frames

    # fast vs plain path, float32 params, on a quarter of the frame (rows
    # 128-255, the band of port_tools/jax_path_gap.py)
    band = slice(SIZE * SIZE // 4, SIZE * SIZE // 2)
    path_err = {}
    for h, steps in HIERARCHIES.items():
        fast = renderer.run_rays(model_at(steps), params32, rays_o[band],
                                 rays_d[band])
        slow = renderer.run_rays(model_at(steps, use_fused_mlp=False),
                                 params32, rays_o[band], rays_d[band])
        torch.cuda.synchronize()
        for k in ("image", "depth", "weights_sum"):
            d = (fast[k] - slow[k]).abs()
            over = d > PATH_TOL + PATH_TOL * slow[k].abs()
            if over.dim() > 1:
                over, d = over.any(dim=-1), d.amax(dim=-1)
            n_over, e = int(over.sum()), float(d.max())
            path_err[f"{h}/{k}"] = {"max_abs_err": e, "rays_over": n_over}
            allowed = (math.floor(DEPTH_SHARE * d.numel()) if k == "depth"
                       else 0)
            check(n_over <= allowed and (k != "depth" or e <= DEPTH_MAX),
                  f"{h}: fast path {k} off the plain path: max {e:.3g}, "
                  f"{n_over} of {d.numel()} rays past {PATH_TOL}")
        del fast, slow
        torch.cuda.empty_cache()
    log(f"fast vs plain (f32 params): {path_err}")

    def frame_ms(model, n=5):
        ts_ = []
        for _ in range(n + 1):
            torch.cuda.synchronize()
            t = time.perf_counter()
            renderer.render_frame(model, params, rays_o, rays_d,
                                  chunk=SIZE * SIZE, nets=nets)
            torch.cuda.synchronize()
            ts_.append((time.perf_counter() - t) * 1e3)
        return statistics.median(ts_[1:]), ts_[1:]

    frame_times = {h: frame_ms(m) for h, m in models.items()}

    # -- kernel times against bound and plain ----------------------------
    def cuda_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps

    def bound(name, a, k):
        """(ms, bound_by) of one launch: the larger of its byte time and its
        operation time (bound_parts)."""
        return bound_of([bound_parts(name, a, k)])

    def bound_of(parts):
        """(ms, bound_by) of launches run in series: their byte times and
        their operation times each summed, then the larger."""
        t_b, t_o = sum(p[0] for p in parts), sum(p[1] for p in parts)
        return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")

    def bound_parts(name, a, k):
        """(byte ms, operation ms): each input read once and each output
        written once over HBM, and the operations at their type's peak:
        the ray kernels' float32 ramp sums, the MLPs' bf16 tensor-core MACs
        (the float32 encode and CP taps, on other units, are left out)."""
        if name == "flatten3_nt":
            # a copy: each float read once and written once
            return 2 * a[0].numel() * 4 / HBM_BPS * 1e3, 0.0
        if name in ("ray_level0", "ray_level"):
            N = a[0].shape[0]
            T = a[1] if name == "ray_level0" else a[3]
            nbytes = N * 32 + N * (6 * T + 1) * 4
            if k.get("pack_q"):
                nbytes += N * 2 * T * 4  # the packed ts / dl rows
            ops, peak = 0.0, F32_FLOPS
            if name == "ray_level":
                T0 = a[1].shape[1]
                nbytes += N * T0 * 4
                if not k.get("uniform_prev"):
                    nbytes += N * (T0 + 1) * 4
                # (T + 1) edges x T0 ramps: sub, mul, max, min, add
                ops = 5.0 * N * (T + 1) * T0
        else:
            tm = a[1] if name == "run_tmlp" else a[3]
            P = a[0].shape[1]
            macs = sum(int(w.shape[0]) * int(w.shape[1]) for w in tm.ws)
            ops, peak = 2.0 * macs * P, BF16_FLOPS
            if name == "run_tmlp":
                nbytes = P * 12 + P * tm.kout * 4
            else:
                N = P // (a[1].shape[1] if a[1].dim() == 2 else k["T"])
                # x3, dl, ts per point; rays8 per ray; gsum, depth, wsum, rgb
                nbytes = P * 20 + N * 32 + N * (tm.kout + 5) * 4
                view = k.get("view")
                if view is not None:
                    vm = view.H * (view.geo + view.sh_dim) + sum(
                        int(w.shape[0]) * int(w.shape[1]) for w in view.rest)
                    ops += 2.0 * vm * N
            nbytes += tm.table_bytes + sum(w.numel() * w.element_size()
                                           for w in tm.ws)
        return nbytes / HBM_BPS * 1e3, ops / peak * 1e3

    timing = {n: {} for n in KERNELS}
    for (h, name), (a, k) in seen.items():
        b_ms, b_by = bound(name, a, k)
        timing[name][h] = {
            "ms": cuda_ms(lambda: kern_fn[name](*a, **k), reps=10),
            "plain_ms": cuda_ms(lambda: plain_fn[name](*a, **k), reps=2),
            "bound_ms": b_ms, "bound_by": b_by}
        torch.cuda.empty_cache()
    del seen

    rows = []
    for i, name in enumerate(KERNELS):
        serve = timing[name]["32,16"]
        rows.append({
            "name": name, "route": "cuda", "source": SOURCES[name][0],
            "replaces": SOURCES[name][1], "launches": launches[i],
            "launches_per_frame": {h: per_frame[h][i] for h in per_frame},
            "max_abs_err": max(errs[name].values()),
            "tol": RAY_TOL if name.startswith("ray") else MLP_TOL,
            "tol_kind": ("elementwise" if name.startswith("ray") else
                         f"elementwise on all but {FLIP_SHARE} of the "
                         f"outputs, those within tol * max|ref|"),
            "max_abs_err_f32_weights": (max(errs32[name].values())
                                        if errs32[name] else None),
            "outputs_past_tol": flipped[name] or None,
            "ms": serve["ms"], "plain_ms": serve["plain_ms"],
            "bound_ms": serve["bound_ms"], "bound_by": serve["bound_by"],
            "library_ms": None, "shapes_of": "32,16",
            "by_hierarchy": timing[name]})

    # -- 4. held-out PSNR on the textured fixture ---------------------------
    ds = SyntheticSphereDataset(H=128, W=128, n_views=8, radius=1.8,
                                scene="textured", training=False)
    psnr = {}
    for h, steps in HIERARCHIES.items():
        model = fields.make_model(mc, dataclasses.replace(
            rc, num_steps=steps, max_ray_batch=128 * 128))
        meter = PSNRMeter()
        for idx in range(len(ds)):
            fr = ds.frame(idx)
            out = renderer.render_staged(
                model, params, torch.as_tensor(fr["rays_o"], device=dev),
                torch.as_tensor(fr["rays_d"], device=dev),
                cam_near_far=torch.as_tensor(fr["cam_near_far"], device=dev),
                nets=nets)
            img = out["image"].float().cpu().numpy()
            check(np.isfinite(img).all() and img.shape == (128 * 128, 3),
                  f"{h}: PSNR frame {idx} not finite or misshapen")
            meter.update(img, fr["images"])
        psnr[h] = meter.measure()
    jax_psnr = {"32,16": JAX_PSNR_32_16_BF16, "128,64,32": JAX_PSNR_FULL_BF16}
    for h, ref in jax_psnr.items():
        check(abs(psnr[h] - ref) <= PSNR_TOL_DB,
              f"{h}: PSNR {psnr[h]:.3f} dB vs JAX {ref:.3f} dB")

    inter = interactive_phases(
        torch, np, dev, card, fields, renderer, rk, fm, compare, cuda_ms,
        bound, bound_parts, bound_of,
        lambda steps, **kw: model_at(steps, **kw), rays_o, rays_d, nets,
        params, to_f32)
    rows += inter.pop("rows")
    for row in rows[:len(KERNELS)]:
        row["launches_interactive_per_frame"] = {
            h: v[KERNELS.index(row["name"])]
            for h, v in inter["launches_per_frame"].items()}
    torch.cuda.empty_cache()
    hgrid = hashgrid_phases(torch, np, dev, card, cuda_ms)
    rows += hgrid.pop("rows")

    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({
        "frames": {"size": SIZE, "param_dtype": "bfloat16",
                   "frame_ms": {h: v[0] for h, v in frame_times.items()},
                   "frame_ms_runs": {h: v[1] for h, v in frame_times.items()},
                   "launches_per_frame": per_frame,
                   "fast_vs_plain_f32_max_abs_err": path_err,
                   "psnr_db": psnr,
                   "jax_psnr_db_bf16_cpu": jax_psnr,
                   "card": card}}), flush=True)
    print(json.dumps({"interactive": inter}), flush=True)
    print(json.dumps({"hashgrid": hgrid}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


def interactive_phases(torch, np, dev, card, fields, renderer, rk, fm,
                       compare, cuda_ms, bound, bound_parts, bound_of,
                       model_at, rays_o, rays_d, nets, params, to_f32):
    """Phases 5-8: the interactive frame, the render options, mask mIoU and
    frame times. -> the {"interactive": ...} record, with the kernel rows of
    flatten3_nt and the packed epilogue under "rows"."""
    import dataclasses

    from sanerf_tpu_torch.apps import frame_pipeline as fp
    from sanerf_tpu_torch.apps.interactive import InteractiveSession
    from sanerf_tpu_torch.data.synthetic import SyntheticSphereDataset
    from sanerf_tpu_torch.models.asset import load_asset, load_mask_asset
    from sanerf_tpu_torch.models.sam import predictor as sam_mod
    from sanerf_tpu_torch.train.metrics import MeanIoUMeter

    asset = os.path.join(ROOT, "assets", "serving_student")
    pose = np.asarray(SERVE_POSE, np.float32)
    counters = [rk.ray_level0, rk.ray_level, fm.run_tmlp,
                fm.run_tmlp_composite, rk.flatten3_nt]
    packed_counters = [rk.ray_level0, rk.ray_level, fm.run_tmlp_composite]

    def zero():
        for c in counters:
            c.launches = 0
        for c in packed_counters:
            c.packed_launches = 0

    # -- 5. the interactive frame ------------------------------------------
    mcs, rcs, ps32 = load_asset(asset, device=dev, with_sam=True, seed=0)
    ps = fields.cast_params(ps32, torch.bfloat16)
    sam_cfg = sam_mod.SamConfig()
    sam_params = fields.cast_params(sam_mod.init_params(
        sam_cfg, torch.Generator().manual_seed(1), dev))

    def session(steps, **rc_kw):
        model = fields.make_model(mcs, dataclasses.replace(
            rcs, num_steps=steps, max_ray_batch=SIZE * SIZE, **rc_kw))
        return InteractiveSession(
            None, model, ps, sam_mod.SamPredictor(sam_cfg, sam_params,
                                                  device=dev),
            H=SIZE, W=SIZE, device=dev)

    def warm(s):
        """bench.py:_drive: a frame, one point at the origin, a frame."""
        s.step(pose)
        if not s.points_3d:
            s.points_3d.append(np.zeros(3, np.float32))
        s.step(pose)

    def counted_frame(s):
        """One sync frame with the counters set to 0 just before; -> (the
        frame, launches per counter, packed launches, samvit, mask
        logits)."""
        got = {}
        dfused, dec = fp.decode_fused, sam_mod.decode

        def spy_fused(cfg, p, feats, *a, **k):
            got.setdefault("samvit", feats)
            return dfused(cfg, p, feats, *a, **k)

        def spy_dec(*a, **k):
            out = dec(*a, **k)
            got.setdefault("logits", out[0])
            return out

        fp.decode_fused, sam_mod.decode = spy_fused, spy_dec
        try:
            torch.cuda.synchronize()
            zero()
            r = s.step(pose, pipelined=False)
            torch.cuda.synchronize()
        finally:
            fp.decode_fused, sam_mod.decode = dfused, dec
        return (r, [c.launches for c in counters],
                [c.packed_launches for c in packed_counters],
                got.get("samvit"), got.get("logits"))

    sessions = {h: session(st) for h, st in HIERARCHIES.items()}
    per_frame, frames = {}, {}
    for h, s in sessions.items():
        warm(s)
        r, n, _, samvit, logits = counted_frame(s)
        per_frame[h], frames[h] = n, r
        check(n == INTERACTIVE_LAUNCHES[h],
              f"{h}: interactive frame launches {n}, expected "
              f"{INTERACTIVE_LAUNCHES[h]} (ray_level0, ray_level, run_tmlp, "
              f"run_tmlp_composite, flatten3_nt)")
        check(r.rgb_u8.shape == (SIZE, SIZE, 3), f"{h}: frame shape")
        check(bool(torch.isfinite(r.depth).all()), f"{h}: depth not finite")
        check(samvit is not None
              and tuple(samvit.shape) == (s.h, s.w, mcs.sam_feat_dim),
              f"{h}: samvit {None if samvit is None else samvit.shape}")
        check(bool(torch.isfinite(samvit).all()), f"{h}: samvit not finite")
        check(logits is not None and bool(torch.isfinite(logits).all()),
              f"{h}: mask logits not finite")
        check(r.mask is not None and tuple(r.mask.shape) == (SIZE, SIZE),
              f"{h}: mask missing or misshapen")
        check(len(s.points_3d) == 1, f"{h}: the click memory")
    log(f"interactive launches per frame {per_frame}")

    # -- 6. the render options -----------------------------------------------
    seen = {}

    def spy(mod, name, fn, key, when):
        def wrapped(*a, **k):
            if when(a, k):
                seen.setdefault(key, (a, k))
            return fn(*a, **k)
        setattr(mod, name, wrapped)

    flat_launches = {}
    for h, st in HIERARCHIES.items():
        s = session(st, flatten_kernel=True)
        warm(s)
        spy(renderer, "flatten3_nt", rk.flatten3_nt, (h, "flatten3_nt"),
            lambda a, k: True)
        try:
            r, n, _, _, _ = counted_frame(s)
        finally:
            renderer.flatten3_nt = rk.flatten3_nt
        flat_launches[h] = n[4]
        check(n[4] == FLATTEN_LAUNCHES[h],
              f"{h}: flatten3_nt launches {n[4]}, expected "
              f"{FLATTEN_LAUNCHES[h]}")
        check(np.array_equal(r.rgb_u8, frames[h].rgb_u8)
              and torch.equal(r.depth, frames[h].depth),
              f"{h}: the flatten_kernel frame differs from the default")
        del s
    packed_launches, packed_err = {}, {}
    for h, st in HIERARCHIES.items():
        ref = renderer.render_frame(model_at(st), params, rays_o, rays_d,
                                    chunk=SIZE * SIZE, nets=nets)
        spy(renderer, "ray_level", rk.ray_level, (h, "packed/ray_level"),
            lambda a, k: k.get("pack_q", 0) > 0)
        spy(fields, "run_tmlp_composite", fm.run_tmlp_composite,
            (h, "packed/run_tmlp_composite"),
            lambda a, k: k.get("pack_q", 1) > 1)
        try:
            torch.cuda.synchronize()
            zero()
            got = renderer.render_frame(
                model_at(st, packed_epilogue=True), params, rays_o, rays_d,
                chunk=SIZE * SIZE, nets=nets)
            torch.cuda.synchronize()
            packed_launches[h] = [c.packed_launches for c in packed_counters]
        finally:
            renderer.ray_level = rk.ray_level
            fields.run_tmlp_composite = fm.run_tmlp_composite
        check(packed_launches[h] == [0, 1, 1],
              f"{h}: packed launches {packed_launches[h]} (ray_level0, "
              f"ray_level, run_tmlp_composite), expected [0, 1, 1]")
        packed_err[h] = {}
        for k in ("image", "depth", "weights_sum"):
            d = (got[k] - ref[k]).abs()
            packed_err[h][k] = float(d.max())
            check(bool((d <= PACKED_TOL + PACKED_TOL * ref[k].abs()).all()),
                  f"{h}: packed epilogue {k} off the default by "
                  f"{float(d.max()):.3g}")
        del got, ref
    log(f"flatten launches {flat_launches}, packed launches "
        f"{packed_launches}, packed vs default {packed_err}")

    # kernels against their plain versions at those frames' shapes ...
    errs = {"flatten3_nt": 0.0, "packed_epilogue": 0.0}
    for (h, key), (a, k) in seen.items():
        name = key.split("/")[-1]
        if name == "flatten3_nt":
            errs[name] = max(errs[name],
                             compare(name, a, k, 0.0, flips=False)[0])
            continue
        tol = RAY_TOL if name == "ray_level" else MLP_TOL
        e, _ = compare(name, a, k, tol, flips=name != "ray_level")
        errs["packed_epilogue"] = max(errs["packed_epilogue"], e)
        if name == "ray_level":
            out = rk.ray_level(*a, **k)
            torch.cuda.synchronize()
            check(torch.equal(out[4].reshape(out[1].shape), out[1])
                  and torch.equal(out[5].reshape(out[2].shape), out[2]),
                  f"{h}: packed ts/dl rows are not the flat ts/dl")
            del out
        else:
            compare(name, *to_f32(a, k), MLP_F32_TOL[name], flips=False)
    # ... and at ragged ones (N = 1000: not a multiple of the warps' rays)
    g = torch.Generator(device=dev).manual_seed(7)
    r8 = seen[("32,16", "packed/ray_level")][0][0][:1000].contiguous()
    for N_, T_ in ((997, 7), (1000, 16)):
        x3 = torch.randn(3, N_, T_, generator=g, device=dev)
        compare("flatten3_nt", (x3,), {}, 0.0, flips=False)
    w0 = torch.rand(1000, 32, generator=g, device=dev)
    b0 = rk.ray_level0(r8, 32, True)[0]
    for q in (8, 4):
        e0, _ = compare("ray_level0", (r8, 16, True), {"pack_q": q}, RAY_TOL,
                        flips=False)
        e1, _ = compare("ray_level", (r8, w0, b0, 16, True), {"pack_q": q},
                        RAY_TOL, flips=False)
        o0 = rk.ray_level0(r8, 16, True, pack_q=q)
        check(torch.equal(o0[4].reshape(1000, 16), o0[1])
              and torch.equal(o0[5].reshape(1000, 16), o0[2]),
              "ragged: packed ray_level0 rows are not the flat ts/dl")
        T_ = 128 // q
        xT = torch.rand(3, 1000 * T_, generator=g, device=dev) * 4 - 2
        dl = torch.rand(1000, T_, generator=g, device=dev) * 0.1
        ts = torch.cumsum(dl, 1) + 0.5
        pk = lambda v: v.reshape(1000 // q, q * T_, 1)  # noqa: E731
        kw = {"opaque": True, "view": nets.view, "rays8": r8, "pack_q": q,
              "T": T_}
        e2, _ = compare("run_tmlp_composite", (xT, pk(dl), pk(ts),
                                               nets.field), kw, MLP_TOL,
                        flips=True)
        flat = fm.run_tmlp_composite(xT, dl, ts, nets.field, opaque=True,
                                     view=nets.view, rays8=r8)
        pkd = fm.run_tmlp_composite(xT, pk(dl), pk(ts), nets.field, **kw)
        torch.cuda.synchronize()
        for x, y in zip(pkd, flat):
            check(bool(((x - y).abs() <= PACKED_TOL
                        + PACKED_TOL * y.abs()).all()),
                  "ragged: packed composite off the unpacked one")
        errs["packed_epilogue"] = max(errs["packed_epilogue"], e0, e1, e2)
        del o0, flat, pkd
    log(f"flatten / packed kernels vs plain: {errs}")

    # -- 7. mask mIoU ----------------------------------------------------------
    mcm, rcm, pm32 = load_mask_asset(asset, device=dev)
    pm = fields.cast_params(pm32, torch.bfloat16)
    mmodel = fields.make_model(mcm, dataclasses.replace(
        rcm, num_steps=(32, 16), max_ray_batch=128 * 128))
    check(renderer.uses_kernels(mmodel), "mIoU: the fast path is off")
    ds = SyntheticSphereDataset(H=128, W=128, n_views=8, radius=1.8,
                                scene="textured", training=False)
    meter = MeanIoUMeter()
    for idx in range(len(ds)):
        fr = ds.frame(idx)
        out = renderer.render_staged(
            mmodel, pm, torch.as_tensor(fr["rays_o"], device=dev),
            torch.as_tensor(fr["rays_d"], device=dev), return_mask=True,
            cam_near_far=torch.as_tensor(fr["cam_near_far"], device=dev))
        logits = out["instance_mask_logits"]
        check(bool(torch.isfinite(logits).all()), f"mIoU frame {idx}")
        meter.update(logits.argmax(-1).cpu().numpy(), fr["masks"])
    miou = meter.measure()
    check(abs(miou - JAX_MIOU_32_16_BF16) <= MIOU_TOL,
          f"mask mIoU {miou:.4f} vs JAX {JAX_MIOU_32_16_BF16:.4f}")
    log(f"mask mIoU {miou}")

    # -- 8. frame times (bench.py:_drive) --------------------------------------
    def drive(s, n, sync):
        ts_ = []
        for _ in range(n):
            t = time.perf_counter()
            s.step(pose, pipelined=not sync)
            ts_.append((time.perf_counter() - t) * 1e3)
        return statistics.median(ts_), ts_

    times = {}
    for h, s in sessions.items():
        drive(s, 3, False)  # refill the pipeline
        pipelined = drive(s, 7, False)
        sync = drive(s, 5, True)
        times[h] = {"pipelined_ms": pipelined[0], "sync_ms": sync[0],
                    "pipelined_runs": pipelined[1], "sync_runs": sync[1]}
    log(f"interactive frame times {times}")

    # -- kernel rows of this slice -------------------------------------------
    a, k = seen[("32,16", "flatten3_nt")]
    x3 = a[0]
    fl_b = bound("flatten3_nt", a, k)
    rows = [{
        "name": "flatten3_nt", "route": "cuda",
        "source": SOURCES["flatten3_nt"][0],
        "replaces": SOURCES["flatten3_nt"][1],
        "launches": sum(flat_launches.values()),
        "launches_per_frame": flat_launches,
        "max_abs_err": errs["flatten3_nt"], "tol": 0.0,
        "tol_kind": "bit for bit",
        "ms": cuda_ms(lambda: rk.flatten3_nt(x3), reps=20),
        "plain_ms": cuda_ms(lambda: rk.flatten3_nt_plain(x3), reps=20),
        "bound_ms": fl_b[0], "bound_by": fl_b[1],
        "library_ms": cuda_ms(lambda: x3.reshape(3, -1).clone(), reps=20),
        "shapes_of": "32,16 interactive frame, first launch",
        "shape": list(x3.shape)}]
    pk_ms = pk_plain = 0.0
    pk_parts = []
    for key, name, fn, plain in (
            ("packed/ray_level", "ray_level", rk.ray_level,
             rk.ray_level_plain),
            ("packed/run_tmlp_composite", "run_tmlp_composite",
             fm.run_tmlp_composite, fm.run_tmlp_composite_plain)):
        a, k = seen[("32,16", key)]
        pk_ms += cuda_ms(lambda: fn(*a, **k), reps=10)
        pk_plain += cuda_ms(lambda: plain(*a, **k), reps=2)
        pk_parts.append(bound_parts(name, a, k))
        torch.cuda.empty_cache()
    rows.append({
        "name": "packed_epilogue", "route": "cuda",
        "source": SOURCES["packed_epilogue"][0],
        "also_source": "sanerf_tpu_torch/csrc/ray_kernels.cu",
        "replaces": SOURCES["packed_epilogue"][1],
        "also_replaces": "sanerf_tpu/ops/ray_kernels.py:131",
        "launches": sum(sum(v) for v in packed_launches.values()),
        "launches_per_frame": packed_launches,
        "launches_of": "ray_level0, ray_level, run_tmlp_composite with "
                       "pack_q",
        "max_abs_err": errs["packed_epilogue"], "tol": MLP_TOL,
        "tol_kind": "as ray_level (1e-5) and run_tmlp_composite (bf16); "
                    f"frame within {PACKED_TOL} of the default",
        "ms": pk_ms, "plain_ms": pk_plain,
        "bound_ms": bound_of(pk_parts)[0], "bound_by": bound_of(pk_parts)[1],
        "library_ms": None,
        "shapes_of": "32,16 RGB frame: packed ray_level + packed composite",
        "frame_max_abs_err_vs_default": packed_err})
    return {"size": SIZE, "param_dtype": "bfloat16",
            "sam": "SamConfig() decoder, seeded random bf16 weights",
            "frame_ms": times, "launches_per_frame": per_frame,
            "flatten_launches_per_frame": flat_launches,
            "packed_launches_per_frame": packed_launches,
            "packed_vs_default_max_abs_err": packed_err,
            "mask_miou": miou, "jax_mask_miou_bf16_cpu": JAX_MIOU_32_16_BF16,
            "card": card, "rows": rows}


def hashgrid_phases(torch, np, dev, card, cuda_ms):
    """Phases 9-13: the gather kernel at the probe shapes, and the
    hash-grid family's interactive frame, path check, JAX reference and
    mask frame. -> the {"hashgrid": ...} record, with the gather's kernel
    rows under "rows"."""
    import dataclasses

    from sanerf_tpu_torch.apps import frame_pipeline as fp
    from sanerf_tpu_torch.apps.interactive import InteractiveSession
    from sanerf_tpu_torch.config import ModelConfig, RenderConfig
    from sanerf_tpu_torch.models import fields, renderer
    from sanerf_tpu_torch.models.asset import expected_shapes, params_from_jax
    from sanerf_tpu_torch.models.sam import predictor as sam_mod
    from sanerf_tpu_torch.ops import gather as ga
    from sanerf_tpu_torch.ops import hashgrid as hg

    sys.path.insert(0, os.path.join(ROOT, "port_tools"))
    import hashgrid_params as hp

    def bits(t):
        return t.view(torch.int16 if t.dtype == torch.bfloat16
                      else torch.int32)

    def same_bits(a, b):
        return a.shape == b.shape and a.dtype == b.dtype \
            and torch.equal(bits(a), bits(b))

    gather_err = [0.0]  # the largest kernel-vs-plain difference seen

    def held(got, ref):
        """Bit equality of kernel and plain outputs; records their
        largest absolute difference."""
        if got.shape == ref.shape:
            gather_err[0] = max(gather_err[0], float(
                (got.float() - ref.float()).abs().max()) if got.numel()
                else 0.0)
        return same_bits(got, ref)

    def gather_bytes(table, idx, block_rows):
        """idx read once, the table read once, each output row written
        once."""
        row = block_rows * table.shape[1] * table.element_size()
        return (idx.numel() * 4 + table.numel() * table.element_size()
                + idx.numel() * row)

    # -- 9. the probe shapes --------------------------------------------------
    g = torch.Generator(device=dev).manual_seed(0)
    idx = torch.randint(0, PROBE_ROWS, (PROBE_IDX,), generator=g, device=dev,
                        dtype=torch.int32)
    base = {C: torch.randn(PROBE_ROWS, C, generator=g, device=dev)
            for C in (2, 128)}
    probe_idx = {
        "blocks": idx.reshape(64, PROBE_IDX // 64),
        "flat": idx,
        "mod4096": (idx % 4096).reshape(64, PROBE_IDX // 64),
        "div8": (idx[:PROBE_IDX // 8] // 8).contiguous(),
    }
    probes = {}
    for name, line, C, rows_used, form, br in PROBES:
        i = probe_idx[form]
        rec = {"replaces": f"tools/probe_gather.py:{line}",
               "shape": {"table": [rows_used or PROBE_ROWS, C],
                         "idx": list(i.shape), "block_rows": br}}
        for dt in (torch.float32, torch.bfloat16):
            t = base[C].to(dt)
            if rows_used:
                t = t[:rows_used]
            got = ga.gather_rows(t, i, br)
            ref = ga.gather_rows_plain(t, i, br)
            torch.cuda.synchronize()
            check(held(got, ref),
                  f"gather {name} {dt}: kernel differs from its plain version")
            del got, ref
            tv = t.reshape(t.shape[0] // br, br * C)
            flat_i = i.reshape(-1)
            key = "f32" if dt == torch.float32 else "bf16"
            rec[key] = {
                "ms": cuda_ms(lambda: ga.gather_rows(t, i, br), reps=20),
                "plain_ms": cuda_ms(lambda: ga.gather_rows_plain(t, i, br),
                                    reps=5),
                "library_ms": cuda_ms(
                    lambda: torch.index_select(tv, 0, flat_i), reps=20),
                "bound_ms": gather_bytes(t, i, br) / HBM_BPS * 1e3}
            torch.cuda.empty_cache()
        probes[name] = rec
    # p2_take's fill: indices outside the table give rows of zeros
    fill = idx.clone()
    fill[::16] = -1
    fill[8::16] = PROBE_ROWS + 5
    for dt in (torch.float32, torch.bfloat16):
        t = base[2].to(dt)
        got = ga.gather_rows(t, fill)
        torch.cuda.synchronize()
        check(held(got, ga.gather_rows_plain(t, fill))
              and not got[::8].any(),
              f"gather fill {dt}: out-of-range rows are not zeros")
    del base, probe_idx, idx, fill, got
    torch.cuda.empty_cache()
    log(f"gather probes: {probes}")

    # -- 10. the hash-grid interactive frame -----------------------------------
    mc = ModelConfig(field_type="hashgrid", with_sam=True)
    model = fields.make_model(mc, RenderConfig())
    gen = torch.Generator().manual_seed(0)
    p32 = fields.init_params(model, gen, dev)
    # tables redrawn so that densities and features vary across the frame
    p32["grid"] = hg.init_params(gen, model.grid_spec, hp.TABLE_STD, dev)
    p32["s_grid"] = hg.init_params(gen, model.s_grid_spec, hp.TABLE_STD, dev)
    for p, spec in zip(p32["prop"], model.prop_specs):
        p["grid"] = hg.init_params(gen, spec, hp.TABLE_STD, dev)
    params = fields.cast_params(p32, torch.bfloat16)
    check(not renderer.uses_kernels(model), "hash-grid: took the MLP path")
    sam_cfg = sam_mod.SamConfig()
    sam_params = fields.cast_params(sam_mod.init_params(
        sam_cfg, torch.Generator().manual_seed(1), dev))
    sess = InteractiveSession(None, model, params,
                              sam_mod.SamPredictor(sam_cfg, sam_params,
                                                   device=dev),
                              H=SIZE, W=SIZE, device=dev)
    pose = np.asarray(SERVE_POSE, np.float32)
    sess.step(pose)
    sess.points_3d.append(np.zeros(3, np.float32))
    sess.step(pose)
    check(sess._pipe(SIZE, SIZE)._kernel_nets() is None,
          "hash-grid: the frame packed MLP kernel weights")

    calls, got = [], {}
    real_gather = hg.gather_rows
    dfused, dec = fp.decode_fused, sam_mod.decode

    def spy_gather(table, i, block_rows=1):
        calls.append((table, i))
        return real_gather(table, i, block_rows)

    def spy_fused(cfg, p, feats, *a, **k):
        got.setdefault("samvit", feats)
        return dfused(cfg, p, feats, *a, **k)

    def spy_dec(*a, **k):
        out = dec(*a, **k)
        got.setdefault("logits", out[0])
        return out

    hg.gather_rows, fp.decode_fused, sam_mod.decode = (spy_gather, spy_fused,
                                                       spy_dec)
    try:
        torch.cuda.synchronize()
        ga.gather_rows.launches = 0
        r = sess.step(pose, pipelined=False)
        torch.cuda.synchronize()
        launches = ga.gather_rows.launches
    finally:
        hg.gather_rows, fp.decode_fused, sam_mod.decode = (real_gather,
                                                           dfused, dec)
    check(launches == HASHGRID_LAUNCHES,
          f"hash-grid frame: {launches} gathers, expected {HASHGRID_LAUNCHES}")
    check(r.rgb_u8.shape == (SIZE, SIZE, 3), "hash-grid frame shape")
    check(bool(torch.isfinite(r.depth).all()), "hash-grid depth not finite")
    sv = got.get("samvit")
    check(sv is not None and tuple(sv.shape) == (sess.h, sess.w,
                                                 mc.sam_feat_dim)
          and bool(torch.isfinite(sv).all()), "hash-grid samvit")
    check(got.get("logits") is not None
          and bool(torch.isfinite(got["logits"]).all()),
          "hash-grid mask logits not finite")
    check(r.mask is not None and tuple(r.mask.shape) == (SIZE, SIZE),
          "hash-grid mask missing")
    # every gather of that frame against its plain version, and its times
    fr = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    shapes = {}
    for table, i in calls:
        ref = ga.gather_rows_plain(table, i)
        check(held(real_gather(table, i), ref),
              f"hash-grid gather {tuple(i.shape)}: kernel differs")
        del ref
        flat_i = i.reshape(-1)
        fr["ms"] += cuda_ms(lambda: real_gather(table, i), reps=3)
        fr["plain_ms"] += cuda_ms(lambda: ga.gather_rows_plain(table, i),
                                  reps=1)
        fr["library_ms"] += cuda_ms(
            lambda: torch.index_select(table, 0, flat_i), reps=3)
        fr["bound_ms"] += gather_bytes(table, i, 1) / HBM_BPS * 1e3
        k = f"{list(i.shape)} x {table.shape[1]} {str(table.dtype)[6:]}"
        shapes[k] = shapes.get(k, 0) + 1
        torch.cuda.empty_cache()
    del calls, r
    torch.cuda.empty_cache()
    log(f"hash-grid frame gathers: {launches} launches, {fr}, {shapes}")

    def drive(n, sync):
        ts_ = []
        for _ in range(n):
            t = time.perf_counter()
            sess.step(pose, pipelined=not sync)
            ts_.append((time.perf_counter() - t) * 1e3)
        return statistics.median(ts_), ts_

    drive(2, False)
    pipelined = drive(5, False)
    sync = drive(3, True)
    sess.step(pose, pipelined=False)
    rays_o, rays_d = (torch.from_numpy(a).to(dev)
                      for a in hp.frame_rays(SIZE))
    ts_ = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        renderer.run_rays(model, params, rays_o, rays_d)
        torch.cuda.synchronize()
        ts_.append((time.perf_counter() - t) * 1e3)
    times = {"pipelined_ms": pipelined[0], "sync_ms": sync[0],
             "pipelined_runs": pipelined[1], "sync_runs": sync[1],
             "rgb_render_ms": statistics.median(ts_), "rgb_render_runs": ts_}
    del sess
    torch.cuda.empty_cache()
    log(f"hash-grid frame times {times}")

    # -- 11. the kernel frame against the plain-gather frame --------------------
    kern = renderer.run_rays(model, p32, rays_o, rays_d)
    hg.gather_rows = ga.gather_rows_plain
    try:
        plain = renderer.run_rays(model, p32, rays_o, rays_d)
    finally:
        hg.gather_rows = real_gather
    torch.cuda.synchronize()
    for k in ("image", "depth", "weights_sum"):
        check(torch.equal(kern[k], plain[k]),
              f"hash-grid {k}: the kernel frame differs from the plain-gather "
              f"frame by {float((kern[k] - plain[k]).abs().max()):.3g}")
    depth_std = float(kern["depth"].std())
    del kern, plain
    torch.cuda.empty_cache()

    # -- 12. against the JAX package ----------------------------------------------
    ref = JAX_HASHGRID
    pj = params_from_jax(hp.make_flat(expected_shapes(model), 0), model, dev)
    o64, d64 = (torch.from_numpy(a).to(dev) for a in hp.frame_rays(64))
    out = renderer.run_rays(model, pj, o64, d64, return_feats=True)
    px = torch.tensor(ref["pixels"], device=dev)
    vals = {"mean": {k: float(out[k].double().mean()) for k in ref["mean"]},
            "image": out["image"][px], "depth": out["depth"][px],
            "weights_sum": out["weights_sum"][px],
            "samvit": out["samvit"][px][:, ref["channels"]]}
    jax_err = {}
    for k, v in vals.items():
        if k == "mean":
            got_v = np.asarray([v[m] for m in ref["mean"]])
            want = np.asarray([ref["mean"][m] for m in ref["mean"]])
        else:
            got_v, want = v.double().cpu().numpy(), np.asarray(ref[k])
        d = np.abs(got_v - want)
        jax_err[k] = float(d.max())
        check(bool((d <= JAX_HASHGRID_TOL + JAX_HASHGRID_TOL
                    * np.abs(want)).all()),
              f"hash-grid {k} off the JAX values: max {d.max():.3g}")
    del out, pj
    log(f"hash-grid vs JAX: {jax_err}")

    # -- 13. the mask frame ----------------------------------------------------------
    mmodel = fields.make_model(dataclasses.replace(mc, with_mask=True),
                               RenderConfig())
    mgen = torch.Generator().manual_seed(2)
    pm = dict(params)
    pm["m_grid"] = hg.init_params(mgen, mmodel.m_grid_spec, hp.TABLE_STD,
                                  dev).to(torch.bfloat16)
    pm["mask_mlp"] = fields.cast_params(fields.init_mlp(
        mgen, *fields.mask_mlp_dims(mmodel), 3, False, (), dev))
    torch.cuda.synchronize()
    ga.gather_rows.launches = 0
    mout = renderer.run_rays(mmodel, pm, rays_o, rays_d, return_mask=True)
    torch.cuda.synchronize()
    mask_launches = ga.gather_rows.launches
    logits = mout["instance_mask_logits"]
    check(mask_launches == MASK_LAUNCHES,
          f"mask frame: {mask_launches} gathers, expected {MASK_LAUNCHES}")
    check(tuple(logits.shape) == (SIZE * SIZE, mmodel.mask_out_dim())
          and bool(torch.isfinite(logits).all()), "mask frame logits")
    del mout, logits, pm
    torch.cuda.empty_cache()

    common = {"route": "cuda", "source": "sanerf_tpu_torch/csrc/gather.cu",
              "launches": launches,
              "launches_of": "gather_rows in one 512^2 hash-grid interactive "
                             "frame (the same kernel serves every row)",
              "max_abs_err": gather_err[0], "tol": 0.0,
              "tol_kind": "bit for bit",
              "bound_by": "bytes"}
    rows = [{"name": f"gather_rows[{name}]", **common,
             "replaces": rec["replaces"], "ms": rec["f32"]["ms"],
             "plain_ms": rec["f32"]["plain_ms"],
             "bound_ms": rec["f32"]["bound_ms"],
             "library_ms": rec["f32"]["library_ms"],
             "library": "torch.index_select", "dtype": "float32",
             "bf16": rec["bf16"], "shape": rec["shape"]}
            for name, rec in probes.items()]
    rows.append({
        "name": "gather_rows[hashgrid frame]", **common,
        "replaces": "tools/probe_gather.py:90",
        "also_replaces": "sanerf_tpu/ops/hashgrid.py:229 (jnp.take)",
        "ms": fr["ms"], "plain_ms": fr["plain_ms"],
        "bound_ms": fr["bound_ms"], "library_ms": fr["library_ms"],
        "library": "torch.index_select", "dtype": "bfloat16",
        "sum_of": f"{launches} launches of one frame", "shapes": shapes})
    return {"size": SIZE, "param_dtype": "bfloat16",
            "model": "ModelConfig(field_type='hashgrid', with_sam=True), "
                     "RenderConfig() (128, 64, 32)",
            "table_std": hp.TABLE_STD, "launches_per_frame": launches,
            "mask_frame_launches": mask_launches, "frame_ms": times,
            "gathers_per_frame": fr, "depth_std_f32": depth_std,
            "vs_jax_max_abs_err": jax_err, "jax_tol": JAX_HASHGRID_TOL,
            "probes": probes, "card": card, "rows": rows}


if __name__ == "__main__":
    main()
