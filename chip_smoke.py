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
  9. one {"kernels": [...]} line, one {"frames": ...} line, one
     {"interactive": ...} line, and last {"ok": true, "device": {...}}.
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


if __name__ == "__main__":
    main()
