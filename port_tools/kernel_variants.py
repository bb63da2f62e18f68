"""Times the field kernels built from a variant of csrc/fused_mlp_t.cu.

    python3 port_tools/kernel_variants.py VARIANTS NAME [PARTS]
    (needs a CUDA card)

VARIANTS is a JSON object {name: [[old, new], ...]} of text substitutions
in csrc/fused_mlp_t.cu, or {name: "path/to/fused_mlp_t.cu"} for a whole
source, or {name: "path/to/tree"} for the port of another commit unpacked
there (`git archive COMMIT sanerf_tpu_torch | tar -x -C path/to/tree`):
its csrc/fused_mlp_t.cu with its TransposedFieldMLP.packed and its
launch arguments (the weight layout and the C interface move with the
kernel); or the path of a Python file that
defines such a dict as VARIANTS (port_tools/field_f32_variants.py); NAME
picks one, or is "orig" for the source as it is. A name starting with "fmad" also drops -fmad=false from
the build. A variant builds into build/variants/<name>/; compare variants
within one run on one card, one process each. PARTS, a comma-separated
subset of serve, asset32, t2 (default serve,t2). Prints the ptxas
register and spill lines, then one JSON line:
  serve: bf16, the composite's shapes of the (32, 16) frame
    (`kernel_breakdown.variants`): the time of each case (CUDA events,
    mean of 20 launches, two rounds), a digest of each case's outputs
    (equal digests: bit for bit equal) and the largest kernel-vs-plain
    difference of run_tmlp on 200,003 random points (and the count past
    0.05);
  asset32: float32, the same as t2 for the field launches of the 512^2
    (32, 16) frame of the asset with its float32 weights (chip_smoke's
    phase 2 holds their twins);
  t2: float32, the launches of chip_smoke's T2 evaluation frame: the
    default ModelConfig() and RenderConfig() (field w128 d8 with its skip
    and view head, proposal nets w64 d4) with seeded float32 weights, the
    64^2 frame of the textured fixture (4,096 rays at (128, 64, 32)):
    run_tmlp on 524,288 and 262,144 points, run_tmlp_composite on 4,096
    rays of 32. Each launch: the kernel's and the plain version's median /
    10th / 90th percentile ms of T2_REPS interleaved launches queued
    behind a backlog, its bounds (chip_smoke.field_op_ms), and against the
    plain version the largest |d|, the largest |d| / (1 + |ref|) (the
    F32_FAITHFUL hold passes at 1e-5 and below) and the outputs past
    F32_FAITHFUL and past MLP_F32_TOL; against the float64 plain version
    (chip_smoke.plain_f64) the largest |d| / (1 + |r64|) of the kernel and
    of the plain version (cuBLAS float32), and whether the kernel's is
    within chip_smoke's F32_F64_MULT times the plain version's + F32_ULP.
"""

import hashlib
import json
import os
import shutil
import sys
import time
from pathlib import Path

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "port_tools"))

import chip_smoke as cs  # noqa: E402
import kernel_breakdown as kb  # noqa: E402
from sanerf_tpu_torch.ops import _build  # noqa: E402
from sanerf_tpu_torch.ops import fused_mlp_t as fm  # noqa: E402

T2_REPS = 21


def load_variants(arg):
    """VARIANTS from inline JSON or from a Python file's VARIANTS."""
    if not arg.endswith(".py"):
        return json.loads(arg)
    import importlib.util

    spec = importlib.util.spec_from_file_location("variants", arg)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.VARIANTS


def use_tree(tree):
    """Builds the kernels from `tree`'s csrc and packs the weights as its
    ops/fused_mlp_t.py does."""
    import importlib.util

    src = Path(ROOT) / tree / "sanerf_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        "tree_fused_mlp_t", src / "ops" / "fused_mlp_t.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    fm.TransposedFieldMLP.packed = mod.TransposedFieldMLP.packed
    # and calls its kernels with its own arguments (the C interface moves
    # with the kernels)
    fm._lib, fm._net_args = mod._lib, mod._net_args
    _build.CSRC = src / "csrc"
    _build.BUILD_DIR = Path(ROOT) / "build" / "variants" / tree.replace(
        "/", "_") / "kernels"


def use_variant(name, sources):
    """Points the build at build/variants/<name>/csrc, a copy of csrc with
    `sources` applied: {file in csrc: [[old, new], ...] text substitutions,
    or the path of a whole file to put in its place}. No sources: csrc as
    it is."""
    if not sources:
        return
    d = Path(ROOT) / "build" / "variants" / name
    src = d / "csrc"
    shutil.copytree(_build.CSRC, src, dirs_exist_ok=True)
    for fname, spec in sources.items():
        p = src / fname
        if isinstance(spec, str):
            shutil.copy(os.path.join(ROOT, spec), p)
            continue
        text = p.read_text()
        for old, new in spec:
            if old not in text:
                sys.exit(f"variants: {name}: {old!r} not in {fname}")
            text = text.replace(old, new)
        p.write_text(text)
    _build.CSRC = src
    _build.BUILD_DIR = d / "kernels"


def digest(out):
    """sha256 of a kernel's outputs' bytes: equal digests of two variants
    in one run are outputs bit for bit equal."""
    h = hashlib.sha256()
    for t in out if isinstance(out, tuple) else (out,):
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def serve_part(dev):
    _, _, nets, fns = kb.variants(dev)
    ms = {}
    for _ in range(2):
        for k, fn in fns.items():
            ms.setdefault(k, []).append(kb.cuda_ms(fn, reps=20))
    digests = {k: digest(fn()) for k, fn in fns.items()}
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.rand(3, 200003, generator=g, device=dev) * 4 - 2
    err = {}
    for k, tm in (("field", nets.field), ("prop", nets.props[0])):
        d = (fm.run_tmlp(x, tm, True) - fm.run_tmlp_plain(x, tm)).abs()
        err[k] = [float(d.max()), int((d > 0.05).sum())]
    return {"ms": ms, "max_abs_err": err, "digest": digests}


def field_launches(render):
    """[(name, args, kwargs)] of the field-kernel launches of render(), as
    the renderer makes them."""
    from sanerf_tpu_torch.models import fields, renderer
    from sanerf_tpu_torch.ops import ray_kernels as rk

    kern_fn = {"ray_level0": rk.ray_level0, "ray_level": rk.ray_level,
               "run_tmlp": fm.run_tmlp,
               "run_tmlp_composite": fm.run_tmlp_composite}
    calls = {}
    with cs.spying(renderer, fields, kern_fn, calls, None), torch.no_grad():
        render(renderer)
    torch.cuda.synchronize()
    return [(name, a, k) for (_, name), ls in sorted(calls.items())
            if name.startswith("run_tmlp") for a, k in ls]


def t2_launches(dev):
    """T2's float32 evaluation frame: the default model, seeded weights."""
    from sanerf_tpu_torch.config import ModelConfig, RenderConfig
    from sanerf_tpu_torch.data.synthetic import SyntheticSphereDataset
    from sanerf_tpu_torch.models import fields

    model = fields.make_model(ModelConfig(), RenderConfig())
    params = fields.init_params(model, torch.Generator().manual_seed(0), dev)
    fr = SyntheticSphereDataset(H=cs.EVAL_SIZE, W=cs.EVAL_SIZE, n_views=2,
                                scene="textured", training=False).frame(0)
    return field_launches(lambda r: r.render_staged(
        model, params, *(torch.as_tensor(fr[k], device=dev)
                         for k in ("rays_o", "rays_d")),
        cam_near_far=torch.as_tensor(fr["cam_near_far"], device=dev)))


def asset32_launches(dev):
    """The 512^2 (32, 16) RGB frame of assets/serving_student with its
    float32 weights (the serving bf16 weights' twins, chip_smoke's phase
    2)."""
    import dataclasses

    from sanerf_tpu_torch.data.rays import full_frame_rays
    from sanerf_tpu_torch.models import fields
    from sanerf_tpu_torch.models.asset import load_asset
    from sanerf_tpu_torch.utils.camera import fov_to_focal

    mc, rc, p32 = load_asset(os.path.join(ROOT, "assets", "serving_student"),
                             device=dev)
    size = cs.SIZE
    model = fields.make_model(mc, dataclasses.replace(
        rc, num_steps=(32, 16), max_ray_batch=size * size))
    focal = fov_to_focal(60.0, size)
    o, d = full_frame_rays(
        torch.tensor(cs.SERVE_POSE), torch.tensor(
            [focal, focal, size / 2, size / 2]), size, size, device=dev)
    return field_launches(lambda r: r.render_frame(model, p32, o, d,
                                                   chunk=size * size))


def held_part(launches):
    plain = {"run_tmlp": lambda x, tm, transposed: fm.run_tmlp_plain(x, tm),
             "run_tmlp_composite": fm.run_tmlp_composite_plain}
    kern = {"run_tmlp": fm.run_tmlp,
            "run_tmlp_composite": fm.run_tmlp_composite}
    out = []
    for name, a, k in launches:
        got, ref = kern[name](*a, **k), plain[name](*a, **k)
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        e64, p64 = cs.f64_errors(got, ref, cs.plain_f64(name, a, k))
        err = ratio = 0.0
        past = past_tol = 0
        for g_, r in zip(got, ref):
            d = (g_ - r).abs()
            err = max(err, float(d.max()))
            ratio = max(ratio, float((d / (1.0 + r.abs())).max()))
            past += int((d > cs.F32_FAITHFUL * (1.0 + r.abs())).sum())
            tol = cs.MLP_F32_TOL[name]
            past_tol += int((d > tol + tol * r.abs()).sum())
        del got, ref
        (km, k10, k90), (pm, p10, p90) = cs.interleaved_ms(
            [lambda: kern[name](*a, **k), lambda: plain[name](*a, **k)],
            T2_REPS)
        cuda_core, tensor = cs.field_op_ms(name, a, k)
        out.append({"name": name, "shape": cs.shape_key(a, k), "ms": km,
                    "ms_p10_p90": [k10, k90], "plain_ms": pm,
                    "plain_ms_p10_p90": [p10, p90],
                    "bound_f32_cuda_core_ms": cuda_core,
                    "bound_3xtf32_ms": tensor, "max_abs_err": err,
                    "max_err_ratio": ratio, "past_f32_faithful": past,
                    "past_mlp_f32_tol": past_tol, "f64_err": e64,
                    "cublas_f64_err": p64,
                    "f64_held": e64 <= cs.F32_F64_MULT * p64 + cs.F32_ULP})
        torch.cuda.empty_cache()
    return out


def main():
    if not torch.cuda.is_available():
        sys.exit("kernel_variants: needs a CUDA card")
    variants, name = load_variants(sys.argv[1]), sys.argv[2]
    parts = sys.argv[3].split(",") if len(sys.argv) > 3 else ["serve", "t2"]
    spec = None if name == "orig" else variants[name]
    if isinstance(spec, str) and os.path.isdir(os.path.join(ROOT, spec)):
        use_tree(spec)
    else:
        use_variant(name, {} if spec is None else {"fused_mlp_t.cu": spec})
    if name.startswith("fmad"):
        _build.NVCC_FLAGS = [f for f in _build.NVCC_FLAGS
                             if f != "-fmad=false"]
    t0 = time.perf_counter()
    fm._lib()
    print(f"    build {time.perf_counter() - t0:.1f} s")
    for line in (_build.BUILD_DIR / "fused_mlp_t.log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print("   ", line.strip()[:160])
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    res = {"variant": name}
    if "serve" in parts:
        res["serve"] = serve_part(dev)
    if "asset32" in parts:
        res["asset32"] = held_part(asset32_launches(dev))
    if "t2" in parts:
        res["t2"] = held_part(t2_launches(dev))
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
