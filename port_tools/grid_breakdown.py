"""Times the field kernels of the factorized-grid configurations built from
a variant of csrc/fused_mlp_t.cu: the composite of each served
configuration of port_tools/grid_params.py (grid_student, cp_ladder,
vm_ladder) and its proposal launch, at the shapes of a 512^2 RGB frame at
(32, 16), bf16, numpy-seeded weights.

    python3 port_tools/grid_breakdown.py NAME    (needs a CUDA card)

NAME is "orig" for the source as it is, or a variant of
port_tools/grid_variants.json ({name: [[old, new], ...]} text
substitutions of csrc/fused_mlp_t.cu, built as kernel_variants.py builds
them; one process a variant, compared within one run on one card). A
variant that leaves a part of the encode out (e.g. the VM levels) splits
the composite's time without a profiler; its outputs are then wrong, and
the line says by how much, and whether chip_smoke.py's checks would catch
it: the composites' outputs past GRID_TOL + GRID_TOL |ref|, and the
encode probes' (fused_mlp_t.encode_probes at 100,003 points) past
PROBE_TOL + PROBE_TOL |ref|. Prints the ptxas register and spill lines,
then one JSON line: the mean ms of 10 launches (CUDA events, two rounds)
of each launch, and those errors.
"""

import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "port_tools"))

import grid_params as gp  # noqa: E402
from chip_smoke import GRID_TOL, PROBE_POINTS, PROBE_TOL  # noqa: E402
from kernel_breakdown import cuda_ms  # noqa: E402
from kernel_variants import use_variant  # noqa: E402
from sanerf_tpu_torch.config import ModelConfig, RenderConfig  # noqa: E402
from sanerf_tpu_torch.models import fields, renderer  # noqa: E402
from sanerf_tpu_torch.models.asset import (expected_shapes,  # noqa: E402
                                           params_from_jax)
from sanerf_tpu_torch.ops import _build  # noqa: E402
from sanerf_tpu_torch.ops import fused_mlp_t as fm  # noqa: E402

SIZE = 512
NAMES = ("grid_student", "cp_ladder", "vm_ladder")
VARIANTS = os.path.join(ROOT, "port_tools", "grid_variants.json")


def launches(name, dev):
    """{launch: fn} of one configuration's (32, 16) RGB frame, its
    composite's (args, kwargs), and its field net."""
    model = fields.make_model(ModelConfig(**gp.CONFIGS[name]), RenderConfig(
        num_steps=(32, 16), max_ray_batch=SIZE * SIZE))
    p = fields.cast_params(params_from_jax(
        gp.make_flat(expected_shapes(model), 0), model, dev), torch.bfloat16)
    nets = fields.KernelNets(model, p)
    o, d = (torch.from_numpy(a).to(dev) for a in gp.frame_rays(SIZE))
    seen = {}
    real = {n: getattr(fields, n) for n in ("run_tmlp", "run_tmlp_composite")}

    def spy(n):
        def wrapped(*a, **k):
            seen.setdefault(n, (a, k))
            return real[n](*a, **k)
        return wrapped

    for n in real:
        setattr(fields, n, spy(n))
    try:
        renderer.render_frame(model, p, o, d, chunk=SIZE * SIZE, nets=nets)
    finally:
        for n, f in real.items():
            setattr(fields, n, f)
    return {f"{name}/composite": (fm.run_tmlp_composite,
                                  *seen["run_tmlp_composite"]),
            f"{name}/proposal": (fm.run_tmlp, *seen["run_tmlp"])}, nets.field


def past(got, ref, tol):
    """-> (max |got - ref|, outputs past tol + tol |ref|) over the pairs."""
    e, n = 0.0, 0
    for g, r in zip(got, ref):
        d = (g - r).abs()
        e = max(e, float(d.max()))
        n += int((d > tol + tol * r.abs()).sum())
    return e, n


def main():
    if not torch.cuda.is_available():
        sys.exit("grid_breakdown: needs a CUDA card")
    name = sys.argv[1]
    with open(VARIANTS) as f:
        variants = json.load(f)
    use_variant(name, {} if name == "orig"
                else {"fused_mlp_t.cu": variants[name]})
    fm._lib()
    for line in (_build.BUILD_DIR / "fused_mlp_t.log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print("   ", line.strip()[:160])
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    cases, nets = {}, {}
    for n in NAMES:
        c, nets[n] = launches(n, dev)
        cases.update(c)
    ms, err, probe = {}, {}, {}
    for _ in range(2):
        for k, (fn, a, kw) in cases.items():
            ms.setdefault(k, []).append(cuda_ms(lambda: fn(*a, **kw)))
    for k, (fn, a, kw) in cases.items():
        if k.endswith("composite"):
            err[k] = past(fn(*a, **kw), fm.run_tmlp_composite_plain(*a, **kw),
                          GRID_TOL)
    g = torch.Generator(device=dev).manual_seed(0)
    for n, field in nets.items():
        x = (torch.rand(3, PROBE_POINTS, generator=g, device=dev) * 2.2
             - 1.1) * field.bound
        res = [past((fm.run_tmlp(x, p, transposed=True),),
                    (fm.run_tmlp_plain(x, p),), PROBE_TOL)
               for p in fm.encode_probes(field)]
        probe[n] = (max(e for e, _ in res), sum(c for _, c in res))
    print(json.dumps({"variant": name, "card": torch.cuda.get_device_name(0),
                      "ms": ms, "composite_err_past_grid_tol": err,
                      "grid_tol": GRID_TOL,
                      "probe_err_past_probe_tol": probe,
                      "probe_tol": PROBE_TOL}), flush=True)


if __name__ == "__main__":
    main()
