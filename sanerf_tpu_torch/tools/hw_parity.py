"""Hardware parity check for the fused inference kernels (JAX:
tools/hw_parity.py).

The CPU parity tests hold every kernel's plain version against the JAX
package; this tool holds the KERNELS against the plain path on the card:
it runs `run_rays` with `cp_fused=True` (the field kernels with their
CP / VM / sigma grid blocks, the ray kernels) against the plain path
(`use_fused_mlp=False, cp_fused=False`) on the same seeded params, at the
JAX tool's four SHAPES, and reports max abs errors (depth relative).
`--packed` and `--flatten` set `packed_epilogue` and `flatten_kernel` on
the fast config, so with both every kernel of `ops/ray_kernels.py` and
`ops/fused_mlp_t.py` runs. The launches of each kernel counter are
printed per shape, so that a parity run that never reached a kernel
shows.

    python -m sanerf_tpu_torch.tools.hw_parity [--rays 4096] [--steps 32,24]
        [--tol 3e-2] [--packed] [--flatten]

Exit code 0 iff every output agrees within the tolerance.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import Dict

import torch

from sanerf_tpu_torch.config import ModelConfig, RenderConfig
from sanerf_tpu_torch.device import resolve_device
from sanerf_tpu_torch.models import fields, renderer
from sanerf_tpu_torch.ops import fused_mlp_t as fm
from sanerf_tpu_torch.ops import ray_kernels as rk

SHAPES = {
    # the distill_serving student (depth-3 decoder, grid tables)
    "serving": dict(mlp_field_depth=3, mlp_cp_rank=96, mlp_cp_res=256,
                    mlp_vm_rank=16, mlp_vm_res=64,
                    mlp_sigma_cp_rank=32, mlp_sigma_cp_res=256),
    # CP-only and multi-level ladders exercise the other kernel blocks
    "cp_ladder": dict(mlp_cp_rank=96, mlp_cp_res=256, mlp_cp_levels=2),
    "vm_ladder": dict(mlp_cp_rank=48, mlp_cp_res=128, mlp_vm_rank=16,
                      mlp_vm_res=64, mlp_vm_levels=2),
    "flagship": dict(),  # plain MLP (no tables): the tables-off fast path
}

#: the kernel counters, by the name printed
COUNTERS = {"ray_level0": rk.ray_level0, "ray_level": rk.ray_level,
            "run_tmlp": fm.run_tmlp,
            "run_tmlp_composite": fm.run_tmlp_composite,
            "flatten3_nt": rk.flatten3_nt}


def rays(n: int, device) -> tuple:
    """The JAX tool's rays: origins at (0, 0, 2), directions normal draws
    (seeded) normalised."""
    g = torch.Generator().manual_seed(1)
    d = torch.randn(n, 3, generator=g)
    d = d / d.norm(dim=-1, keepdim=True)
    o = torch.zeros(n, 3) + torch.tensor([0.0, 0.0, 2.0])
    return o.to(device), d.to(device)


def configs(name: str, steps, packed: bool = False, flatten: bool = False):
    """(ModelConfig, fast RenderConfig, plain RenderConfig) of a shape."""
    rc = RenderConfig(num_steps=tuple(steps), bound=128.0, contract=True,
                      cp_fused=True, packed_epilogue=packed,
                      flatten_kernel=flatten)
    rc_slow = dataclasses.replace(rc, use_fused_mlp=False, cp_fused=False)
    return ModelConfig(field_type="mlp", **SHAPES[name]), rc, rc_slow


def errors(fast: Dict, slow: Dict) -> Dict[str, float]:
    """Max abs errors of image, depth (relative to the plain depth's max)
    and weights_sum."""
    errs = {}
    for k in ("image", "depth", "weights_sum"):
        a, b = fast[k].float(), slow[k].float()
        err = float((a - b).abs().max())
        if k == "depth":  # depth spans [0, ~bound]; report relative
            err /= max(float(b.abs().max()), 1e-6)
        errs[k] = err
    return errs


def run_shape(name: str, args, device) -> Dict:
    """One shape: the fast and the plain render on the same seeded params
    -> {"errors", "ok", "launches"}."""
    mc, rc, rc_slow = configs(name, args.steps, args.packed, args.flatten)
    model_f = fields.make_model(mc, rc)
    model_s = fields.make_model(mc, rc_slow)
    params = fields.init_params(model_f, torch.Generator().manual_seed(0),
                                device)
    o, d = rays(args.rays, device)
    # the counters' own totals are the caller's: read, never reset
    before = {k: c.launches for k, c in COUNTERS.items()}
    with torch.no_grad():
        fast = renderer.run_rays(model_f, params, o, d)
        launches = {k: c.launches - before[k] for k, c in COUNTERS.items()}
        slow = renderer.run_rays(model_s, params, o, d)
    errs = errors(fast, slow)
    return {"errors": errs, "ok": all(v <= args.tol for v in errs.values()),
            "launches": launches,
            "fast_path": renderer.uses_kernels(model_f)}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rays", type=int, default=4096)
    ap.add_argument("--steps", default="32,24")
    ap.add_argument("--tol", type=float, default=3e-2,
                    help="bf16 fused vs f32 plain tolerance on [0,1] rgb")
    ap.add_argument("--packed", action="store_true",
                    help="also set packed_epilogue on the fast config")
    ap.add_argument("--flatten", action="store_true",
                    help="also set flatten_kernel on the fast config")
    return ap


def main(argv=None, *, device=None) -> int:
    """-> the exit code (0 iff every shape agrees); the records of each
    shape in `main.results`."""
    args = build_parser().parse_args(argv)
    args.steps = tuple(int(s) for s in args.steps.split(","))
    dev = resolve_device(device)
    kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    print(f"device: {kind}")
    failures = 0
    main.results = {}
    for name in SHAPES:
        r = run_shape(name, args, dev)
        main.results[name] = r
        failures += 0 if r["ok"] else 1
        print(f"{name:12s} {'OK ' if r['ok'] else 'FAIL'} "
              + "  ".join(f"{k}={v:.2e}" for k, v in r["errors"].items())
              + "  launches " + " ".join(f"{k}={v}" for k, v in
                                         r["launches"].items()),
              flush=True)
    return 1 if failures else 0


main.results = {}


if __name__ == "__main__":
    sys.exit(main())
