"""How far the JAX package's own two render paths are apart on the frame
that `chip_smoke.py` checks: its fast path (the Pallas kernels, in
interpret mode on the CPU) against its XLA path (`use_fused_mlp=False`),
float32 params of the shipped asset, the 512^2 serving pose, rows 128-255
(the band `chip_smoke.py` renders through both of the port's paths).

The two paths compute the same frame by different arithmetic (angle-doubling
against dense Fourier features, the clamped-ramp resample against
sample_pdf), and on a few rays whose weight sits between two depths the
depth moves by more than the 2e-3 the port's fast path is held to against
its plain path. This script measures that gap in the reference itself.
Prints one JSON line per hierarchy (`--steps`, each as comma-separated
sample counts; default 32,16 128,64,32).

    JAX_PLATFORMS=cpu python port_tools/jax_path_gap.py [--rows 128 256] \
        [--steps 32,24 24,12]
"""

import argparse
import dataclasses
import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

jax.config.update("jax_platforms", "cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from sanerf_tpu.config import ModelConfig, RenderConfig, config_from_dict  # noqa: E402
from sanerf_tpu.data.rays import full_frame_rays  # noqa: E402
from sanerf_tpu.models import fields, renderer  # noqa: E402
from sanerf_tpu.train.checkpoints import flatten_tree, unflatten_like  # noqa: E402
from sanerf_tpu.utils.camera import fov_to_focal  # noqa: E402

SIZE = 512
POSE = [[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 2.0], [0, 0, 0, 1]]
TOL = 2e-3


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, nargs=2, default=(128, 256))
    ap.add_argument("--steps", nargs="+", default=["32,16", "128,64,32"])
    args = ap.parse_args()
    asset = os.path.join(ROOT, "assets", "serving_student")
    with open(asset + ".json") as f:
        meta = json.load(f)
    flat = dict(np.load(asset + ".npz"))
    mc = config_from_dict(ModelConfig, meta["model_config"])
    focal = fov_to_focal(60.0, SIZE)
    o, d = full_frame_rays(jnp.asarray(POSE, jnp.float32),
                           jnp.asarray([focal, focal, SIZE / 2, SIZE / 2],
                                       jnp.float32), SIZE, SIZE)
    for steps in [tuple(int(v) for v in h.split(",")) for h in args.steps]:
        t0 = time.time()
        outs = {}
        for fused in (True, False):
            rc = dataclasses.replace(
                config_from_dict(RenderConfig, meta["render_config"]),
                num_steps=steps, use_fused_mlp=fused)
            model = fields.make_model(mc, rc)
            params = fields.init_params(model, jax.random.key(0))
            tmpl = flatten_tree(params, "")
            for k, v in flat.items():
                if k.startswith("params/"):
                    tmpl[k[7:]] = v
            params = unflatten_like(params, tmpl, "")
            parts = []
            for r in range(*args.rows):
                sl = slice(r * SIZE, (r + 1) * SIZE)
                out = renderer.run_rays(model, params, o[sl], d[sl])
                parts.append({k: np.asarray(out[k])
                              for k in ("image", "depth", "weights_sum")})
            outs[fused] = {k: np.concatenate([p[k] for p in parts])
                           for k in parts[0]}
        res = {"num_steps": steps, "rows": list(args.rows),
               "rays": int(outs[True]["depth"].shape[0])}
        for k in ("image", "depth", "weights_sum"):
            diff = np.abs(outs[True][k] - outs[False][k])
            over = diff > TOL + TOL * np.abs(outs[False][k])
            if over.ndim > 1:
                over, diff = over.any(-1), diff.max(-1)
            res[k] = {"max_abs_diff": float(diff.max()),
                      "rays_over_2e-3": int(over.sum())}
        res["seconds"] = time.time() - t0
        print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
