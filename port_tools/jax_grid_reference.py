"""64^2 frames of the grid configurations through the JAX package's XLA path
(`use_fused_mlp=False`) on the CPU: the reference that the port's
`chip_smoke.py` holds its card's frames to (JAX_GRID).

Models `ModelConfig(**CONFIGS[name])` of port_tools/grid_params.py for
grid_student and quality_recipe, `RenderConfig()` defaults ((128, 64, 32),
bound 128, contracted, last_sample background) with `use_fused_mlp=False`;
float32 params from `grid_params.make_flat(shapes, SEED)` (the same numpy
draws chip_smoke loads into the port); a 64^2 frame from the serving pose
(`frame_rays(64)`) through `renderer.run_rays`, unperturbed. Prints one
JSON line: per config the mean of image, depth and weights_sum over the
frame and their values at the pixels PIXELS.

    JAX_PLATFORMS=cpu python port_tools/jax_grid_reference.py
"""

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
sys.path.insert(0, os.path.join(ROOT, "port_tools"))

from grid_params import CONFIGS, frame_rays, make_flat  # noqa: E402
from sanerf_tpu.config import ModelConfig, RenderConfig  # noqa: E402
from sanerf_tpu.models import fields, renderer  # noqa: E402
from sanerf_tpu.train.checkpoints import flatten_tree, unflatten_like  # noqa: E402

SIZE = 64
SEED = 0
PIXELS = (0, 650, 1500, 2015, 2080, 2700, 3333, 4095)
NAMES = ("grid_student", "quality_recipe")


def frame(name):
    model = fields.make_model(ModelConfig(**CONFIGS[name]),
                              RenderConfig(use_fused_mlp=False))
    tmpl = jax.eval_shape(lambda k: fields.init_params(model, k),
                          jax.random.key(0))
    # zero-stride views: flatten_tree wants arrays, not shape structs
    views = jax.tree.map(lambda s: np.broadcast_to(np.float32(0), s.shape),
                         tmpl)
    shapes = {k: tuple(v.shape) for k, v in flatten_tree(views, "").items()}
    flat = make_flat(shapes, SEED)
    params = unflatten_like(tmpl, {k[len("params/"):]: jnp.asarray(v)
                                   for k, v in flat.items()}, "")
    o, d = frame_rays(SIZE)
    out = renderer.run_rays(model, params, jnp.asarray(o), jnp.asarray(d))
    out = {k: np.asarray(v, np.float64) for k, v in out.items()}
    px = list(PIXELS)
    return {"mean": {k: float(out[k].mean())
                     for k in ("image", "depth", "weights_sum")},
            "image": out["image"][px].tolist(),
            "depth": out["depth"][px].tolist(),
            "weights_sum": out["weights_sum"][px].tolist(),
            "depth_std": float(out["depth"].std()),
            "grid_table_bytes": model.grid_table_bytes}


def main():
    t0 = time.time()
    rec = {"size": SIZE, "seed": SEED, "pixels": list(PIXELS),
           "num_steps": list(RenderConfig().num_steps)}
    for name in NAMES:
        rec[name] = frame(name)
    rec["seconds"] = time.time() - t0
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
