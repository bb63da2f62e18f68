"""A 64^2 frame of the width-256 MLP field through the JAX package's XLA
path (`use_fused_mlp=False`) on the CPU: the reference that the port's
`chip_smoke.py` holds its card's frame to (JAX_WIDE).

Model `ModelConfig(mlp_field_width=256)` (the `--mlp_width 256` row of
README's quality table: 63 -> 256 x 7 with the skip at 4, -> 16),
`RenderConfig()` defaults ((128, 64, 32), bound 128, contracted,
last_sample background) with `use_fused_mlp=False`; float32 params from
port_tools/grid_params.py:make_flat(shapes, SEED) (the same numpy draws
chip_smoke loads into the port); a 64^2 frame from the serving pose
(`frame_rays(64)`) through `renderer.run_rays`, unperturbed. Prints one
JSON line: the mean of image, depth and weights_sum over the frame and
their values at the pixels PIXELS.

    JAX_PLATFORMS=cpu python port_tools/jax_wide_reference.py
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

from grid_params import frame_rays, make_flat  # noqa: E402
from sanerf_tpu.config import ModelConfig, RenderConfig  # noqa: E402
from sanerf_tpu.models import fields, renderer  # noqa: E402
from sanerf_tpu.train.checkpoints import flatten_tree, unflatten_like  # noqa: E402

SIZE = 64
SEED = 0
PIXELS = (0, 650, 1500, 2015, 2080, 2700, 3333, 4095)
CONFIG = dict(mlp_field_width=256)


def main():
    t0 = time.time()
    model = fields.make_model(ModelConfig(**CONFIG),
                              RenderConfig(use_fused_mlp=False))
    tmpl = jax.eval_shape(lambda k: fields.init_params(model, k),
                          jax.random.key(0))
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
    print(json.dumps({
        "config": CONFIG, "size": SIZE, "seed": SEED, "pixels": px,
        "num_steps": list(RenderConfig().num_steps),
        "mean": {k: float(out[k].mean())
                 for k in ("image", "depth", "weights_sum")},
        "image": out["image"][px].tolist(),
        "depth": out["depth"][px].tolist(),
        "weights_sum": out["weights_sum"][px].tolist(),
        "depth_std": float(out["depth"].std()),
        "seconds": time.time() - t0}))


if __name__ == "__main__":
    main()
