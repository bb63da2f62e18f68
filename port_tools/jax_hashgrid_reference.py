"""The full-width hash-grid frame through the JAX package on the CPU: the
reference that the port's `chip_smoke.py` holds its card's frame to.

Model `ModelConfig(field_type="hashgrid", with_sam=True)` with every grid
and MLP at its default, `RenderConfig()` defaults ((128, 64, 32), bound
128, contracted, last_sample background); float32 params from
`port_tools/hashgrid_params.py:make_flat(shapes, SEED)` (the same numpy
draws chip_smoke loads into the port); a 64^2 frame from the serving pose
(`frame_rays(64)`) through `renderer.run_rays(..., return_feats=True)`,
unperturbed. Prints one JSON line: the mean of image, depth, weights_sum
and samvit over the frame, and their values at the pixels PIXELS (samvit
at the channels CHANNELS).

    JAX_PLATFORMS=cpu python port_tools/jax_hashgrid_reference.py
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

from hashgrid_params import TABLE_STD, frame_rays, make_flat  # noqa: E402
from sanerf_tpu.config import ModelConfig, RenderConfig  # noqa: E402
from sanerf_tpu.models import fields, renderer  # noqa: E402
from sanerf_tpu.train.checkpoints import flatten_tree, unflatten_like  # noqa: E402

SIZE = 64
SEED = 0
PIXELS = (0, 650, 1500, 2015, 2080, 2700, 3333, 4095)
CHANNELS = (0, 1, 128, 255)


def main():
    t0 = time.time()
    model = fields.make_model(ModelConfig(field_type="hashgrid",
                                          with_sam=True), RenderConfig())
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
    out = renderer.run_rays(model, params, jnp.asarray(o), jnp.asarray(d),
                            return_feats=True)
    out = {k: np.asarray(v, np.float64) for k, v in out.items()}
    px = list(PIXELS)
    print(json.dumps({
        "size": SIZE, "seed": SEED, "table_std": TABLE_STD,
        "num_steps": list(model.render_cfg.num_steps),
        "pixels": px, "channels": list(CHANNELS),
        "mean": {k: float(out[k].mean()) for k in
                 ("image", "depth", "weights_sum", "samvit")},
        "image": out["image"][px].tolist(),
        "depth": out["depth"][px].tolist(),
        "weights_sum": out["weights_sum"][px].tolist(),
        "samvit": out["samvit"][px][:, list(CHANNELS)].tolist(),
        "depth_std": float(out["depth"].std()),
        "seconds": time.time() - t0}))


if __name__ == "__main__":
    main()
