"""64^2 frames of the configurations past the port's former kernel limits
through the JAX package's XLA path (`use_fused_mlp=False`) on the CPU:
the references that `chip_smoke.py` holds the port's kernel frames to
(its phases L1-L7).

    JAX_PLATFORMS=cpu python port_tools/jax_limits_reference.py [NAME ...] \
        > port_tools/jax_limits.jsonl

The configurations are port_tools/grid_params.py:LIMITS (RenderConfig
defaults otherwise: (128, 64, 32), bound 128, contracted, last_sample
background): rays past 128 samples (L1), 12 and 16 layers (L2), layers
320 and 512 wide (L3), view heads 48 and 128 wide (L4), 31 geometry
features (L5, a composite of 32 outputs), CP and VM ladders of 16 levels
(L6). The tables past 25 MB (L7) are the quality recipe's, whose
reference is port_tools/jax_grid_reference.py's. Float32
params from port_tools/grid_params.py:make_flat(shapes, SEED) (the same
numpy draws chip_smoke loads into the port); a 64^2 frame from the
serving pose (`frame_rays(64)`) through `renderer.run_rays`, unperturbed.
Prints one JSON line a config: the mean of image, depth and weights_sum
over the frame and their values at the pixels PIXELS (port_tools/
jax_limits.jsonl keeps them; chip_smoke.py reads it).
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

from grid_params import LIMITS, frame_rays, make_flat  # noqa: E402
from sanerf_tpu.config import ModelConfig, RenderConfig  # noqa: E402
from sanerf_tpu.models import fields, renderer  # noqa: E402
from sanerf_tpu.train.checkpoints import flatten_tree, unflatten_like  # noqa: E402

SIZE = 64
SEED = 0
PIXELS = (0, 650, 1500, 2015, 2080, 2700, 3333, 4095)
#: grid_params.LIMITS but the quality recipe, whose JAX frame is
#: jax_grid_reference.py's (the XLA path's frame does not depend on the
#: budget)
CONFIGS = {k: v for k, v in LIMITS.items() if not k.startswith("L7")}


def frame(mkw, rkw):
    model = fields.make_model(ModelConfig(**mkw),
                              RenderConfig(use_fused_mlp=False, **rkw))
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
    return {k: np.asarray(v, np.float64) for k, v in out.items()}


def main():
    names = sys.argv[1:] or list(CONFIGS)
    for name in names:
        t0 = time.time()
        mkw, rkw = CONFIGS[name]
        out = frame(mkw, rkw)
        px = list(PIXELS)
        print(json.dumps({
            "name": name, "model": mkw, "render": {
                k: list(v) if isinstance(v, tuple) else v
                for k, v in rkw.items()},
            "size": SIZE, "seed": SEED, "pixels": px,
            "mean": {k: float(out[k].mean())
                     for k in ("image", "depth", "weights_sum")},
            "image": out["image"][px].tolist(),
            "depth": out["depth"][px].tolist(),
            "weights_sum": out["weights_sum"][px].tolist(),
            "seconds": time.time() - t0}), flush=True)


if __name__ == "__main__":
    main()
