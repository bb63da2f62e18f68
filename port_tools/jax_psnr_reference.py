"""Held-out PSNR of the shipped asset through the JAX package's XLA path
(`use_fused_mlp=False`) on the CPU: the quality reference that the port's
`chip_smoke.py` is held to.

Protocol of bench.py:149-170: textured fixture, 128^2, 8 views, ring radius
1.8, per-view `cam_near_far`, `render_staged`. Prints one JSON line per
(hierarchy, param dtype); the hierarchies are the arguments, each as
comma-separated sample counts (default: 32,16 128,64,32).

    JAX_PLATFORMS=cpu python port_tools/jax_psnr_reference.py [32,24 24,12]
"""

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
from sanerf_tpu.data.synthetic import SyntheticSphereDataset  # noqa: E402
from sanerf_tpu.models import fields, renderer  # noqa: E402
from sanerf_tpu.train.checkpoints import flatten_tree, unflatten_like  # noqa: E402
from sanerf_tpu.train.metrics import PSNRMeter  # noqa: E402


def main():
    asset = os.path.join(ROOT, "assets", "serving_student")
    with open(asset + ".json") as f:
        meta = json.load(f)
    flat = dict(np.load(asset + ".npz"))
    mc = config_from_dict(ModelConfig, meta["model_config"])
    ds = SyntheticSphereDataset(H=128, W=128, n_views=8, radius=1.8,
                                scene="textured", training=False)
    hierarchies = sys.argv[1:] or ["32,16", "128,64,32"]
    for steps in [tuple(int(v) for v in h.split(",")) for h in hierarchies]:
        for dt in ["bfloat16", "float32"]:
            rc = dataclasses.replace(
                config_from_dict(RenderConfig, meta["render_config"]),
                num_steps=steps, use_fused_mlp=False, max_ray_batch=128 * 128)
            model = fields.make_model(mc, rc)
            params = fields.init_params(model, jax.random.key(0))
            tmpl = flatten_tree(params, "")
            for k, v in flat.items():
                if k.startswith("params/"):
                    assert tmpl[k[7:]].shape == v.shape, k
                    tmpl[k[7:]] = v
            params = unflatten_like(params, tmpl, "")
            if dt == "bfloat16":
                params = fields.cast_params(params, jnp.bfloat16)
            meter = PSNRMeter()
            t0 = time.time()
            for idx in range(len(ds)):
                fr = ds.frame(idx)
                out = renderer.render_staged(
                    model, params, jnp.asarray(fr["rays_o"]),
                    jnp.asarray(fr["rays_d"]),
                    cam_near_far=jnp.asarray(fr["cam_near_far"]))
                meter.update(np.asarray(out["image"], np.float32), fr["images"])
            print(json.dumps({
                "num_steps": steps, "param_dtype": dt,
                "psnr_db": meter.measure(),
                "path": "JAX XLA (use_fused_mlp=False)", "backend": "cpu",
                "seconds": time.time() - t0}), flush=True)


if __name__ == "__main__":
    main()
