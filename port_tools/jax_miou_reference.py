"""Held-out mask mIoU of the shipped mask head through the JAX package's
XLA path (`use_fused_mlp=False`) on the CPU: the quality reference that the
port's `chip_smoke.py` holds its mask field to.

Protocol of bench.py:173-225: `assets/serving_student` with the mask head
of `assets/serving_student_mask.*` overlaid (with_sam off, with_mask on,
n_inst from the mask JSON), bf16 params, (32, 16), textured fixture at
128^2, 8 views, ring radius 1.8, per-view `cam_near_far`, `render_staged`
with `return_mask`, argmax over the instance logits. Prints one JSON line.

    JAX_PLATFORMS=cpu python port_tools/jax_miou_reference.py
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
from sanerf_tpu.train.metrics import MeanIoUMeter  # noqa: E402


def main():
    asset = os.path.join(ROOT, "assets", "serving_student")
    with open(asset + ".json") as f:
        meta = json.load(f)
    with open(asset + "_mask.json") as f:
        mmeta = json.load(f)
    steps = (32, 16)
    mc = dataclasses.replace(
        config_from_dict(ModelConfig, meta["model_config"]), with_sam=False,
        with_mask=True, mask_mlp_type=mmeta["mask_mlp_type"],
        n_inst=mmeta["n_inst"])
    rc = dataclasses.replace(
        config_from_dict(RenderConfig, meta["render_config"]),
        num_steps=steps, use_fused_mlp=False, max_ray_batch=128 * 128)
    model = fields.make_model(mc, rc)
    params = fields.init_params(model, jax.random.key(0))
    tmpl = flatten_tree(params, "")
    for name in (asset, asset + "_mask"):
        for k, v in np.load(name + ".npz").items():
            if k.startswith("params/"):
                assert tmpl[k[7:]].shape == v.shape, k
                tmpl[k[7:]] = v
    params = fields.cast_params(unflatten_like(params, tmpl, ""),
                                jnp.bfloat16)
    ds = SyntheticSphereDataset(H=128, W=128, n_views=8, radius=1.8,
                                scene="textured", training=False)
    meter = MeanIoUMeter()
    t0 = time.time()
    for idx in range(len(ds)):
        fr = ds.frame(idx)
        out = renderer.render_staged(
            model, params, jnp.asarray(fr["rays_o"]),
            jnp.asarray(fr["rays_d"]), return_mask=True,
            cam_near_far=jnp.asarray(fr["cam_near_far"]))
        pred = np.asarray(jnp.argmax(out["instance_mask_logits"], -1))
        meter.update(pred, fr["masks"])
    print(json.dumps({
        "num_steps": steps, "param_dtype": "bfloat16",
        "mask_miou": meter.measure(),
        "path": "JAX XLA (use_fused_mlp=False)", "backend": "cpu",
        "seconds": time.time() - t0}), flush=True)


if __name__ == "__main__":
    main()
