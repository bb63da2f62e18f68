"""Where chip_smoke's D1 label agreement goes, on the CUDA card.

D1 runs `sam_project.generate_masks` on the stage-2 model's rendered
features twice, through the kernels and through the plain path
(`use_fused_mlp=False`), and holds the label maps equal on MASK_AGREE of
the pixels. This script trains phase C's workspaces (`chip_smoke.cli_phase`)
and then, on D1's views and prompts, reports the agreement of:
  - kernels / plain with the bf16 SAM decoder (D1 as it runs);
  - kernels / plain with the same decoder weights in float32;
  - plain / plain with the bf16 decoder, the second run's feature maps
    multiplied by (1 + EPS N(0, 1)), EPS in NOISE: the decoder's own
    sensitivity to feature changes of that size;
and the feature maps' largest difference between the two routes. One JSON
line, beside the card's name and power limit.

    python3 port_tools/d1_agreement.py      # about 6 min with the build
"""

import contextlib
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from sanerf_tpu_torch.apps import main as cli  # noqa: E402
from sanerf_tpu_torch.apps import sam_project  # noqa: E402
from sanerf_tpu_torch.data.provider import SceneDataset  # noqa: E402
from sanerf_tpu_torch.models import fields  # noqa: E402
from sanerf_tpu_torch.models.sam import SamPredictor  # noqa: E402
from sanerf_tpu_torch.ops import _build  # noqa: E402
from sanerf_tpu_torch.train.trainer import Trainer  # noqa: E402

NOISE = (1e-6, 1e-5, 1e-4)


def agreement(a_dir, b_dir, names):
    same = total = 0
    for n in names:
        a, b = (np.load(os.path.join(d, f"{n}_masks.npy"))
                for d in (a_dir, b_dir))
        same += int((a == b).sum())
        total += a.size
    return same / total


def main():
    t0 = time.time()
    _build.build_all()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    with contextlib.redirect_stdout(sys.stderr):
        _, ctx = cs.cli_phase(torch, np, dev, card)
    base, ds = ctx["base"], ctx["ds"]
    cfg2 = cli.config_from_args(cli.build_parser().parse_args(
        [ctx["scene"], *cs.CLI_ARGS, "--workspace", ctx["ws_sam"],
         "--with_sam", "--sam_ckpt", ctx["sam_path"]]))
    views = SceneDataset(cfg2, "all")
    T, T2 = ds.poses[:, :3, 3], views.poses[:, :3, 3]
    sc = float(np.sqrt(((T2 - T2.mean(0)) ** 2).sum()
                       / ((T - T.mean(0)) ** 2).sum()))
    off = T2.mean(0) - sc * T.mean(0)
    el = np.deg2rad(20.0)
    dirs = [(np.cos(a) * np.cos(el), np.sin(el), np.sin(a) * np.cos(el))
            for a in np.arange(8) * np.pi / 4] + [(0.0, 1.0, 0.0)]
    pts = np.asarray([np.asarray(c) + rad * np.asarray(d)
                      for c, rad in cs.APPS_SPHERES for d in dirs],
                     np.float32)
    pts_w = (sc * pts + off).astype(np.float32)

    def trainer(fused):
        return Trainer("ngp", cfg2, fields.make_model(
            cfg2.model, dataclasses.replace(cfg2.render,
                                            use_fused_mlp=fused)),
            workspace=ctx["ws_sam"])

    sam16 = cli.build_sam_predictor(cfg2)
    sam32 = SamPredictor(sam16.cfg, fields.cast_params(sam16.params,
                                                       torch.float32),
                         device=dev)
    rec = {"card": card}
    out = {}
    with contextlib.redirect_stdout(sys.stderr):
        trs = {"kernels": trainer(True), "plain": trainer(False)}
        for route, tr in trs.items():
            for dt, sam in (("bf16", sam16), ("f32", sam32)):
                out[route, dt] = os.path.join(base, f"d1_{route}_{dt}")
                sam_project.generate_masks(cfg2, views, pts_w, sam,
                                           out[route, dt], trainer=tr,
                                           use_nerf_feature=True)
        names = views.names
        for dt in ("bf16", "f32"):
            rec[f"kernels_vs_plain_{dt}"] = agreement(
                out["kernels", dt], out["plain", dt], names)
        # the decoder's own sensitivity: the plain route again, its feature
        # maps scaled by (1 + eps N(0, 1))
        real = sam16.set_features
        for eps in NOISE:
            g = torch.Generator(device=dev).manual_seed(0)

            def noisy(feats, H, W, eps=eps, g=g):
                f = torch.as_tensor(feats, device=dev)
                n = torch.randn(f.shape, generator=g, device=dev)
                return real(f * (1 + eps * n), H, W)

            sam16.set_features = noisy
            d = os.path.join(base, f"d1_plain_noise{eps:g}")
            sam_project.generate_masks(cfg2, views, pts_w, sam16, d,
                                       trainer=trs["plain"],
                                       use_nerf_feature=True)
            sam16.set_features = real
            rec[f"plain_vs_plain_noise_{eps:g}"] = agreement(
                out["plain", "bf16"], d, names)
        # the feature maps of both routes at D1's 8^2
        lr_h = max(4, int(views.H / 1024 * 64))
        intr = views.intrinsics * (lr_h / views.H)
        intr[2:] = lr_h / 2
        diffs, rel = [], []
        for i in range(len(views)):
            fk, fp = (trs[r].render_pose(views.poses[i], intr, lr_h, lr_h,
                                         return_feats=True)["samvit"]
                      for r in ("kernels", "plain"))
            diffs.append(float(np.abs(fk - fp).max()))
            rel.append(float(np.abs(fk - fp).max() / np.abs(fp).max()))
        rec["feature_max_abs_diff"] = max(diffs)
        rec["feature_max_rel_diff"] = max(rel)
    rec["seconds"] = time.time() - t0
    shutil.rmtree(base, ignore_errors=True)
    print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
