"""Where the interactive frame's time goes on the card: the frame of
`chip_smoke.py` phase 5 (the asset with a seeded SAM feature head, the
`SamConfig()` decoder with seeded bf16 weights, one 3D point at the origin,
512^2, `InteractiveSession.step`) split into its parts.

    python3 port_tools/interactive_breakdown.py    (needs a CUDA card)

Prints the card and JSON lines:
  frames      median step time, pipelined and sync, with the yuv420 and the
              rgb8 display transport, at (32, 16) and (128, 64, 32);
  parts       at (32, 16), each part timed alone, synchronised, median of 7:
              the RGB render, the 32^2 feature render, decode_fused (SAM),
              the host-side I420 decode of one frame, and the host time to
              enqueue one whole frame (no synchronise);
  profile     a torch.profiler trace of 3 sync frames at (32, 16): device
              time per frame, its share of the frame, and the kernels with
              the most device time.
"""

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from sanerf_tpu_torch.apps import frame_pipeline as fp  # noqa: E402
from sanerf_tpu_torch.apps.interactive import InteractiveSession  # noqa: E402
from sanerf_tpu_torch.data.rays import full_frame_rays  # noqa: E402
from sanerf_tpu_torch.models import fields, renderer  # noqa: E402
from sanerf_tpu_torch.models.asset import load_asset  # noqa: E402
from sanerf_tpu_torch.models.sam import predictor as sam_mod  # noqa: E402

SIZE = 512
POSE = np.array([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 2.0], [0, 0, 0, 1]],
                np.float32)
HIERARCHIES = {"32,16": (32, 16), "128,64,32": (128, 64, 32)}


def median_ms(fn, n=7, sync=True):
    fn()
    ts = []
    for _ in range(n):
        if sync:
            torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        if sync:
            torch.cuda.synchronize()
        ts.append((time.perf_counter() - t) * 1e3)
    return statistics.median(ts)


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda")
    mc, rc, p32 = load_asset(os.path.join(ROOT, "assets", "serving_student"),
                             device=dev, with_sam=True, seed=0)
    params = fields.cast_params(p32, torch.bfloat16)
    sam_cfg = sam_mod.SamConfig()
    sam_params = fields.cast_params(sam_mod.init_params(
        sam_cfg, torch.Generator().manual_seed(1), dev))

    def session(steps, fetch_format):
        model = fields.make_model(mc, dataclasses.replace(
            rc, num_steps=steps, max_ray_batch=SIZE * SIZE))
        s = InteractiveSession(None, model, params, sam_mod.SamPredictor(
            sam_cfg, sam_params, device=dev), H=SIZE, W=SIZE,
            fetch_format=fetch_format, device=dev)
        s.step(POSE)
        s.points_3d.append(np.zeros(3, np.float32))
        s.step(POSE)
        return s

    frames = {}
    for h, steps in HIERARCHIES.items():
        for ff in ("yuv420", "rgb8"):
            s = session(steps, ff)
            frames[f"{h}/{ff}"] = {
                "pipelined_ms": median_ms(
                    lambda: s.step(POSE, pipelined=True), sync=False),
                "sync_ms": median_ms(lambda: s.step(POSE, pipelined=False),
                                     sync=False)}
    print(json.dumps({"frames": frames, "card": card}), flush=True)

    # the parts of one (32, 16) frame
    s = session((32, 16), "yuv420")
    model = s.model
    intr = s.intrinsics_for(POSE)
    ro, rd = full_frame_rays(POSE, intr, SIZE, SIZE, device=dev)
    h = s.h
    intr_lr = np.float32([intr[0] * h / SIZE, intr[1] * h / SIZE, h / 2,
                          h / 2])
    fro, frd = full_frame_rays(POSE, intr_lr, h, h, device=dev)
    nets = fields.KernelNets(model, params)
    feat = renderer.run_rays(model, params, fro, frd, return_feats=True,
                             nets=nets)["samvit"].reshape(h, h, -1)
    pts = torch.tensor([[[255.5, 255.5]]], device=dev)
    lab = torch.tensor([[1]], device=dev)
    pipe = s._pipes[(SIZE, SIZE)]
    buf = fp._pack_display(torch.rand(SIZE, SIZE, 3, device=dev),
                           torch.zeros(8, 2, device=dev),
                           torch.zeros(8, dtype=torch.bool, device=dev),
                           SIZE).cpu().numpy()
    p3, act = pipe.pad_points([np.zeros(3, np.float32)])
    parts = {
        "rgb_render_ms": median_ms(lambda: renderer.run_rays(
            model, params, ro, rd, nets=nets)),
        "feature_render_ms": median_ms(lambda: renderer.run_rays(
            model, params, fro, frd, return_feats=True, nets=nets)),
        "decode_fused_ms": median_ms(lambda: sam_mod.decode_fused(
            sam_cfg, sam_params, feat, pts, lab, (h, h), (SIZE, SIZE),
            pipe.input_hw)),
        "host_i420_decode_ms": median_ms(
            lambda: fp.unpack_display(buf, SIZE, SIZE, 8), sync=False),
        "host_enqueue_frame_ms": median_ms(
            lambda: pipe._dispatch(POSE, intr, p3, act, None, 1.0, 0, None,
                                   "image", False), sync=False),
    }
    torch.cuda.synchronize()
    print(json.dumps({"parts": parts, "hierarchy": "32,16", "card": card}),
          flush=True)

    from torch.profiler import ProfilerActivity, profile

    n = 3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(n):
            s.step(POSE, pipelined=False)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3 / n
    ev = [e for e in prof.key_averages()
          if getattr(e, "self_device_time_total", 0) > 0]
    dev_ms = sum(e.self_device_time_total for e in ev) / 1e3 / n
    top = sorted(ev, key=lambda e: -e.self_device_time_total)[:20]
    print(json.dumps({"profile": {
        "frames": n, "wall_ms_per_frame": wall,
        "device_ms_per_frame": dev_ms,
        "device_busy_share": dev_ms / wall,
        "kernels_per_frame": sum(e.count for e in ev) / n,
        "top": [{"name": e.key[:80], "calls_per_frame": e.count / n,
                 "device_ms_per_frame": e.self_device_time_total / 1e3 / n}
                for e in top]}, "hierarchy": "32,16", "card": card}),
        flush=True)


if __name__ == "__main__":
    main()
