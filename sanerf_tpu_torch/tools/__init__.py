"""The asset pipeline on the port (JAX: tools/*.py).

One module per JAX tool, each with the JAX tool's name, flags, defaults and
JSON lines, run as `python -m sanerf_tpu_torch.tools.<name>`:

  - quality_gate:     trains both field families on the textured fixture and
                      scores the held-out ring;
  - redistill_asset:  distills a serving student from the shipped asset or
                      a quality_gate workspace;
  - distill_serving:  distills a grid teacher of the CLI's flags into a
                      fused-path student;
  - import_checkpoint: a reference `.pth` -> a workspace checkpoint (the
                      exact hash grid, or a distilled MLP student);
  - finetune_student: a short RGB finetune of a student workspace;
  - eval_student:     a workspace's held-out PSNR / SSIM at three
                      hierarchies;
  - hierarchy_gate:   a checkpoint's held-out PSNR under candidate
                      hierarchies;
  - pack_asset:       a student workspace -> `<out>.{npz,json}`;
  - serve_finetune:   finetunes the asset at its serving hierarchy;
  - mask_asset:       trains the stage-3 mask head on the frozen asset.

and the probes and the pipeline's wall clock:

  - hw_parity:        `run_rays` on the kernels against the plain path at
                      four model shapes, with every kernel counter;
  - probe_gather:     the table-gather probes (the TPU tool's XLA and
                      Pallas formulations) on `gather_rows` and PyTorch's
                      own calls, rows/s each;
  - kbench:           the composite kernel's ablations at the asset's
                      shape (field chain, grid block, view epilogue);
  - two_stage_wall:   stage 1 (20k iterations) and stage 2 (5k, the
                      ViT-H teacher at 1024^2) end to end, one JSON line;
                      `--resume` across calls;
  - colmap2nerf:      images or a video -> COLMAP -> transforms.json.

The run recipes of the JAX package's `scripts/*.sh` have their twins in
`sanerf_tpu_torch/scripts/`.

Every `main(argv=None, *, device=None)` runs on the CUDA card unless the
caller asks for the CPU (`device="cpu"`, the plain versions; colmap2nerf
runs no model, and takes `--device cpu` from the shell too). The three
that write the shipped asset by default (pack_asset's `--out`, mask_asset's
`--out`, serve_finetune's `--pack`) also take `asset=`, the path they read
and write in place of `assets/serving_student`; nothing here writes
`assets/` unless its defaults are left as they are.
"""

from __future__ import annotations

import json
import os
import statistics
from typing import Callable, Dict, Iterator, Tuple

import numpy as np
import torch

from sanerf_tpu_torch.data.synthetic import SyntheticSphereDataset
from sanerf_tpu_torch.models import renderer
from sanerf_tpu_torch.models.fields import NerfModel, Params

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
#: the shipped serving asset, `<ASSET>.json` + `<ASSET>.npz`
ASSET = os.path.join(ROOT, "assets", "serving_student")


def heldout_ring(H: int = 128, n_views: int = 8) -> SyntheticSphereDataset:
    """The quality gate's held-out third ring (radius 1.8; circle_poses at
    heights 0.5 / 1.1 and radii 1.8 / 1.35, away from both training
    rings)."""
    return SyntheticSphereDataset(H=H, W=H, n_views=n_views, radius=1.8,
                                  scene="textured", training=False)


def training_rings(H: int, n_views: int) -> SyntheticSphereDataset:
    """The textured fixture's two training rings."""
    return SyntheticSphereDataset(H=H, W=H, n_views=n_views,
                                  scene="textured")


def ring_images(model: NerfModel, params: Params,
                ds: SyntheticSphereDataset, device
                ) -> Iterator[Tuple[np.ndarray, Dict]]:
    """(image [H W, 3] float32, frame) of each view of `ds`, rendered whole
    through `render_staged` with the frame's near/far."""
    for idx in range(len(ds)):
        fr = ds.frame(idx)
        ro, rd, cnf = (torch.as_tensor(fr[k], device=device)
                       for k in ("rays_o", "rays_d", "cam_near_far"))
        with torch.no_grad():
            out = renderer.render_staged(model, params, ro, rd,
                                         cam_near_far=cnf)
        yield out["image"].float().cpu().numpy(), fr


def read_meta(workspace: str) -> Dict:
    """A student workspace's serving_meta.json."""
    with open(os.path.join(workspace, "serving_meta.json")) as f:
        return json.load(f)


def epochs(iters: int, per: int = 500) -> Tuple[int, int]:
    """(max_epoch, steps_per_epoch) of the tools' training loops."""
    steps = min(per, iters)
    return max(1, iters // steps), steps


def queued_ms(fn: Callable[[], object], reps: int = 21) -> float:
    """The median CUDA-event time (ms) of `reps` calls of fn, each timed
    alone, enqueued behind a sleep kernel so that they run back to back:
    the card's time, not the host's (a wrapper's Python can take as long
    as a small kernel). One call before, unmeasured."""
    fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    a, b = ev[0]
    a.record()
    torch.cuda._sleep(1_000_000)
    b.record()
    torch.cuda.synchronize()
    per_ms = 1_000_000 / max(a.elapsed_time(b), 1e-3)
    # about 0.3 ms of backlog a call, enough for the host to keep ahead
    torch.cuda._sleep(int(0.3 * reps * per_ms))
    for a, b in ev:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in ev)


def jax_report(report: Dict) -> Dict:
    """`import_distill.distill_to_mlp`'s report with the keys of JAX's:
    without the port's per-step `loss_history`."""
    return {k: v for k, v in report.items() if k != "loss_history"}
