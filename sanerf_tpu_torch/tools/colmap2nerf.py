"""video/images -> COLMAP -> transforms.json: dataset prep (JAX:
scripts/colmap2nerf.py).

Shells out to the `colmap` binary for feature extraction, matching and
mapping (and to `ffmpeg` for `--video`), exactly as the JAX script does,
then converts the sparse model into a transforms.json that the llff / mip
providers read (`sanerf_tpu_torch/data/colmap_utils.py`). A missing
binary raises a RuntimeError that names it.

    python -m sanerf_tpu_torch.tools.colmap2nerf --images DIR --out DIR
    python -m sanerf_tpu_torch.tools.colmap2nerf --video FILE --out DIR \\
        [--fps 2] [--time_slice t1,t2] [--matcher sequential] [--sharpness]

The tool runs no model; like every entry point of the port it runs where
a CUDA card is unless the caller asks for the CPU (`--device cpu`, or
`device="cpu"` to `main`), and raises when there is none.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
from typing import List, Optional

import numpy as np

from sanerf_tpu_torch.data import colmap_utils
from sanerf_tpu_torch.device import resolve_device


def _run(cmd: List[str]) -> None:
    """subprocess.check_call, with a clear error where the binary is not
    on the PATH."""
    if shutil.which(cmd[0]) is None:
        raise RuntimeError(f"colmap2nerf needs the `{cmd[0]}` binary on the "
                           f"PATH, and there is none")
    subprocess.check_call(cmd)


def run_colmap(images_dir: str, out_dir: str, matcher: str = "exhaustive"):
    db = os.path.join(out_dir, "database.db")
    sparse = os.path.join(out_dir, "sparse")
    os.makedirs(sparse, exist_ok=True)
    _run(["colmap", "feature_extractor", "--database_path", db,
          "--image_path", images_dir,
          "--ImageReader.camera_model", "PINHOLE",
          "--ImageReader.single_camera", "1"])
    _run(["colmap", f"{matcher}_matcher", "--database_path", db])
    _run(["colmap", "mapper", "--database_path", db,
          "--image_path", images_dir, "--output_path", sparse])
    return os.path.join(sparse, "0")


def sparse_to_transforms(sparse_dir: str, images_rel: str = "images",
                         images_dir: Optional[str] = None,
                         skip_early: int = 0) -> dict:
    cams, images, pts, _, _ = colmap_utils.read_model(sparse_dir)
    cam = next(iter(cams.values()))
    frames = []
    for k in sorted(images, key=lambda k: images[k].name)[skip_early:]:
        im = images[k]
        c2w = im.cam_to_world()
        c2w[:3, 1] *= -1
        c2w[:3, 2] *= -1  # OpenCV -> OpenGL
        frame = {
            "file_path": f"{images_rel}/{im.name}",
            "transform_matrix": c2w.tolist(),
        }
        if images_dir is not None:
            frame["sharpness"] = sharpness(os.path.join(images_dir, im.name))
        frames.append(frame)
    return {
        "fl_x": cam.fx, "fl_y": cam.fy, "cx": cam.cx, "cy": cam.cy,
        "w": cam.width, "h": cam.height, "frames": frames,
    }


def extract_video(video: str, out_dir: str, fps: int = 2,
                  time_slice: str = ""):
    """video -> frames via ffmpeg (reference colmap2nerf.py run_ffmpeg:
    fps filter + optional between(t,a,b) time-slice select)."""
    os.makedirs(out_dir, exist_ok=True)
    vf = f"fps={fps}"
    if time_slice:
        start, end = time_slice.split(",")
        vf += f",select='between(t\\,{start}\\,{end})'"
    _run(["ffmpeg", "-i", video, "-qscale:v", "1", "-qmin", "1", "-vf", vf,
          os.path.join(out_dir, "%04d.png")])


def sharpness(path: str) -> float:
    """Variance-of-Laplacian sharpness score recorded per frame
    (reference colmap2nerf.py:110-113): lets downstream tooling drop
    motion-blurred video frames. numpy's form of the JAX script's
    `cv2.Laplacian(gray, CV_64F).var()`: the 4-neighbour kernel over the
    8-bit gray image with its border reflected (OpenCV's BORDER_REFLECT_101,
    numpy's "reflect"); the gray image is PIL's "L" conversion. OpenCV's
    PNG decoder converts to gray its own way (about half the pixels one
    level apart), so the score is within a few percent of the JAX
    script's, not equal to it. 0.0 for a file that does not read as an
    image."""
    from PIL import Image

    try:
        with Image.open(path) as im:
            img = np.asarray(im.convert("L"), np.float64)
    except OSError:
        return 0.0
    p = np.pad(img, 1, mode="reflect")
    lap = (p[:-2, 1:-1] + p[2:, 1:-1] + p[1:-1, :-2] + p[1:-1, 2:]
           - 4 * img)
    return float(lap.var())


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--images", default=None)
    p.add_argument("--video", default=None)
    p.add_argument("--out", required=True)
    p.add_argument("--fps", type=int, default=2)
    p.add_argument("--time_slice", default="",
                   help="'t1,t2' seconds window of the video to extract")
    p.add_argument("--skip_early", type=int, default=0,
                   help="skip this many frames from the start")
    p.add_argument("--sharpness", action="store_true",
                   help="record a variance-of-Laplacian score per frame")
    p.add_argument("--matcher", default=None,
                   choices=["exhaustive", "sequential"],
                   help="default: sequential for --video, exhaustive else")
    p.add_argument("--device", default=None,
                   help="'cpu' on a machine with no CUDA card")
    return p


def main(argv=None, *, device=None) -> dict:
    """-> the transforms written to <out>/transforms.json."""
    args = build_parser().parse_args(argv)
    resolve_device(device if device is not None else args.device)
    os.makedirs(args.out, exist_ok=True)
    images_dir = args.images or os.path.join(args.out, "images")
    matcher = args.matcher or ("sequential" if args.video else "exhaustive")
    if args.video:
        extract_video(args.video, images_dir, args.fps, args.time_slice)
    sparse = run_colmap(images_dir, args.out, matcher)
    tf = sparse_to_transforms(
        sparse, images_dir=images_dir if args.sharpness else None,
        skip_early=args.skip_early)
    with open(os.path.join(args.out, "transforms.json"), "w") as f:
        json.dump(tf, f, indent=1)
    print(f"wrote {args.out}/transforms.json ({len(tf['frames'])} frames)")
    return tf


if __name__ == "__main__":
    main()
