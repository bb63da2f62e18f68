"""Guards of the port: it imports neither jax, nor the JAX package, nor
OpenCV, and its entry points default to the CUDA card and raise without
one."""

import ast
import os

import pytest
import torch

from sanerf_tpu_torch.data.rays import full_frame_rays
from sanerf_tpu_torch.device import resolve_device
from sanerf_tpu_torch.apps.frame_pipeline import FramePipeline
from sanerf_tpu_torch.apps.interactive import InteractiveSession
from sanerf_tpu_torch.models.asset import load_asset, load_mask_asset
from sanerf_tpu_torch.models.sam.predictor import SamConfig, SamPredictor

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "sanerf_tpu", "cv2")


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(os.path.join(ROOT, "sanerf_tpu_torch")):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def test_port_imports_no_jax():
    files = _port_files()
    assert len(files) > 10 and os.path.exists(files[0])
    bad = [(os.path.relpath(p, ROOT), m) for p in files
           for m in _imported_roots(p) if m in FORBIDDEN]
    assert not bad, bad


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is satisfiable")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        full_frame_rays([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 2]],
                        [10.0, 10.0, 2.0, 2.0], 4, 4)
    asset = os.path.join(ROOT, "assets", "serving_student")
    with pytest.raises(RuntimeError, match="CUDA"):
        load_asset(asset)
    with pytest.raises(RuntimeError, match="CUDA"):
        load_asset(asset, with_sam=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        load_mask_asset(asset)
    with pytest.raises(RuntimeError, match="CUDA"):
        SamPredictor(SamConfig(), {})
    with pytest.raises(RuntimeError, match="CUDA"):
        FramePipeline(None, {}, None, None, 8, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        InteractiveSession(None, None, {})
    o, d = full_frame_rays([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 2]],
                           [10.0, 10.0, 2.0, 2.0], 4, 4, device="cpu")
    assert o.shape == d.shape == (16, 3) and o.device.type == "cpu"
