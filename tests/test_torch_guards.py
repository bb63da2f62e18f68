"""Guards of the port: it imports neither jax, nor the JAX package, nor
OpenCV, and its entry points default to the CUDA card and raise without
one."""

import ast
import os

import numpy as np
import pytest
import torch

from sanerf_tpu_torch.data.rays import full_frame_rays
from sanerf_tpu_torch.device import resolve_device
from sanerf_tpu_torch.apps.frame_pipeline import FramePipeline
from sanerf_tpu_torch.apps.interactive import InteractiveSession
from sanerf_tpu_torch.config import ModelConfig, RenderConfig
from sanerf_tpu_torch.models import fields
from sanerf_tpu_torch.models.asset import load_asset, load_mask_asset
from sanerf_tpu_torch.models.convert_nerf import convert_nerf_state_dict
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


@pytest.mark.parametrize("rel", ["sanerf_tpu_torch/ops/gather.py",
                                 "sanerf_tpu_torch/ops/hashgrid.py",
                                 "sanerf_tpu_torch/ops/encoding.py",
                                 "sanerf_tpu_torch/models/convert_nerf.py",
                                 "port_tools/hashgrid_params.py"])
def test_hashgrid_modules_import_no_jax(rel):
    """The hash-grid slice's modules, and the numpy param maker that the
    card's smoke run loads, import neither jax nor the JAX package."""
    path = os.path.join(ROOT, rel)
    roots = set(_imported_roots(path))
    assert not roots & set(FORBIDDEN), roots
    if rel.startswith("port_tools"):
        assert roots <= {"__future__", "typing", "numpy"}, roots
    else:
        assert path in _port_files()


def test_hashgrid_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is satisfiable")
    model = fields.make_model(ModelConfig(field_type="hashgrid"),
                              RenderConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        convert_nerf_state_dict({}, model)


A7 = ("apps/evaluation.py", "apps/sam_project.py", "apps/auto_generator.py",
      "apps/gui.py", "apps/batch.py", "apps/open_vocab.py",
      "models/import_distill.py")


def _top_level_roots(path):
    """The roots imported at module level (not inside a function)."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in tree.body:
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("rel", A7)
def test_apps_modules_import_no_jax_cv2_or_pil(rel):
    """The apps slice's modules: no jax, JAX package, OpenCV or PIL
    anywhere; transformers (the CLIP text tower) and dearpygui (the
    window) only inside the functions that need them."""
    path = os.path.join(ROOT, "sanerf_tpu_torch", rel)
    roots = set(_imported_roots(path))
    assert not roots & set(FORBIDDEN + ("PIL",)), roots
    assert not set(_top_level_roots(path)) & {"transformers", "dearpygui"}


def test_apps_entry_points_default_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is satisfiable")
    from sanerf_tpu_torch.apps import batch, open_vocab, sam_project
    from sanerf_tpu_torch.models import import_distill

    model = fields.make_model(ModelConfig(field_type="hashgrid"),
                              RenderConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        import_distill.distill_to_mlp(model, {})
    vocab = str(tmp_path / "v.npz")
    np.savez(vocab, p=np.ones(4, np.float32), object=np.ones(4, np.float32),
             things=np.ones(4), stuff=np.ones(4), texture=np.ones(4))
    argv = [str(tmp_path), "--workspace", str(tmp_path / "ws")]
    with pytest.raises(RuntimeError, match="CUDA"):
        sam_project.main(argv)
    with pytest.raises(RuntimeError, match="CUDA"):
        open_vocab.main(argv + ["--vocab", vocab, "--phrase", "p"])
    with pytest.raises(RuntimeError, match="CUDA"):
        batch.main(["eval-rgb", "--scenes", "s", "--data_root",
                    str(tmp_path)])
