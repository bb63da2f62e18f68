"""Guards of the port: it imports neither jax, nor the JAX package, nor
OpenCV, nor the JAX package's bench.py or tools/, and its entry points
default to the CUDA card and raise without one; the shipped assets/ stay as
committed."""

import ast
import hashlib
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
FORBIDDEN = ("jax", "jaxlib", "sanerf_tpu", "cv2", "bench", "tools")


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


A6 = ("parallel/__init__.py", "parallel/collectives.py", "parallel/dp.py",
      "parallel/multihost.py")


@pytest.mark.parametrize("rel", A6)
def test_parallel_modules_import_no_jax(rel):
    """The data-parallel slice's modules import neither jax nor the JAX
    package, and are walked with the rest of the port."""
    path = os.path.join(ROOT, "sanerf_tpu_torch", rel)
    assert path in _port_files()
    assert not set(_imported_roots(path)) & set(FORBIDDEN)


def test_parallel_entry_points_default_to_cuda():
    """A rank's device is the card unless the caller asks for the CPU, and
    a mesh needs a process group: no silent CPU, no silent 1-rank mesh."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is satisfiable")
    from sanerf_tpu_torch.parallel import dp, multihost

    with pytest.raises(RuntimeError, match="CUDA"):
        dp.local_device()
    assert dp.local_device("cpu").type == "cpu"
    assert multihost.default_backend("cpu") == "gloo"
    assert multihost.default_backend("cuda") == "nccl"
    with pytest.raises(RuntimeError, match="process group"):
        dp.make_mesh(2, "cpu")


TOOLS = ("__init__", "pack_asset", "eval_student", "hierarchy_gate",
         "quality_gate", "redistill_asset", "finetune_student",
         "serve_finetune", "mask_asset", "distill_serving",
         "import_checkpoint", "hw_parity", "probe_gather", "kbench",
         "two_stage_wall", "colmap2nerf")


@pytest.mark.parametrize("name", TOOLS)
def test_tools_modules_import_no_jax(name):
    """The asset pipeline's modules import neither jax, the JAX package,
    bench.py nor the JAX tools, and are walked with the rest of the
    port."""
    path = os.path.join(ROOT, "sanerf_tpu_torch", "tools", name + ".py")
    assert path in _port_files()
    assert not set(_imported_roots(path)) & set(FORBIDDEN)


def _tool_argv(tmp_path):
    ws, out = str(tmp_path / "ws"), str(tmp_path / "out")
    return {
        "pack_asset": [ws, "--out", out],
        "eval_student": [ws],
        "hierarchy_gate": [os.path.join(ws, "ckpt.npz")],
        "quality_gate": ["--workspace", ws],
        "redistill_asset": ["--out_workspace", out],
        "finetune_student": [ws],
        "serve_finetune": ["--workspace", ws],
        "mask_asset": ["--workspace", ws, "--out", out],
        "distill_serving": [".", "--workspace", ws, "--out_workspace", out],
        "import_checkpoint": [os.path.join(ws, "ngp.pth"), "--workspace",
                              out],
        "hw_parity": ["--rays", "8"],
        "probe_gather": [],
        "kbench": ["--rays", "8", "--t", "4"],
        "two_stage_wall": ["--quick", "--workspace", out],
        "colmap2nerf": ["--images", ws, "--out", out],
    }


@pytest.mark.parametrize("name", TOOLS[1:])
def test_tools_entry_points_default_to_cuda(tmp_path, name):
    """Every tool runs on the card unless given device="cpu"; without a
    card it raises before it reads or writes anything."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is satisfiable")
    import importlib

    tool = importlib.import_module(f"sanerf_tpu_torch.tools.{name}")
    with pytest.raises(RuntimeError, match="CUDA"):
        tool.main(_tool_argv(tmp_path)[name])
    assert not os.path.exists(tmp_path / "out.npz")
    assert not os.path.exists(tmp_path / "out")


#: sha256 of the shipped asset's files: no test and no tool run writes them
ASSET_SHA256 = {
    "serving_student.json":
        "140ccd46df59a961fd0bf43abe9ac4c38b3b31f16b49e6918b8f2bc18f0796e7",
    "serving_student.npz":
        "a02a18b41829fdb5b50febdeed38b5403bd812dcd992eaff3f6d8520b75913aa",
    "serving_student_mask.json":
        "732c26e5b6bae137ba8f1b667ce54371593c8783fc80338c1b669dd8fde0ec2e",
    "serving_student_mask.npz":
        "2dd4419988e92865707f9b116248c4a82775ae85f974aa08531718ab26007f4a",
}


def test_assets_unchanged():
    """The four files of assets/ are the committed ones, whatever order
    the tools' tests (each of which also holds them before and after
    itself, tests/test_torch_tools_*.py) ran in."""
    got = {}
    for name in ASSET_SHA256:
        with open(os.path.join(ROOT, "assets", name), "rb") as f:
            got[name] = hashlib.sha256(f.read()).hexdigest()
    assert got == ASSET_SHA256
