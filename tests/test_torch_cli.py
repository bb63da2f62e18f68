"""The port's CLI (sanerf_tpu_torch/apps/main.py) against the JAX CLI's
surface, and end to end on the CPU (`main(argv, device="cpu")`).

- `build_parser()`: every flag of the JAX parser with its name, default,
  choices, nargs and type; `config_from_args` gives the JAX Config for the
  same argv (compared as dicts);
- tests/test_apps.py:test_cli_end_to_end's drive (a transforms.json scene
  of the synthetic fixture, stage 1 then `--test`), then `--test` on the
  same cameras as a COLMAP model (`--data_type mip`), `--with_sam` from a
  tiny seeded SAM checkpoint in the official key layout (through
  `build_sam_predictor`, its ViT config shrunk), and `--with_mask` from
  per-view masks, both from the stage-1 checkpoint, whose leaves stay
  frozen;
- `--test --gui` writes the viewer's headless frames, `--gui` alone
  trains (as in the JAX CLI); `--n_devices 2` spawns two gloo ranks on the
  CPU, which train, evaluate and save the stage-1 checkpoint once.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from sanerf_tpu.apps import main as jmain
from sanerf_tpu_torch.apps import main as tmain
from sanerf_tpu_torch.data.synthetic import SyntheticSphereDataset
from sanerf_tpu_torch.models.sam import convert as sam_convert
from sanerf_tpu_torch.models.sam.image_encoder import ViTConfig
from sanerf_tpu_torch.train import checkpoints as ckpt_lib

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "port_tools"))
from scene_files import (write_colmap_scene, write_masks,  # noqa: E402
                         write_transforms_scene)

torch.set_num_threads(2)


def _actions(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.choices, a.nargs,
                     a.type, a.const, type(a).__name__)
            for a in parser._actions if a.dest != "help"}


def test_parser_has_the_jax_flags_and_defaults():
    """Every JAX flag as it is; the port's own (tmain.PORT_FLAGS:
    `--dist_backend`) beside them."""
    ref, got = _actions(jmain.build_parser()), _actions(tmain.build_parser())
    assert sorted(k for k in got if k not in tmain.PORT_FLAGS) == sorted(ref)
    for k in ref:
        assert got[k] == ref[k], k
    argv = ["scene"]
    args = vars(tmain.build_parser().parse_args(argv))
    assert all(args.pop(k) is None for k in tmain.PORT_FLAGS)
    assert args == vars(jmain.build_parser().parse_args(argv))


@pytest.mark.parametrize("argv", [
    [], ["--test", "--infer_num_steps", "64", "32"],
    ["--with_sam", "--init_ckpt", "c.npz", "--cache_size", "4"],
    ["--with_mask", "--mixed_sampling", "--error_map", "--n_inst", "3",
     "--lr", "5e-3", "--no-contract", "--bound", "2"],
    ["--field_type", "hashgrid", "--mlp_width", "64", "--cp_rank", "8",
     "--grid_upsample_steps", "10", "20", "--offset", "0.1", "0", "0"],
])
def test_config_from_args_equals_jax(argv):
    argv = ["scene"] + argv
    ref = jmain.config_from_args(jmain.build_parser().parse_args(argv))
    got = tmain.config_from_args(tmain.build_parser().parse_args(argv))
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)


def _tiny_sam_checkpoint(path):
    """A seeded SAM state dict in the official key layout for a tiny ViT
    (the default prompt encoder and decoder)."""
    vit = ViTConfig(img_size=64, patch_size=16, embed_dim=32, depth=2,
                    num_heads=2, window_size=2, global_attn_indexes=(1,))
    cfg = dataclasses.replace(sam_convert.sam_config_for("vit_b"), vit=vit)
    from tests.test_sam import _synthetic_torch_sd

    from sanerf_tpu.models.sam import convert as jconvert
    from sanerf_tpu.models.sam import image_encoder as jenc

    jcfg = dataclasses.replace(
        jconvert.sam_config_for("vit_b"),
        vit=jenc.ViTConfig(**dataclasses.asdict(vit)))
    sd = _synthetic_torch_sd(jcfg, np.random.default_rng(0))
    for k in sd:
        if sd[k].ndim >= 2 and k.endswith(".weight"):
            sd[k] = (sd[k] / np.sqrt(sd[k][0].size)).astype(np.float32)
        elif "pos" in k:
            sd[k] = (0.1 * sd[k]).astype(np.float32)
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    return cfg


def test_cli_end_to_end(tmp_path, monkeypatch):
    ds = SyntheticSphereDataset(H=32, W=32, n_views=8)
    root = write_transforms_scene(ds, str(tmp_path / "scene"))
    names = [f"r_{i}" for i in range(8)]
    write_masks(root, "obj_masks", names, ds.masks)
    ws = str(tmp_path / "ws")
    common = [root, "--data_type", "llff", "--num_steps", "12", "6",
              "--num_rays", "256", "--no-adaptive_num_rays",
              "--max_ray_batch", "4096", "--bound", "4"]
    tr = tmain.main(common + ["--workspace", ws, "--iters", "30",
                              "--eval_cnt", "1"], device="cpu")
    assert tr.global_step >= 30 and tr.device.type == "cpu"
    assert os.path.isdir(os.path.join(ws, "checkpoints"))
    with open(tr.log_path) as f:
        assert "[native loader]" in f.read()  # images, no near/far
    ckpt = tr.ckpt_mgr.list_checkpoints()[-1]

    tr = tmain.main(common + ["--workspace", ws, "--test", "--test_split",
                              "val"], device="cpu")
    results = os.listdir(os.path.join(ws, "results"))
    assert any(f.endswith("_rgb.png") for f in results)
    assert "pose_dir.json" in results
    psnr = tr.stats["results"][-1]["PSNRMeter"]

    # the same cameras and images as a COLMAP model
    croot = write_colmap_scene(ds, str(tmp_path / "colmap"),
                               np.random.default_rng(0).uniform(-.5, .5,
                                                                (20, 3)))
    tr = tmain.main([croot, "--data_type", "mip", "--enable_cam_center"]
                    + common[3:] + ["--workspace", ws, "--test"],
                    device="cpu")
    np.testing.assert_allclose(tr.stats["results"][-1]["PSNRMeter"], psnr,
                               atol=1e-3)

    # stage 2 from a tiny seeded checkpoint through build_sam_predictor
    sam_pth = str(tmp_path / "sam_tiny.pth")
    cfg = _tiny_sam_checkpoint(sam_pth)
    monkeypatch.setattr(sam_convert, "sam_config_for", lambda v: cfg)
    tr2 = tmain.main(common + [
        "--workspace", ws + "_sam", "--with_sam", "--init_ckpt", ckpt,
        "--sam_ckpt", sam_pth, "--online_resolution", "64",
        "--cache_size", "4", "--cache_interval", "2", "--iters", "24",
        "--lr", "5e-3"], device="cpu")
    assert tr2.teacher.params["image_encoder"]["pos_embed"].dtype == \
        torch.bfloat16
    assert tr2.cache.full() and tr2.global_step >= 24
    flat0 = ckpt_lib.CheckpointManager.load_file(ckpt)[0]
    flat2 = ckpt_lib.flatten_tree(tr2.state.params, "params/")
    for k, v in flat0.items():
        if k.startswith("params/"):
            np.testing.assert_array_equal(flat2[k], v, err_msg=k)
    assert any(k.startswith("params/samvit_mlp") for k in flat2)

    # stage 3 from the per-view masks
    tr3 = tmain.main(common + [
        "--workspace", ws + "_mask", "--with_mask", "--init_ckpt", ckpt,
        "--mask_folder_name", "obj_masks", "--iters", "24", "--lr", "5e-3"],
        device="cpu")
    flat3 = ckpt_lib.flatten_tree(tr3.state.params, "params/")
    for k, v in flat0.items():
        if k.startswith("params/"):
            np.testing.assert_array_equal(flat3[k], v, err_msg=k)
    assert tr3.global_step >= 24

    # --test of the mask model writes the masks
    tmain.main(common + ["--workspace", ws + "_mask", "--with_mask",
                         "--mask_folder_name", "obj_masks", "--test"],
               device="cpu")
    assert any(f.endswith("_mask.npy")
               for f in os.listdir(os.path.join(ws + "_mask", "results")))


def test_missing_sam_checkpoint_warns(tmp_path, capsys):
    cfg = tmain.config_from_args(tmain.build_parser().parse_args(
        ["scene", "--with_sam", "--sam_ckpt", str(tmp_path / "none.pth")]))
    assert tmain.build_sam_predictor(cfg, "cpu") is None
    assert "[WARN] SAM checkpoint" in capsys.readouterr().out


def test_refuses_what_the_port_lacks(tmp_path):
    """`--n_devices 2` no longer refuses: main spawns two gloo ranks (a
    FileStore in the workspace, removed after), rank 0 alone writes the
    log and the checkpoints, and main returns None once both have ended."""
    ds = SyntheticSphereDataset(H=16, W=16, n_views=4)
    root = write_transforms_scene(ds, str(tmp_path / "scene"))
    ws = str(tmp_path / "ws")
    got = tmain.main([root, "--data_type", "llff", "--num_steps", "8", "4",
                      "--num_rays", "128", "--no-adaptive_num_rays",
                      "--bound", "4", "--mlp_width", "16", "--mlp_depth",
                      "2", "--iters", "8", "--eval_cnt", "1", "--save_cnt",
                      "1", "--workspace", ws, "--n_devices", "2",
                      "--dist_backend", "gloo"], device="cpu")
    assert got is None
    with open(os.path.join(ws, "log_ngp.txt")) as f:
        log = f.read()
    assert "2 ranks (gloo)" in log and "[native loader]" in log
    assert log.count("[INFO] Trainer ngp") == 1  # rank 0's lines only
    assert os.listdir(os.path.join(ws, "checkpoints"))
    assert not [f for f in os.listdir(ws) if f.startswith(".dist_")]


GUI_ARGS = ["--data_type", "llff", "--bound", "4", "--num_steps", "8", "4",
            "--mlp_width", "16", "--mlp_depth", "2", "--num_rays", "128",
            "--no-adaptive_num_rays"]


def _gui_scene(tmp_path):
    ds = SyntheticSphereDataset(H=16, W=16, n_views=4)
    return write_transforms_scene(ds, str(tmp_path / "scene"))


def test_test_and_gui_write_headless_frames(tmp_path):
    """`--test --gui` opens the viewer on the workspace's checkpoint (JAX
    main.py:317-326); without dearpygui it writes 10 headless 512^2
    frames under <workspace>/gui_frames and renders no test split."""
    scene = _gui_scene(tmp_path)
    ws = str(tmp_path / "ws")
    tr0 = tmain.main([scene, *GUI_ARGS, "--workspace", ws, "--iters", "4"],
                     device="cpu")
    tr = tmain.main([scene, *GUI_ARGS, "--workspace", ws, "--test",
                     "--gui"], device="cpu")
    assert tr.global_step == tr0.global_step > 0  # the checkpoint's
    frames = sorted(os.listdir(os.path.join(ws, "gui_frames")))
    assert frames == [f"frame_{i:03d}.png" for i in range(10)]
    from sanerf_tpu_torch.utils.image import read_png

    assert read_png(os.path.join(ws, "gui_frames", frames[-1])).shape == \
        (512, 512, 3)
    assert not os.path.exists(os.path.join(ws, "results"))


def test_gui_without_test_trains(tmp_path):
    """`--gui` alone trains as if it were not there, as the JAX CLI does."""
    scene = _gui_scene(tmp_path)
    ws = str(tmp_path / "ws")
    tr = tmain.main([scene, *GUI_ARGS, "--workspace", ws, "--iters", "8",
                     "--gui"], device="cpu")
    assert tr.global_step >= 8
    assert os.path.isdir(os.path.join(ws, "checkpoints"))
    assert not os.path.exists(os.path.join(ws, "gui_frames"))


def test_scene_and_weight_writers_import_no_jax_cv2_or_pil():
    """chip_smoke's cli phase imports port_tools/scene_files.py and
    sam_weights.py: they stay on numpy, torch and the port."""
    import ast

    for name in ("scene_files.py", "sam_weights.py"):
        with open(os.path.join(ROOT, "port_tools", name)) as f:
            tree = ast.parse(f.read())
        roots = {a.name.split(".")[0] for n in ast.walk(tree)
                 if isinstance(n, ast.Import) for a in n.names}
        roots |= {n.module.split(".")[0] for n in ast.walk(tree)
                  if isinstance(n, ast.ImportFrom) and n.module}
        assert not roots & {"jax", "jaxlib", "sanerf_tpu", "cv2", "PIL"}, \
            (name, roots)
