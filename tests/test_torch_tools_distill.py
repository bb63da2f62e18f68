"""Parity: the port's distillation tools (sanerf_tpu_torch/tools/
redistill_asset, distill_serving, import_checkpoint) against the JAX tools
on the CPU, on the same inputs at small widths: a packed seeded student as
the teacher asset (a copy under tmp_path; no test writes assets/), a
JAX-written grid teacher workspace of the CLI's flags, and the synthetic
reference `.pth` of tests/test_convert_nerf.py, sized as
tests/test_import_tool.py sizes the JAX tool.

Draws differ between the frameworks (jax.random keys and torch
generators), so losses and fitted weights are not compared. Held:
  - `import_checkpoint --keep_hashgrid`: every array of the checkpoint bit
    for bit against JAX's;
  - the distilled outputs: serving_meta.json's configs equal to JAX's, the
    checkpoint's keys and shapes equal to JAX's, and the JAX package
    loads the port's checkpoint and renders it within 2e-3 of the port
    (the renderer's parity bound, tests/test_torch_renderer.py).
"""

import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sanerf_tpu import config as jconfig
from sanerf_tpu.apps import main as jcli
from sanerf_tpu.models import fields as jfields
from sanerf_tpu.models import renderer as jrenderer
from sanerf_tpu.train import checkpoints as jckpt
from sanerf_tpu_torch import config
from sanerf_tpu_torch.models import fields, renderer
from sanerf_tpu_torch.models.asset import params_from_jax
from sanerf_tpu_torch.tools import (distill_serving, import_checkpoint,
                                    pack_asset, redistill_asset)
from sanerf_tpu_torch.train.checkpoints import CheckpointManager

from tests.test_convert_nerf import MC, RC, _torch_sd
from tests.test_torch_tools_asset import (assets_untouched,  # noqa: F401
                                          write_student_workspace)

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import tools.distill_serving as jdistill_serving  # noqa: E402
import tools.import_checkpoint as jimport_checkpoint  # noqa: E402
import tools.redistill_asset as jredistill_asset  # noqa: E402

RENDER_TOL = 2e-3
#: a short fit: one epoch of 8 batches
FIT = ["2048", "256", "8"]


def read_json(path):
    with open(path) as f:
        return json.load(f)


def ckpt_shapes(path):
    flat, _ = CheckpointManager.load_file(path)
    return {k: v.shape for k, v in flat.items()}


def rays(n=64, seed=0):
    rng = np.random.default_rng(seed)
    o = rng.normal(0, 0.3, (n, 3)).astype(np.float32)
    d = rng.normal(0, 1, (n, 3)).astype(np.float32)
    return o, d / np.linalg.norm(d, axis=-1, keepdims=True)


def jax_renders_port_checkpoint(mc_dict, rc_dict, path):
    """The port's checkpoint loaded by the JAX package and by the port, and
    rendered by both on the same rays."""
    jmc = jconfig.config_from_dict(jconfig.ModelConfig, mc_dict)
    jrc = jconfig.config_from_dict(jconfig.RenderConfig, rc_dict)
    jm = jfields.make_model(jmc, jrc)
    flat, _ = jckpt.CheckpointManager.load_file(path)
    jp = jckpt.unflatten_like(jfields.init_params(jm, jax.random.key(0)),
                              flat, "params/")
    tmc = config.config_from_dict(config.ModelConfig, mc_dict)
    trc = config.config_from_dict(config.RenderConfig, rc_dict)
    tm = fields.make_model(tmc, trc)
    tparams = params_from_jax(CheckpointManager.load_file(path)[0], tm,
                              "cpu")
    o, d = rays()
    ref = jrenderer.run_rays(jm, jp, jnp.asarray(o), jnp.asarray(d))
    with torch.no_grad():
        got = renderer.run_rays(tm, tparams, torch.from_numpy(o),
                                torch.from_numpy(d))
    for k in ("image", "depth", "weights_sum"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=RENDER_TOL, atol=RENDER_TOL,
                                   err_msg=k)
    assert np.ptp(got["image"].numpy()) > 1e-3


# -- redistill_asset -------------------------------------------------------------

def test_redistill_asset_matches_jax(tmp_path, monkeypatch, capsys):
    import bench

    ws = write_student_workspace(tmp_path / "ws_teacher", seed=2)
    asset = pack_asset.main([ws], asset=str(tmp_path / "teacher"),
                            device="cpu")
    monkeypatch.setattr(bench, "ASSET", asset)
    argv = ["--points", FIT[0], "--batch", FIT[1], "--iters", FIT[2],
            "--cp_rank", "4", "--cp_res", "16", "--sigma_cp_rank", "2",
            "--sigma_cp_res", "16", "--width", "16", "--prop_width", "8"]
    jws, tws = str(tmp_path / "jax_ws"), str(tmp_path / "port_ws")
    jredistill_asset.main(argv + ["--out_workspace", jws])
    jout = json.loads(capsys.readouterr().out.splitlines()[-1])
    out = redistill_asset.main(argv + ["--out_workspace", tws], asset=asset,
                               device="cpu")
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("[redistill] teacher = asset: ")
    assert json.loads(lines[-1]) == out
    assert set(out) == set(jout) and set(out["losses"]) == set(jout["losses"])
    assert np.isfinite(out["render_psnr_vs_teacher"])
    assert set(out["losses"]) == {"field", "prop0", "prop1"}
    jmeta = read_json(os.path.join(jws, "serving_meta.json"))
    tmeta = read_json(os.path.join(tws, "serving_meta.json"))
    assert tmeta["model_config"] == jmeta["model_config"]
    assert tmeta["render_config"] == jmeta["render_config"]
    assert set(tmeta["report"]) == set(jmeta["report"])
    assert tmeta["teacher"] == asset
    jpath = CheckpointManager(jws, "ngp").resolve("latest")
    assert os.path.basename(out["checkpoint"]) == os.path.basename(jpath)
    assert ckpt_shapes(out["checkpoint"]) == ckpt_shapes(jpath)
    jax_renders_port_checkpoint(tmeta["model_config"],
                                tmeta["render_config"], out["checkpoint"])


# -- distill_serving -------------------------------------------------------------

GRID_TEACHER = ["--mlp_width", "16", "--mlp_depth", "3", "--cp_rank", "8",
                "--cp_res", "32", "--vm_rank", "4", "--vm_res", "16",
                "--sigma_cp_rank", "4", "--sigma_cp_res", "32",
                "--num_steps", "8", "4", "--bound", "4"]


def test_distill_serving_matches_jax(tmp_path, capsys):
    ws = str(tmp_path / "teacher_ws")
    flags = [".", "--workspace", ws, *GRID_TEACHER]
    jcfg = jcli.config_from_args(jcli.build_parser().parse_args(flags))
    jm = jfields.make_model(jcfg.model, jcfg.render)
    params = jfields.init_params(jm, jax.random.key(4))
    jckpt.CheckpointManager(ws, name="ngp").save(5, params,
                                                 ema_params=params,
                                                 full=False)
    serve = ["--distill_points", FIT[0], "--distill_batch", FIT[1],
             "--distill_iters", FIT[2], "--serve_cp_rank", "4",
             "--serve_cp_res", "16", "--serve_prop_width", "8",
             "--render_check", "1"]
    jws, tws = str(tmp_path / "jax_out"), str(tmp_path / "port_out")
    jdistill_serving.main(flags + serve + ["--out_workspace", jws])
    jout = json.loads(capsys.readouterr().out.splitlines()[-1])
    out = distill_serving.main(flags + serve + ["--out_workspace", tws],
                               device="cpu")
    lines = capsys.readouterr().out.splitlines()
    assert set(out) == set(jout) and set(out["losses"]) == set(jout["losses"])
    assert lines[0].startswith("[serve] teacher step 5 | grid tables ")
    assert json.loads(lines[-1]) == out
    assert out["family"] == "mlp-serving" and np.isfinite(out["render_psnr"])
    jmeta = read_json(os.path.join(jws, "serving_meta.json"))
    tmeta = read_json(out["meta"])
    for k in ("model_config", "render_config", "teacher_step"):
        assert tmeta[k] == jmeta[k], k
    assert set(tmeta["report"]) == set(jmeta["report"])
    assert tmeta["model_config"]["mlp_vm_rank"] == 0
    jpath = CheckpointManager(jws, "ngp").resolve("latest")
    assert ckpt_shapes(out["checkpoint"]) == ckpt_shapes(jpath)
    jax_renders_port_checkpoint(tmeta["model_config"],
                                tmeta["render_config"], out["checkpoint"])


# -- import_checkpoint -----------------------------------------------------------

SAM_MASK = dict(with_sam=True, sam_use_view_direction=True,
                s_grid_num_levels=4, s_grid_log2_hashmap=10,
                s_grid_desired_resolution=64, with_mask=True, n_inst=3)
SIZED = ("grid_num_levels", "grid_log2_hashmap", "grid_desired_resolution",
         "prop_num_levels", "prop_log2_hashmap", "prop_resolutions",
         "s_grid_num_levels", "s_grid_log2_hashmap",
         "s_grid_desired_resolution")


def sized(monkeypatch, jtool, ttool, mc):
    """Both tools build `mc`'s table sizes and RC in place of the
    reference-sized defaults (tests/test_import_tool.py:_tool_main)."""
    base = {f: getattr(mc, f) for f in SIZED}
    for tool, mcls, rc in ((jtool, jconfig.ModelConfig, RC),
                           (ttool, config.ModelConfig,
                            config.config_from_dict(
                                config.RenderConfig,
                                dataclasses.asdict(RC)))):
        monkeypatch.setattr(tool, "ModelConfig",
                            lambda mcls=mcls, **kw: mcls(**{**base, **kw}))
        monkeypatch.setattr(tool, "RenderConfig", lambda rc=rc, **kw: rc)


def write_pth(tmp_path, mc, with_sam=False, with_mask=False):
    model = jfields.make_model(mc, RC)
    sd = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
          _torch_sd(model, np.random.RandomState(0), with_sam=with_sam,
                    with_mask=with_mask).items()}
    path = str(tmp_path / "ngp_ep0100.pth")
    torch.save({"model": sd, "epoch": 100}, path)
    return path


@pytest.mark.parametrize("heads", ["rgb", "sam_mask"])
def test_import_keep_hashgrid_bit_for_bit(tmp_path, monkeypatch, capsys,
                                          heads):
    mc = MC if heads == "rgb" else dataclasses.replace(MC, **SAM_MASK)
    pth = write_pth(tmp_path, mc, heads != "rgb", heads != "rgb")
    sized(monkeypatch, jimport_checkpoint, import_checkpoint, mc)
    flags = ["--with_sam", "--sam_use_view_direction", "--with_mask",
             "--n_inst", "3"] if heads != "rgb" else []
    jimport_checkpoint.main([pth, "--workspace", str(tmp_path / "j"),
                             "--keep_hashgrid", *flags])
    capsys.readouterr()
    out = import_checkpoint.main([pth, "--workspace", str(tmp_path / "t"),
                                  "--keep_hashgrid", *flags], device="cpu")
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == out
    assert out["family"] == "hashgrid"
    a, ma = CheckpointManager.load_file(out["checkpoint"])
    b, mb = CheckpointManager.load_file(
        CheckpointManager(str(tmp_path / "j"), "ngp").resolve("latest"))
    assert ma["step"] == mb["step"] == 0
    assert sorted(a) == sorted(b)
    for k in b:
        assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k
    if heads != "rgb":
        assert "params/s_grid" in a and "params/m_grid" in a


def test_import_distills_like_jax(tmp_path, monkeypatch, capsys):
    mc = dataclasses.replace(MC, **SAM_MASK)
    pth = write_pth(tmp_path, mc, True, True)
    sized(monkeypatch, jimport_checkpoint, import_checkpoint, mc)
    argv = [pth, "--with_sam", "--sam_use_view_direction", "--with_mask",
            "--n_inst", "3", "--n_points", FIT[0], "--batch", FIT[1],
            "--iters", FIT[2], "--mlp_depth", "2", "--cp_rank", "4",
            "--cp_res", "16", "--render_check", "0"]
    jimport_checkpoint.main(argv + ["--workspace", str(tmp_path / "j")])
    jout = json.loads(capsys.readouterr().out.splitlines()[-1])
    out = import_checkpoint.main(argv + ["--workspace", str(tmp_path / "t")],
                                 device="cpu")
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == out
    assert set(out) == set(jout) and set(out["losses"]) == set(jout["losses"])
    assert out["copied_heads"] == jout["copied_heads"]
    assert out["iters"] == jout["iters"] == 8
    assert out["family"] == "mlp"
    assert out["copied_heads"] == ["view_mlp", "samvit_mlp", "samvit_norm",
                                   "mask_mlp"]
    assert set(out["losses"]) == {"field", "prop0", "prop1", "sam", "mask"}
    jpath = CheckpointManager(str(tmp_path / "j"), "ngp").resolve("latest")
    assert ckpt_shapes(out["checkpoint"]) == ckpt_shapes(jpath)
    from sanerf_tpu.models.import_distill import student_config

    smc = student_config(
        jconfig.ModelConfig(**{**{f: getattr(mc, f) for f in SIZED},
                               "field_type": "hashgrid", **SAM_MASK}),
        cp_rank=4, cp_res=16, depth=2)
    jax_renders_port_checkpoint(dataclasses.asdict(smc),
                                dataclasses.asdict(RC), out["checkpoint"])
