"""Parity: the port's asset-pipeline tools (sanerf_tpu_torch/tools/) against
the JAX tools (tools/*.py) on the CPU, on the same inputs: workspaces the
JAX package writes from seeded weights at small widths, and copies of the
shipped asset under tmp_path (no test writes assets/).

The JAX tools are sized as tests/test_import_tool.py and
tests/test_quality_gate.py size them: flags, and monkeypatched constructors
where a tool fixes a size itself (the held-out ring's 8 views become 2;
its 128^2 stays). Tolerances, each with its reason:
  - pack_asset: the npz's arrays and the json's configs equal (the same
    checkpoint's leaves, copied);
  - eval_student and hierarchy_gate: PSNR within 0.05 dB (the JSON lines,
    rounded to 3 places as both tools print them) and images within 2e-3
    (the renderer's parity bound against JAX, tests/test_torch_renderer.py);
  - quality_gate: the Configs equal field for field and the workspace
    names equal; a 2-iteration 16^2 run of each family gives a finite
    PSNR (draws differ between the frameworks, so scores are not
    compared);
  - finetune_student, serve_finetune and mask_asset: tiny runs finish;
    mask_asset's frozen leaves bit for bit the asset's and its saved leaf
    set JAX's; serve_finetune --pack writes only when the target PSNR
    rose.
"""

import dataclasses
import hashlib
import json
import os
import shutil
import sys

import jax
import numpy as np
import pytest
import torch

from sanerf_tpu import config as jconfig
from sanerf_tpu.data import synthetic as jsynthetic
from sanerf_tpu.models import fields as jfields
from sanerf_tpu.train import checkpoints as jckpt
from sanerf_tpu.train import metrics as jmetrics
from sanerf_tpu_torch import tools
from sanerf_tpu_torch.tools import (eval_student, finetune_student,
                                    hierarchy_gate, mask_asset, pack_asset,
                                    quality_gate, serve_finetune)
from sanerf_tpu_torch.train.checkpoints import CheckpointManager

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import tools.eval_student as jeval_student  # noqa: E402
import tools.hierarchy_gate as jhierarchy_gate  # noqa: E402
import tools.pack_asset as jpack_asset  # noqa: E402
import tools.quality_gate as jquality_gate  # noqa: E402

ASSET_FILES = ("serving_student.json", "serving_student.npz",
               "serving_student_mask.json", "serving_student_mask.npz")
#: a serving student at small widths, on the fixture's protocol
STUDENT_MC = dict(field_type="mlp", mlp_enc_freqs=4, mlp_field_width=16,
                  mlp_field_depth=3, mlp_cp_rank=4, mlp_cp_res=16,
                  mlp_sigma_cp_rank=2, mlp_sigma_cp_res=16,
                  mlp_prop_enc_freqs=2, mlp_prop_width=16, mlp_prop_depth=2,
                  prop_resolutions=(64, 128))
STUDENT_RC = dict(num_steps=(8, 4), bound=4.0, contract=True, min_near=0.5,
                  max_ray_batch=65536)
EVAL_VIEWS = 2
PSNR_TOL_DB = 0.05
IMAGE_TOL = 2e-3


def asset_digests():
    out = {}
    for f in ASSET_FILES:
        with open(os.path.join(ROOT, "assets", f), "rb") as fh:
            out[f] = hashlib.sha256(fh.read()).hexdigest()
    return out


@pytest.fixture(autouse=True)
def assets_untouched():
    """Every test here leaves the four files of assets/ as they were."""
    before = asset_digests()
    yield
    assert asset_digests() == before


def write_student_workspace(ws, seed=0, mc=STUDENT_MC, rc=STUDENT_RC):
    """A JAX-written student workspace: seeded params and EMA weights that
    differ from them, at step 0, with serving_meta.json."""
    jmc, jrc = jconfig.ModelConfig(**mc), jconfig.RenderConfig(**rc)
    params = jfields.init_params(jfields.make_model(jmc, jrc),
                                 jax.random.key(seed))
    ema = jax.tree_util.tree_map(lambda p: p * 0.9, params)
    jckpt.CheckpointManager(str(ws), name="ngp").save(
        0, params, ema_params=ema, full=False)
    with open(os.path.join(ws, "serving_meta.json"), "w") as f:
        json.dump({"model_config": dataclasses.asdict(jmc),
                   "render_config": dataclasses.asdict(jrc),
                   "teacher": "seeded", "report": {"iters": 0}}, f)
    return str(ws)


def asset_copy(dst, with_mask=False):
    """The shipped asset copied to dst (its path without the extension)."""
    names = ASSET_FILES if with_mask else ASSET_FILES[:2]
    for f in names:
        shutil.copy(os.path.join(ROOT, "assets", f),
                    os.path.join(os.path.dirname(dst),
                                 f.replace("serving_student",
                                           os.path.basename(dst))))
    return str(dst)


class _Recorder:
    """A PSNR meter that keeps the images it scores."""

    def __init__(self, base, store):
        self.base, self.store = base(), store

    def update(self, preds, truths):
        self.store.append(np.asarray(preds, np.float32).reshape(-1, 3))
        self.base.update(preds, truths)

    def __getattr__(self, name):
        return getattr(self.base, name)


@pytest.fixture
def fewer_views(monkeypatch):
    """The held-out ring at EVAL_VIEWS views in both frameworks."""
    real_j = jsynthetic.SyntheticSphereDataset
    real_t = tools.heldout_ring

    def jring(**kw):
        if kw.get("training") is False:
            kw["n_views"] = min(kw.get("n_views", 8), EVAL_VIEWS)
        return real_j(**kw)

    monkeypatch.setattr(jsynthetic, "SyntheticSphereDataset", jring)
    for mod in (tools, eval_student, hierarchy_gate, serve_finetune,
                mask_asset):
        monkeypatch.setattr(mod, "heldout_ring",
                            lambda H=128, n_views=8: real_t(
                                H, min(n_views, EVAL_VIEWS)), raising=False)


def record_psnr(monkeypatch, port_mod):
    """-> (JAX images, port images): every image each tool scores."""
    j, t = [], []
    jreal, treal = jmetrics.PSNRMeter, port_mod.PSNRMeter
    monkeypatch.setattr(jmetrics, "PSNRMeter", lambda: _Recorder(jreal, j))
    monkeypatch.setattr(port_mod, "PSNRMeter", lambda: _Recorder(treal, t))
    return j, t


# -- pack_asset ------------------------------------------------------------------

def test_pack_asset_matches_jax(tmp_path):
    ws = write_student_workspace(tmp_path / "ws")
    jout, tout = str(tmp_path / "jax_asset"), str(tmp_path / "port_asset")
    jpack_asset.main([ws, "--out", jout])
    assert pack_asset.main([ws], asset=tout, device="cpu") == tout
    with np.load(jout + ".npz") as a, np.load(tout + ".npz") as b:
        assert sorted(a.files) == sorted(b.files)
        assert all(k.startswith("params/") for k in b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k
    with open(jout + ".json") as f:
        jmeta = json.load(f)
    with open(tout + ".json") as f:
        tmeta = json.load(f)
    assert jmeta == tmeta


def test_pack_asset_output_loads(tmp_path):
    from sanerf_tpu_torch.models.asset import load_asset

    ws = write_student_workspace(tmp_path / "ws")
    out = pack_asset.main([ws], asset=str(tmp_path / "a"), device="cpu")
    mc, rc, params = load_asset(out, device="cpu")
    assert mc.mlp_cp_rank == STUDENT_MC["mlp_cp_rank"]
    assert rc.num_steps == STUDENT_RC["num_steps"]
    assert params["cp_lines"].shape == (3, 16, 4)


# -- eval_student and hierarchy_gate ---------------------------------------------

def test_eval_student_matches_jax(tmp_path, monkeypatch, fewer_views, capsys):
    ws = write_student_workspace(tmp_path / "ws")
    jimgs, timgs = record_psnr(monkeypatch, eval_student)
    jeval_student.main([ws])
    jlines = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    tres = eval_student.main([ws], device="cpu")
    tlines = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    assert tlines == tres and len(tres) == 3
    assert [r["num_steps"] for r in tres] == [[24, 16], [32, 24], [8, 4]]
    for j, t in zip(jlines, tlines):
        assert set(j) == set(t) and j["num_steps"] == t["num_steps"]
        assert abs(j["psnr"] - t["psnr"]) <= PSNR_TOL_DB, (j, t)
        assert abs(j["ssim"] - t["ssim"]) <= 2e-3, (j, t)
    assert len(jimgs) == len(timgs) == 3 * EVAL_VIEWS
    for a, b in zip(jimgs, timgs):
        np.testing.assert_allclose(b, a, atol=IMAGE_TOL)


def test_hierarchy_gate_matches_jax(tmp_path, monkeypatch, fewer_views,
                                    capsys):
    mc = dict(field_type="mlp", prop_resolutions=(128, 256),
              mlp_field_width=16, mlp_cp_rank=4, mlp_cp_res=16)
    params = jfields.init_params(jfields.make_model(
        jconfig.ModelConfig(**mc), jconfig.RenderConfig()),
        jax.random.key(3))
    ckpt = jckpt.CheckpointManager(str(tmp_path / "ws"), name="mlp").save(
        7, params, ema_params=jax.tree_util.tree_map(lambda p: 0 * p,
                                                     params), full=False)
    argv = [ckpt, "--width", "16", "--cp_rank", "4", "--cp_res", "16",
            "--H", "24", "--views", "2", "--hierarchies", "8,4", "6,4,2"]
    jimgs, timgs = record_psnr(monkeypatch, hierarchy_gate)
    jres = jhierarchy_gate.main(argv)
    capsys.readouterr()
    tres = hierarchy_gate.main(argv, device="cpu")
    out = capsys.readouterr().out.splitlines()
    assert [json.loads(l) for l in out[:2]] == [
        {**r, "num_steps": list(r["num_steps"])} for r in tres]
    for j, t in zip(jres, tres):
        assert j["num_steps"] == t["num_steps"]
        assert abs(j["psnr"] - t["psnr"]) <= PSNR_TOL_DB, (j, t)
    assert len(jimgs) == len(timgs) == 4
    for a, b in zip(jimgs, timgs):
        np.testing.assert_allclose(b, a, atol=IMAGE_TOL)
    # both score params/, not the EMA: all-zero weights render a flat 0.5
    assert np.ptp(timgs[0]) > 1e-3


# -- quality_gate ----------------------------------------------------------------

class _Captured(Exception):
    pass


QG_FLAGS = {
    "defaults": [],
    "grids": ["--mlp_width", "64", "--mlp_depth", "3", "--cp_rank", "8",
              "--cp_res", "64", "--cp_levels", "2", "--vm_rank", "4",
              "--vm_levels", "2", "--sigma_cp_rank", "4", "--sigma_vm_rank",
              "2", "--upsample_steps", "100", "200", "--l1", "1e-4",
              "--tv", "1e-3", "--anneal_iters", "50", "--grid_lr_mult", "5",
              "--no_native", "--resume", "--save_cnt", "3", "--lr", "1e-3",
              "--num_steps", "64", "32", "--H", "16", "--views", "4"],
}


def jax_run_family_inputs(monkeypatch, argv, fam):
    """(JAX's parsed args, the Config JAX's run_family trains) for argv."""
    from sanerf_tpu.train import trainer as jtrainer

    seen = {}

    def run_family(field_type, args, mlp_width=None):
        seen.setdefault("args", args)
        return {"field": field_type, "psnr": 0.0, "train_s": 0.0,
                "iters": args.iters}

    monkeypatch.setattr(jquality_gate, "run_family", run_family)
    jquality_gate.main(argv)
    monkeypatch.undo()

    def stub(name, cfg, model, **kw):
        raise _Captured(cfg)

    monkeypatch.setattr(jtrainer, "Trainer", stub)
    args = seen["args"]
    args.H, args.views = 16, 2  # the datasets run_family draws first
    with pytest.raises(_Captured) as e:
        jquality_gate.run_family(fam, args, mlp_width=args.mlp_width
                                 if fam == "mlp" else None)
    return seen["args"], e.value.args[0]


@pytest.mark.parametrize("fam", ["mlp", "hashgrid"])
@pytest.mark.parametrize("flags", sorted(QG_FLAGS))
def test_quality_gate_configs_match_jax(monkeypatch, capsys, flags, fam):
    argv = QG_FLAGS[flags]
    jargs, jcfg = jax_run_family_inputs(monkeypatch, argv, fam)
    args = quality_gate.build_parser().parse_args(argv)
    args.H, args.views = jargs.H, jargs.views
    assert vars(args) == vars(jargs)
    cfg = quality_gate.family_config(
        fam, args, args.mlp_width if fam == "mlp" else None)
    assert cfg.workspace == jcfg.workspace
    for section in ("model", "render", "train"):
        assert dataclasses.asdict(getattr(cfg, section)) == \
            dataclasses.asdict(getattr(jcfg, section)), section
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)


def test_quality_gate_runs_both_families(tmp_path, capsys):
    res = quality_gate.main(
        ["--iters", "2", "--H", "16", "--views", "4", "--num_rays", "64",
         "--num_steps", "8", "4", "--workspace", str(tmp_path)],
        device="cpu")
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines()
             if l.startswith("{")]
    assert [r["field"] for r in res] == ["mlp", "hashgrid"]
    assert lines == res
    for r in res:
        assert np.isfinite(r["psnr"]) and r["psnr"] > 0, r
        assert os.listdir(os.path.join(str(tmp_path), r["field"],
                                       "checkpoints"))


# -- finetune_student, serve_finetune, mask_asset --------------------------------

def test_finetune_student_saves_a_later_step(tmp_path, capsys):
    ws = write_student_workspace(tmp_path / "ws")
    out = finetune_student.main([ws, "--iters", "2", "--H", "16", "--views",
                                 "4", "--num_rays", "64"], device="cpu")
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == out
    assert np.isfinite(out["psnr"]) and out["finetune_iters"] == 2
    mgr = CheckpointManager(ws, name="ngp")
    steps = [os.path.basename(p) for p in mgr.list_checkpoints()]
    assert steps == ["ngp_step00000000.npz", "ngp_step00000002.npz"]
    a, _ = CheckpointManager.load_file(mgr.list_checkpoints()[0])
    b, meta = CheckpointManager.load_file(mgr.list_checkpoints()[1])
    assert meta["step"] == 2
    assert {k: v.shape for k, v in a.items() if k.startswith("params/")} == \
        {k: v.shape for k, v in b.items() if k.startswith("params/")}


def small_asset(tmp_path):
    """A packed asset of the seeded JAX student workspace."""
    ws = write_student_workspace(tmp_path / "ws_asset", seed=5)
    return pack_asset.main([ws], asset=str(tmp_path / "small"), device="cpu")


def _file_digest(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


@pytest.mark.parametrize("psnrs,packs", [((10.0, 9.5), False),
                                         ((10.0, 10.0), False),
                                         ((10.0, 10.5), True)])
def test_serve_finetune_packs_only_when_the_target_rose(
        tmp_path, monkeypatch, fewer_views, psnrs, packs):
    asset = small_asset(tmp_path)
    before = {e: _file_digest(asset + e) for e in (".npz", ".json")}
    scores = iter([psnrs[0], psnrs[1], 8.0])
    monkeypatch.setattr(serve_finetune, "_eval_psnr",
                        lambda *a, **k: next(scores))
    rep = serve_finetune.main(
        ["--iters", "2", "--H", "16", "--views", "4", "--num_rays", "64",
         "--workspace", str(tmp_path / "sf"), "--pack", "--steps", "8,4"],
        asset=asset, device="cpu")
    assert rep["pre"] == {"target": psnrs[0]}
    assert rep["post"] == {"target": psnrs[1], "full": 8.0}
    after = {e: _file_digest(asset + e) for e in (".npz", ".json")}
    assert (after != before) == packs
    if packs:
        with open(asset + ".json") as f:
            assert json.load(f)["provenance"]["serve_finetune"] == rep
        with np.load(asset + ".npz") as z:
            flat, _ = CheckpointManager.load_file(os.path.join(
                str(tmp_path / "sf"), "checkpoints",
                "sf_step00000002.npz"))
            assert sorted(z.files) == sorted(k for k in flat
                                             if k.startswith("params/"))
            for k in z.files:  # the EMA weights are what is packed
                np.testing.assert_array_equal(z[k], flat["ema/" + k[7:]])


def test_serve_finetune_runs(tmp_path, fewer_views, capsys):
    asset = small_asset(tmp_path)
    before = _file_digest(asset + ".npz")
    capsys.readouterr()
    rep = serve_finetune.main(
        ["--iters", "2", "--H", "16", "--views", "4", "--num_rays", "64",
         "--workspace", str(tmp_path / "sf"), "--pack"],
        asset=asset, device="cpu")
    lines = [l for l in capsys.readouterr().out.splitlines()
             if l.startswith("{")]
    assert json.loads(lines[0]) == {"pre": rep["pre"]}
    assert json.loads(lines[1]) == rep
    assert rep["steps"] == [32, 16]
    assert all(np.isfinite(v) for v in (*rep["pre"].values(),
                                        *rep["post"].values()))
    rose = rep["post"]["target"] > rep["pre"]["target"]
    assert (_file_digest(asset + ".npz") != before) == rose


def test_mask_asset_freezes_the_asset_and_matches_jax_leaves(
        tmp_path, monkeypatch, fewer_views):
    import bench
    import tools.mask_asset as jmask_asset
    from sanerf_tpu_torch.models.asset import load_mask_asset

    asset = small_asset(tmp_path)
    argv = ["--iters", "2", "--H", "16", "--views", "4", "--num_rays", "64"]
    # JAX: the asset through bench.py's loader, its workspace under tmp_path
    monkeypatch.setattr(bench, "ASSET", asset)
    real_cfg = jconfig.Config
    monkeypatch.setattr(jconfig, "Config", lambda **kw: real_cfg(
        **{**kw, "workspace": str(tmp_path / "jax_ws")}))
    jmask_asset.main(argv + ["--out", str(tmp_path / "jax_mask")])
    rec = mask_asset.main(argv + ["--workspace", str(tmp_path / "ws")],
                          asset=asset, device="cpu")
    with np.load(str(tmp_path / "jax_mask.npz")) as j, \
            np.load(asset + "_mask.npz") as t:
        assert sorted(j.files) == sorted(t.files)
        assert {k: j[k].shape for k in j.files} == \
            {k: t[k].shape for k in t.files}
    with open(str(tmp_path / "jax_mask.json")) as f:
        jrec = json.load(f)
    with open(asset + "_mask.json") as f:
        trec = json.load(f)
    assert set(jrec) == set(trec)
    assert jrec["model_config"] == trec["model_config"]
    assert trec["held_out_miou"] == rec["held_out_miou"]
    # the frozen leaves: bit for bit the asset's in the trainer's checkpoint
    ck = CheckpointManager(str(tmp_path / "ws"), name="mask_asset")
    flat, meta = CheckpointManager.load_file(ck.resolve("latest"))
    assert meta["step"] == 2
    with np.load(asset + ".npz") as z:
        assert sorted(rec["frozen"]) == sorted(k[7:] for k in z.files)
        for k in z.files:
            assert flat[k].tobytes() == z[k].tobytes(), k
    mc, _, params = load_mask_asset(asset, device="cpu")
    assert mc.with_mask and mc.n_inst == 5 and "m_field_mlp" in params


QG_TINY = ["--families", "mlp", "--H", "16", "--views", "4", "--num_rays",
           "64", "--num_steps", "8", "4", "--mlp_width", "16"]


def test_quality_gate_resume(tmp_path, capsys):
    """--resume restores the workspace's latest checkpoint (its step and
    epoch) before training, as JAX's: a rerun of a finished run trains no
    further step."""
    argv = QG_TINY + ["--iters", "2", "--workspace", str(tmp_path)]
    quality_gate.main(argv, device="cpu")
    quality_gate.main(argv + ["--resume"], device="cpu")
    log = capsys.readouterr().out
    assert "[ckpt] restored step 2 (mode=latest)" in log
    mgr = CheckpointManager(str(tmp_path / "mlp_w16"), name="mlp")
    assert [os.path.basename(p) for p in mgr.list_checkpoints()] == [
        "mlp_step00000002.npz"]


def test_quality_gate_resume_after_a_grid_resize_fails_as_in_jax(tmp_path):
    """ROADMAP C3, reproduced: a checkpoint written after a factorized-grid
    upsample does not resume (the state is built at the configured
    resolution and loaded before it is resized)."""
    argv = QG_TINY + ["--iters", "2", "--cp_rank", "4", "--cp_res", "16",
                      "--upsample_steps", "1", "--workspace", str(tmp_path)]
    quality_gate.main(argv, device="cpu")
    with pytest.raises(ValueError, match="reshape"):
        quality_gate.main(argv + ["--resume"], device="cpu")
