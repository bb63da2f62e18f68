"""The port's two-stage wall clock (sanerf_tpu_torch/tools/two_stage_wall.py)
against the JAX tool (tools/two_stage_wall.py), on the CPU with a tiny
ViT and a few iterations: its flags and JSON keys are the JAX tool's
(read from its source with ast), `--resume` reuses a finished stage 1 and
asserts on a changed `--iters1`, and an interrupted stage 2 restarts from
its newest per-epoch checkpoint with its seconds summed across the calls
(the one departure from the JAX tool)."""

import ast
import json
import os

import pytest

from sanerf_tpu_torch.models.sam import SamConfig
from sanerf_tpu_torch.models.sam.image_encoder import ViTConfig
from sanerf_tpu_torch.tools import two_stage_wall as tsw
from sanerf_tpu_torch.train.distill import SamDistillTrainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_TOOL = os.path.join(ROOT, "tools", "two_stage_wall.py")
#: a ViT of SAM's layout at 64^2: windows, one global block, 256 channels
TINY = SamConfig(vit=ViTConfig(img_size=64, embed_dim=32, depth=2,
                               num_heads=2, global_attn_indexes=(1,),
                               window_size=2))
#: the smallest run of both stages: stage 1 of two steps, stage 2 of two
#: epochs of two steps (tsw.EPOCH set to 2)
ARGV = ["--iters1", "2", "--iters2", "4", "--H", "16", "--views", "4",
        "--online_resolution", "32"]


def _jax_tree():
    with open(JAX_TOOL) as f:
        return ast.parse(f.read())


def _jax_keys():
    """The keys of the JAX tool's json.dumps, in its order."""
    for node in ast.walk(_jax_tree()):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
                == "dumps" and node.args
                and isinstance(node.args[0], ast.Dict)):
            return [k.value for k in node.args[0].keys]
    raise AssertionError("no json.dumps of a dict in the JAX tool")


def test_json_keys_are_the_jax_tools():
    assert _jax_keys() == ["stage1_s", "stage1_iters", "stage2_s",
                           "stage2_iters", "stage2_it_s",
                           "teacher_ms_per_frame", "total_min",
                           "vs_v100_hours", "device"]


def test_flags_are_the_jax_tools():
    want = {}
    for node in ast.walk(_jax_tree()):
        if getattr(node, "func", None) is not None and getattr(
                node.func, "attr", "") == "add_argument":
            kw = {k.arg: k.value for k in node.keywords}
            want[node.args[0].value] = (
                kw["default"].value if "default" in kw else "store_true")
    got = {}
    for a in tsw.build_parser()._actions:
        if a.option_strings and a.option_strings[0] != "-h":
            got[a.option_strings[0]] = (
                "store_true" if a.const is True else a.default)
    # the JAX default is /tmp/two_stage; the port's is two_stage in the
    # temporary directory ($TMPDIR, else /tmp)
    assert got.pop("--workspace").endswith("two_stage")
    assert want.pop("--workspace") == "/tmp/two_stage"
    assert got == want


@pytest.fixture
def small_epochs(monkeypatch):
    monkeypatch.setattr(tsw, "EPOCH", 2)


def test_both_stages_then_resume(tmp_path, small_epochs, capsys):
    """A run of both stages prints the JAX tool's JSON line; `--resume`
    reuses its stage 1 (the stamp's seconds, no training) and its finished
    stage 2; a changed --iters1 fails the stamp's assertion."""
    ws = str(tmp_path / "ws")
    rec = tsw.main(ARGV + ["--workspace", ws], device="cpu",
                   sam_config=TINY)
    out = capsys.readouterr().out.strip().splitlines()
    assert json.loads(out[-1]) == rec
    assert list(rec) == _jax_keys()
    assert rec["stage1_iters"] == 2 and rec["stage2_iters"] == 4
    assert rec["device"] == "cpu" and rec["stage2_s"] > 0
    with open(os.path.join(ws, "s1_wall.json")) as f:
        s1 = json.load(f)
    with open(os.path.join(ws, "s2_wall.json")) as f:
        s2 = json.load(f)
    assert s1["iters1"] == 2 and s2["epochs_done"] == s2["epochs"] == 2

    again = tsw.main(ARGV + ["--workspace", ws, "--resume"], device="cpu",
                     sam_config=TINY)
    assert "[resume] stage 1 reused" in capsys.readouterr().out
    assert again["stage1_s"] == round(s1["stage1_s"], 1)
    assert again["stage2_s"] == round(s2["stage2_s"], 1)

    with pytest.raises(AssertionError, match="stamped stage-1 ran 2"):
        tsw.main(["--iters1", "3"] + ARGV[2:] + ["--workspace", ws,
                                                 "--resume"],
                 device="cpu", sam_config=TINY)


def test_interrupted_stage_2_resumes_and_sums(tmp_path, small_epochs,
                                              monkeypatch, capsys):
    """Stage 2 cut after its first epoch (its checkpoint and stamp
    written) restarts with --resume from that epoch, trains the second
    only, and reports the two calls' seconds summed."""
    ws = str(tmp_path / "ws")
    orig = SamDistillTrainer.train
    calls = []

    def cut(self, *a, **k):
        calls.append(self.epoch)
        if len(calls) == 2:
            raise KeyboardInterrupt("the call's time limit")
        return orig(self, *a, **k)

    monkeypatch.setattr(SamDistillTrainer, "train", cut)
    with pytest.raises(KeyboardInterrupt):
        tsw.main(ARGV + ["--workspace", ws], device="cpu", sam_config=TINY)
    with open(os.path.join(ws, "s2_wall.json")) as f:
        first = json.load(f)
    assert first["epochs_done"] == 1 and first["calls"] == 1

    monkeypatch.setattr(SamDistillTrainer, "train", orig)
    steps = []
    orig_step = SamDistillTrainer._student_step

    def step(self, *a, **k):
        steps.append(self.global_step)
        return orig_step(self, *a, **k)

    monkeypatch.setattr(SamDistillTrainer, "_student_step", step)
    rec = tsw.main(ARGV + ["--workspace", ws, "--resume"], device="cpu",
                   sam_config=TINY)
    out = capsys.readouterr().out
    assert "[resume] stage 1 reused" in out
    assert "[resume] stage 2 from epoch 1 of 2" in out
    assert steps == [3, 4]  # the second epoch's steps only
    with open(os.path.join(ws, "s2_wall.json")) as f:
        second = json.load(f)
    assert second["epochs_done"] == 2 and second["calls"] == 2
    assert second["stage2_s"] > first["stage2_s"]
    assert rec["stage2_s"] == round(second["stage2_s"], 1)
    assert rec["stage2_it_s"] == round(4 / second["stage2_s"], 2)
