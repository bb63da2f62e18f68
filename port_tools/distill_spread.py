"""The spread of the import distillation's fidelity over hash-grid teachers.

    python3 port_tools/distill_spread.py [REPS [ITERS,...]]

On the card, from the repo root: writes chip_smoke's scene (the textured
fixture, CLI_VIEWS views of CLI_SIZE^2, as transforms.json), then REPS
times (default 4) trains a `--field_type hashgrid` teacher through the CLI
(CLI_ARGS, HASH_TEACHER_ITERS steps; its batches and atomics are not
deterministic, so each teacher differs) and distils it into chip_smoke's
DISTILL_STUDENT at each ITERS (default 1024) with DISTILL's sizes. One JSON
line a distillation: its seconds, `render_psnr` (the orbit of
`distill_to_mlp`) and the untrained student's, the student's PSNR against
the teacher on the scene's views and the untrained student's, the last
loss, the teacher's validation PSNR. Writes chiprun_out/distill_spread.json
and deletes its scene and workspaces.
"""

import contextlib
import json
import os
import shutil
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "port_tools"))


def main(argv):
    import torch

    import chip_smoke as cs
    from scene_files import write_transforms_scene
    from sanerf_tpu_torch.apps import main as cli
    from sanerf_tpu_torch.data.provider import SceneDataset
    from sanerf_tpu_torch.data.synthetic import SyntheticSphereDataset
    from sanerf_tpu_torch.models import fields, import_distill
    from sanerf_tpu_torch.ops import _build

    reps = int(argv[0]) if argv else 4
    iters_list = [int(v) for v in argv[1].split(",")] if len(argv) > 1 \
        else [1024]
    if not torch.cuda.is_available():
        sys.exit("distill_spread: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    dev = torch.device("cuda")
    base = os.path.join(ROOT, "build", "distill_spread")
    shutil.rmtree(base, ignore_errors=True)
    ds = SyntheticSphereDataset(H=cs.CLI_SIZE, W=cs.CLI_SIZE,
                                n_views=cs.CLI_VIEWS, scene="textured")
    scene = write_transforms_scene(ds, os.path.join(base, "scene"))
    out = []
    for rep in range(reps):
        with contextlib.redirect_stdout(sys.stderr):
            tr = cli.main([scene, *cs.CLI_ARGS, "--field_type", "hashgrid",
                           "--workspace", os.path.join(base, f"ws{rep}"),
                           "--iters", str(cs.HASH_TEACHER_ITERS),
                           "--eval_cnt", "1"])
        tm, tp = tr.model, tr.eval_params()
        views = SceneDataset(tr.cfg, "all")

        for iters in iters_list:
            sm = fields.make_model(import_distill.student_config(
                tm.cfg, **cs.DISTILL_STUDENT), tm.render_cfg)
            gen = torch.Generator(device=dev).manual_seed(0)
            torch.cuda.synchronize()
            t = time.perf_counter()
            sm, sp, report = import_distill.distill_to_mlp(
                tm, tp, gen, student_model=sm, render_check=2,
                render_hw=128, **dict(cs.DISTILL, iters=iters))
            torch.cuda.synchronize()
            dt = time.perf_counter() - t
            init = fields.init_params(sm, torch.Generator().manual_seed(
                gen.initial_seed()), dev)
            init["view_mlp"] = tp["view_mlp"]
            r = {"rep": rep, "iters": iters, "seconds": dt,
                 "render_psnr": report["render_psnr"],
                 "untrained_render_psnr": import_distill._render_fidelity(
                     tm, tp, sm, init, 2, 128, dev),
                 "views_psnr": cs.views_psnr(tm, tp, sm, sp, views, dev),
                 "untrained_views_psnr": cs.views_psnr(tm, tp, sm, init,
                                                       views, dev),
                 "loss_last": report["loss_history"][-1],
                 "teacher_val_psnr": tr.stats["results"][-1]["PSNRMeter"]}
            print(json.dumps(r), flush=True)
            out.append(r)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "distill_spread.json"),
              "w") as f:
        json.dump(out, f)
    shutil.rmtree(base, ignore_errors=True)


if __name__ == "__main__":
    main(sys.argv[1:])
