"""Is chip_smoke's phase C reproducible? Stage 1 of the CLI (and stage 3
after it) run several times with one seed, on the CUDA card.

Each run is a process of its own: the CLI (`sanerf_tpu_torch.apps.main`)
trains stage 1 on phase C's scene files at phase C's settings
(`chip_smoke.CLI_ARGS`, `CLI_SIZE`, `CLI_VIEWS`, `CLI_ITERS["rgb"]`, the
default `--seed`), recording the loss of every step and the validation
PSNRs; with `--mask`, stage 3 then trains from its checkpoint as phase C
does (`CLI_ITERS["mask"]`, `CLI_MASK_LR`) and the mIoU before and after is
recorded. The tool prints, for each run, its last PSNR (and mIoU), and for
each later run the first step whose loss differs from the first run's.

    python3 port_tools/stage1_repro.py [--runs 2] [--iters N] [--mask]
        [--tree DIR] [--deterministic] [--out FILE]

`--tree DIR` runs the `sanerf_tpu_torch` package of another tree (e.g. a
parent unpacked with `git archive <commit> sanerf_tpu_torch | tar -x -C
build/parent`). `--deterministic` runs each process under
`torch.use_deterministic_algorithms(True, warn_only=True)` and lists the
ops that warned: the ops with no deterministic CUDA implementation that
the step ran. The records go to OUT (default
build/stage1_repro.json). About 40 s a run of 1,000 steps, 30 s more with
`--mask`.
"""

import argparse
import json
import os
import re
import subprocess
import sys
import time
import warnings

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def one_run(out, tree, iters, mask, deterministic, size=None,
            device=None):
    """One process: stage 1 (and stage 3) of the CLI -> OUT (JSON)."""
    sys.path.insert(0, os.path.join(ROOT, "port_tools"))
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.abspath(tree))
    import shutil

    import torch

    import chip_smoke as cs
    from sanerf_tpu_torch.apps import main as cli
    from sanerf_tpu_torch.data.synthetic import SyntheticSphereDataset
    from sanerf_tpu_torch.train.mask_trainer import MaskTrainer
    from sanerf_tpu_torch.train.trainer import Trainer
    from scene_files import write_masks, write_transforms_scene

    import sanerf_tpu_torch
    rec = {"package": os.path.dirname(sanerf_tpu_torch.__file__),
           "iters": iters, "losses": [], "mask_eval": []}
    if deterministic:
        torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    base = out + ".d"
    shutil.rmtree(base, ignore_errors=True)
    size = size or cs.CLI_SIZE
    ds = SyntheticSphereDataset(H=size, W=size,
                                n_views=cs.CLI_VIEWS, scene="textured")
    scene = write_transforms_scene(ds, os.path.join(base, "scene"))
    write_masks(scene, "obj_masks", [f"r_{i}" for i in range(cs.CLI_VIEWS)],
                (ds.instances >= 2))
    orig_step = Trainer.train_step

    def train_step(self, sampler, num_rays):
        aux = orig_step(self, sampler, num_rays)
        rec["losses"].append(float(aux["loss"]))
        return aux

    Trainer.train_step = train_step
    ws1 = os.path.join(base, "ws_rgb")
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        tr1 = cli.main([scene, *cs.CLI_ARGS, "--workspace", ws1, "--iters",
                        str(iters), "--eval_cnt", "4"], device=device)
        if tr1.device.type == "cuda":
            torch.cuda.synchronize()
        rec["stage1_s"] = time.perf_counter() - t0
        Trainer.train_step = orig_step
        rec["val_psnr"] = [r["PSNRMeter"] for r in tr1.stats["results"]]
        if mask:
            orig_train = MaskTrainer.train
            orig_eval = MaskTrainer.evaluate_mask

            def mask_train(self, train_ds, valid_ds=None, *a, **k):
                self.evaluate_mask(valid_ds)
                return orig_train(self, train_ds, valid_ds, *a, **k)

            def mask_eval(self, *a, **k):
                v = orig_eval(self, *a, **k)
                rec["mask_eval"].append(v)
                return v

            MaskTrainer.train, MaskTrainer.evaluate_mask = mask_train, \
                mask_eval
            ck1 = tr1.ckpt_mgr.list_checkpoints()[-1]
            cli.main([scene, *cs.CLI_ARGS, "--workspace",
                      os.path.join(base, "ws_mask"), "--with_mask",
                      "--init_ckpt", ck1, "--mask_folder_name", "obj_masks",
                      "--iters", str(cs.CLI_ITERS["mask"]), "--lr",
                      cs.CLI_MASK_LR], device=device)
            MaskTrainer.train, MaskTrainer.evaluate_mask = orig_train, \
                orig_eval
    ops = set()
    for w in caught:
        m = re.search(r"^(\S+) does not have a deterministic implementation",
                      str(w.message))
        if m:
            ops.add(m.group(1))
    rec["nondeterministic_ops"] = sorted(ops)
    rec["mask_eval"] = [float(v) for v in rec["mask_eval"]]
    shutil.rmtree(base, ignore_errors=True)
    with open(out, "w") as f:
        json.dump(rec, f)


def first_difference(a, b):
    """The first step (1-based) whose losses differ, or None."""
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i + 1
    return None if len(a) == len(b) else min(len(a), len(b)) + 1


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--iters", type=int, default=None,
                    help="stage-1 steps (default: phase C's)")
    ap.add_argument("--mask", action="store_true",
                    help="also stage 3 from each run's stage 1")
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--deterministic", action="store_true")
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "stage1_repro.json"))
    ap.add_argument("--size", type=int, default=None,
                    help="image side (default: phase C's)")
    ap.add_argument("--device", default=None,
                    help="'cpu' for a rehearsal at a small --size")
    ap.add_argument("--one", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.iters is None:
        sys.path.insert(0, ROOT)
        import chip_smoke as cs
        args.iters = cs.CLI_ITERS["rgb"]
    if args.one:
        return one_run(args.one, args.tree, args.iters, args.mask,
                       args.deterministic, args.size, args.device)
    card = "cpu"
    if args.device != "cpu":
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True).stdout.strip()
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    runs = []
    for r in range(args.runs):
        path = f"{args.out}.run{r}"
        cmd = [sys.executable, os.path.abspath(__file__), "--one", path,
               "--tree", args.tree, "--iters", str(args.iters)]
        cmd += ["--size", str(args.size)] * bool(args.size)
        cmd += ["--device", args.device] * bool(args.device)
        cmd += ["--mask"] * args.mask + ["--deterministic"] * \
            args.deterministic
        subprocess.run(cmd, check=True, stdout=sys.stderr)
        with open(path) as f:
            runs.append(json.load(f))
        os.remove(path)
    summary = []
    for r, run in enumerate(runs):
        line = (f"run {r}: stage 1 {args.iters} steps "
                f"{run['stage1_s']:.1f} s, val PSNR {run['val_psnr']}")
        if run["mask_eval"]:
            line += f", stage 3 mIoU {run['mask_eval'][0]:.6f} -> " \
                    f"{run['mask_eval'][-1]:.6f}"
        if r:
            d = first_difference(runs[0]["losses"], run["losses"])
            run["first_differing_step"] = d
            line += (", losses equal to run 0's at every step" if d is None
                     else f", first loss differing from run 0's at step {d}")
        if run["nondeterministic_ops"]:
            line += f"; nondeterministic ops: {run['nondeterministic_ops']}"
        summary.append(line)
    with open(args.out, "w") as f:
        json.dump({"card": card, "tree": args.tree, "runs": runs,
                   "summary": summary}, f)
    for line in summary:
        print(line, "|", card, flush=True)


if __name__ == "__main__":
    main()
