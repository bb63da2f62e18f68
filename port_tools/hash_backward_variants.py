"""Times the hash grid's table gradient, `hash_grid_backward` built from a
variant of csrc/hashgrid.cu, at the three launches of one full-width
hash-grid training step, beside the parent's route on the same inputs (a
zero gradient and one gather_rows_backward launch a level on the rows the
parent's glue made), one `index_add_` of the same adds and the plain
version; and the hash-grid training step of chip_smoke's T2 on this tree
or on a parent tree.

    python3 port_tools/hash_backward_variants.py NAME [NAME ...]
    python3 port_tools/hash_backward_variants.py step TREE [TREE ...]

(both need a CUDA card). NAME is "orig" for the source as it is or a key
of VARIANTS below (text substitutions in csrc/hashgrid.cu); each builds
into build/variants/<name>/ and runs in its own process, which prints one
JSON line: the card, the rate of vector atomic adds (port_tools/
red_probe.py), and chip_smoke's `hold_fused` sums and records of the
step's launches (medians and 10th / 90th percentiles of PROBE_REPS
interleaved launches queued behind a backlog). The step is
`ModelConfig(field_type="hashgrid")`, `RenderConfig()`, `TrainConfig()`
(8,192 rays) on the textured fixture, as chip_smoke's phase T3 drives it,
and T3's C = 8 launch (`s_grid_launch`). Compare variants within one
call, `orig` at both ends.

`step TREE`: `Trainer.train` of that hash-grid configuration on the
textured fixture, 2 epochs of 4 steps with 64^2 evaluation (chip_smoke's
T2), with TREE's own package ("." for this tree; a parent's port unpacked
first, e.g. `mkdir -p build/parent19 && git archive 30df9c1
sanerf_tpu_torch | tar -x -C build/parent19`): one JSON line per TREE with
the median step ms (host clock around a synchronised step, the first left
out), the runs, and `max_memory_allocated` over the run. Run parent,
change, change, parent.
"""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

VARIANTS = {
    # every grid level-major (all blocks on one level at a time)
    "level_major": [["constexpr long long kLevelMajorBytes = 16ll << 20;",
                     "constexpr long long kLevelMajorBytes = 0;"]],
    # every grid point-major (a thread's point through every level)
    "point_major": [["constexpr long long kLevelMajorBytes = 16ll << 20;",
                     "constexpr long long kLevelMajorBytes = 1ll << 62;"]],
    # no sums over a run of lanes in one cell
    "no_runs": [["constexpr long kRunAddsPerRow = 0;",
                 "constexpr long kRunAddsPerRow = 1L << 40;"]],
    # run sums only at levels of at least 8 / 32 / 128 adds a row
    **{f"runs{k}": [["constexpr long kRunAddsPerRow = 0;",
                     f"constexpr long kRunAddsPerRow = {k};"]]
       for k in (8, 32, 128)},
    # run sums at levels of at least 4 C / 16 C adds a row
    **{f"runs_c{k}": [["(B << D) >= kRunAddsPerRow * (long)lv.l[l].size",
                       f"(B << D) >= {k}L * C * (long)lv.l[l].size"]]
       for k in (4, 16)},
    # every channel in one pass over the corners (C = 8: 64 sums a lane)
    "group8": [["constexpr int kGroup = 4;", "constexpr int kGroup = 8;"]],
    # no corner pairs as one add
    "no_pair": [["constexpr bool kPairAdd = true;",
                 "constexpr bool kPairAdd = false;"]],
}


def one(name):
    import numpy as np
    import torch

    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "port_tools"))
    from kernel_variants import use_variant

    use_variant(name, {} if name == "orig" else
                {"hashgrid.cu": VARIANTS[name]})
    import red_probe
    from chip_smoke import (PROBE_REPS, hash_step, hold_fused,
                            record_fused, s_grid_launch)
    from sanerf_tpu_torch.config import ModelConfig, RenderConfig, TrainConfig
    from sanerf_tpu_torch.data.synthetic import SyntheticSphereDataset
    from sanerf_tpu_torch.models import fields
    from sanerf_tpu_torch.ops import _build
    from sanerf_tpu_torch.ops import gather as ga
    from sanerf_tpu_torch.ops import hashgrid as hg
    from sanerf_tpu_torch.train import state as st

    hg._lib()
    ptxas = [line.strip()[:160] for line in
             (_build.BUILD_DIR / "hashgrid.log").read_text().splitlines()
             if "registers" in line or "spill" in line]
    dev = torch.device("cuda")
    model = fields.make_model(ModelConfig(field_type="hashgrid"),
                              RenderConfig())
    tc = TrainConfig()
    n = st.adaptive_num_rays(tc, model.render_cfg.num_steps[-1])
    params = fields.init_params(model, torch.Generator().manual_seed(0), dev)
    ds = SyntheticSphereDataset(H=64, W=64, n_views=8, scene="textured")
    batch = {k: torch.as_tensor(v, device=dev) for k, v in
             ds.collate_train(np.random.default_rng(0), n).items()
             if isinstance(v, np.ndarray)}
    draws = st.draw_step(model, tc, n,
                         torch.Generator(device=dev).manual_seed(0), dev)
    _, seen = record_fused(
        hg, lambda: hash_step(model, tc, params, batch, draws))
    torch.cuda.synchronize()
    red = red_probe.rates(dev)
    tot, launches = hold_fused(hg, ga, seen, dev, red)
    _, c8 = hold_fused(hg, ga, [s_grid_launch(model, seen, dev)], dev, red)
    print(json.dumps({"variant": name, "card": torch.cuda.get_device_name(0),
                      "reps": PROBE_REPS, "red_probe_gadds_per_s": red,
                      "step": tot, "launches": launches, "s_grid_c8": c8[0],
                      "ptxas": ptxas}), flush=True)


def step(tree):
    """chip_smoke's T2 for the hash grid, on `tree`'s own package."""
    import statistics
    import tempfile
    import time

    tree = os.path.abspath(os.path.join(ROOT, tree))
    sys.path.insert(0, tree)
    import torch

    from sanerf_tpu_torch.config import Config, ModelConfig
    from sanerf_tpu_torch.data.synthetic import SyntheticSphereDataset
    from sanerf_tpu_torch.models import fields
    from sanerf_tpu_torch.train.trainer import Trainer

    import sanerf_tpu_torch
    assert os.path.dirname(os.path.dirname(sanerf_tpu_torch.__file__)) == tree
    dev = torch.device("cuda")
    textured = SyntheticSphereDataset(H=64, W=64, n_views=8, scene="textured")
    valid = SyntheticSphereDataset(H=64, W=64, n_views=2, scene="textured",
                                   training=False)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as ws:
        cfg = Config(workspace=ws, model=ModelConfig(field_type="hashgrid"))
        model = fields.make_model(cfg.model, cfg.render)
        tr = Trainer("t2", cfg, model, use_checkpoint="scratch", device=dev)
        step_ms, real_step = [], tr._train_step

        def timed(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = real_step(*a, **k)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t) * 1e3)
            return out

        tr._train_step = timed
        torch.cuda.reset_peak_memory_stats()
        with open(os.devnull, "w") as null:
            stdout, sys.stdout = sys.stdout, null
            try:
                tr.train(textured, valid_dataset=valid, max_epoch=2,
                         steps_per_epoch=4)
            finally:
                sys.stdout = stdout
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
    print(json.dumps({"tree": tree, "card": torch.cuda.get_device_name(0),
                      "step_ms_median": statistics.median(step_ms[1:]),
                      "step_ms_runs": step_ms,
                      "max_memory_allocated": peak}), flush=True)


def main():
    args = sys.argv[1:]
    if not args:
        sys.exit(__doc__)
    if args[0] in ("--one", "--step"):
        return (one if args[0] == "--one" else step)(args[1])
    import torch

    if not torch.cuda.is_available():
        sys.exit("hash_backward_variants: needs a CUDA card")
    kind, names = ("--step", args[1:]) if args[0] == "step" else (
        "--one", args)
    code = 0
    for name in names:
        r = subprocess.run([sys.executable, os.path.abspath(__file__), kind,
                            name], cwd=ROOT)
        code = code or r.returncode
    sys.exit(code)


if __name__ == "__main__":
    main()
