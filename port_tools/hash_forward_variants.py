"""Times the hash grid's encode, `hash_grid_forward` built from a variant of
csrc/hashgrid.cu, at the launches of the hash-grid frames and of one
training step, each held bit for bit against its plain version.

    python3 port_tools/hash_forward_variants.py NAME [NAME ...]
    python3 port_tools/hash_forward_variants.py --compare NAME [NAME ...]

(needs a CUDA card). NAME is "orig" for the source as it is or a key of
VARIANTS below (text substitutions in csrc/hashgrid.cu); each builds into
build/variants/<name>/ and runs in its own process, which prints one JSON
line: the card, ptxas' registers and spills, and chip_smoke's
`hold_forward` sums and records (medians and 10th / 90th percentiles of
HASHGRID_REPS interleaved launches queued behind a backlog) at
  rgb      the 512^2 RGB render of chip_smoke's phase 10 (ModelConfig(
           field_type="hashgrid", with_sam=True), tables U(-TABLE_STD,
           TABLE_STD), bf16, (128, 64, 32)): 2 proposal grids and the field;
  rgb_f32  the same render with float32 tables (the Trainer's evaluation);
  feature  the frame's 32^2 feature render (the same 3 grids and the SAM
           grid, C = 8);
  step     the 3 launches of chip_smoke T3's training step (float32
           tables) and T3's C = 8 launch (s_grid_launch's points).
--compare also times the plain version and the parent's route (the level
route on the gather_rows kernel) beside each launch. Compare variants
within one call, `orig` at both ends. The variants' libraries are built
first, one nvcc each, all at once.
"""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_ROW = "  float* row = stage + threadIdx.x * rs;"
#: the first design's level-major order, measured against point-major
#: (2-2.5x slower at the frames; PERF.md, row 15f): items (level, tile), all
#: blocks on one level at a time, each thread storing its point's C floats
#: of the level
_LEVEL_MAJOR = """\
  for (long it = blockIdx.x; it < tiles * L; it += gridDim.x) {
    const int l = (int)(it / tiles);
    const long p = (it - l * tiles) * FWD_THREADS + threadIdx.x;
    const bool ok = load_point<D>(x, p, B, xs);
    float acc[C];
    level_features<D, C, ES>(table, xs, ok && l < n, lv.l[l < n ? l : 0],
                             align, smooth, acc);
    if (p < B) put_row<V, C>(out + p * LC + l * C, acc);
  }
  if (tiles >= 0) return;
"""

VARIANTS = {
    # every grid level-major (all blocks on one level at a time)
    "level_major": [[_ROW, _LEVEL_MAJOR + _ROW]],
    # no corner pairs as one load
    "no_pair": [["constexpr bool kPairLoad = true;",
                 "constexpr bool kPairLoad = false;"]],
    # slabs of 32 / 8 floats a point (the first design: 32)
    **{f"slab{k}": [["constexpr int FWD_SLAB = 16;",
                     f"constexpr int FWD_SLAB = {k};"]] for k in (8, 32)},
    # tiles of 256 points
    "threads256": [["constexpr int FWD_THREADS = 128;",
                    "constexpr int FWD_THREADS = 256;"]],
    # at most 32 registers a thread: 16 blocks of 128 an SM
    "occ16": [["__global__ void __launch_bounds__(FWD_THREADS)",
               "__global__ void __launch_bounds__(FWD_THREADS, 16)"]],
}


def forward_ptxas(log):
    """{kernel instance: its ptxas "Used ... registers" and spill lines}
    of the forward's instances in an nvcc -Xptxas -v log."""
    out, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if "hash_forward" in line else None
        elif name and ("registers" in line or "spill" in line):
            out.setdefault(name[-40:], []).append(line.split(":", 1)[-1]
                                                  .strip())
    return out


def one(name, compare):
    import numpy as np
    import torch

    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "port_tools"))
    from kernel_variants import use_variant

    use_variant(name, {} if name == "orig" else
                {"hashgrid.cu": VARIANTS[name]})
    import hashgrid_params as hp
    from chip_smoke import (HASHGRID_REPS, S_GRID_POINTS, hash_step,
                            hold_forward, record_forward)
    from sanerf_tpu_torch.config import ModelConfig, RenderConfig, TrainConfig
    from sanerf_tpu_torch.data.synthetic import SyntheticSphereDataset
    from sanerf_tpu_torch.models import fields, renderer
    from sanerf_tpu_torch.ops import _build
    from sanerf_tpu_torch.ops import gather as ga
    from sanerf_tpu_torch.ops import hashgrid as hg
    from sanerf_tpu_torch.train import state as st

    hg._lib()
    ptxas = forward_ptxas((_build.BUILD_DIR / "hashgrid.log").read_text())
    dev = torch.device("cuda")
    model = fields.make_model(ModelConfig(field_type="hashgrid",
                                          with_sam=True), RenderConfig())
    gen = torch.Generator().manual_seed(0)
    p32 = fields.init_params(model, gen, dev)
    p32["grid"] = hg.init_params(gen, model.grid_spec, hp.TABLE_STD, dev)
    p32["s_grid"] = hg.init_params(gen, model.s_grid_spec, hp.TABLE_STD, dev)
    for p, spec in zip(p32["prop"], model.prop_specs):
        p["grid"] = hg.init_params(gen, spec, hp.TABLE_STD, dev)
    p16 = fields.cast_params(p32, torch.bfloat16)
    rays = {s: tuple(torch.from_numpy(a).to(dev) for a in hp.frame_rays(s))
            for s in (512, 32)}
    out = {"variant": name, "card": torch.cuda.get_device_name(0),
           "reps": HASHGRID_REPS, "ptxas": ptxas}
    with torch.no_grad():
        for part, params, size, feats in (("rgb", p16, 512, False),
                                          ("rgb_f32", p32, 512, False),
                                          ("feature", p16, 32, True)):
            _, recs = record_forward(hg, lambda: renderer.run_rays(
                model, params, *rays[size], return_feats=feats))
            out[part] = hold_forward(hg, ga, recs, HASHGRID_REPS, compare)
            del recs
            torch.cuda.empty_cache()
    del p16, p32
    tmodel = fields.make_model(ModelConfig(field_type="hashgrid"),
                               RenderConfig())
    tc = TrainConfig()
    n = st.adaptive_num_rays(tc, tmodel.render_cfg.num_steps[-1])
    params = fields.init_params(tmodel, torch.Generator().manual_seed(0),
                                dev)
    ds = SyntheticSphereDataset(H=64, W=64, n_views=8, scene="textured")
    batch = {k: torch.as_tensor(v, device=dev) for k, v in
             ds.collate_train(np.random.default_rng(0), n).items()
             if isinstance(v, np.ndarray)}
    draws = st.draw_step(tmodel, tc, n,
                         torch.Generator(device=dev).manual_seed(0), dev)
    _, recs = record_forward(
        hg, lambda: hash_step(tmodel, tc, params, batch, draws))
    x8 = next(x for x, _, sp, _ in recs
              if sp == tmodel.grid_spec)[:S_GRID_POINTS].contiguous()
    s_spec = model.s_grid_spec
    t8 = torch.rand(s_spec.total_params, s_spec.level_dim, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(8))
    out["step"] = hold_forward(hg, ga, recs + [(x8, t8, s_spec, None)],
                               HASHGRID_REPS, compare)
    print(json.dumps(out), flush=True)


def prebuild(names):
    """Every named variant's hashgrid.cu and gather.cu built at once, one
    nvcc each."""
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "port_tools"))
    from kernel_variants import use_variant
    from sanerf_tpu_torch.ops import _build

    jobs = []
    for name in dict.fromkeys(names):
        csrc, build_dir = _build.CSRC, _build.BUILD_DIR
        use_variant(name, {} if name == "orig" else
                    {"hashgrid.cu": VARIANTS[name]})
        for src in ("hashgrid", "gather"):
            jobs.append((src, *_build._start(src, _build.CSRC,
                                             _build.BUILD_DIR)))
        _build.CSRC, _build.BUILD_DIR = csrc, build_dir
    for src, out, job in jobs:
        _build._finish(src, out, job)


def main():
    args = sys.argv[1:]
    if not args:
        sys.exit(__doc__)
    if args[0] == "--one":
        return one(args[1], args[2] == "1")
    import torch

    if not torch.cuda.is_available():
        sys.exit("hash_forward_variants: needs a CUDA card")
    compare = args[0] == "--compare"
    prebuild(args[compare:])
    code = 0
    for name in args[compare:]:
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--one", name, str(int(compare))], cwd=ROOT)
        code = code or r.returncode
    sys.exit(code)


if __name__ == "__main__":
    main()
