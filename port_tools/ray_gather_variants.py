"""Times `gather_rows` and `ray_level` built from a variant of
csrc/gather.cu and csrc/ray_kernels.cu, at the shapes of the served frames.

    python3 port_tools/ray_gather_variants.py VARIANTS NAME [PARTS]
    (needs a CUDA card)

VARIANTS is a JSON object {name: {source: [[old, new], ...] or "path"}}, a
source being "gather.cu" or "ray_kernels.cu": text substitutions in that
source, or a whole file in its place (for example the parent commit's,
unpacked with `git archive` into an ignored directory); or the path of a
Python file that defines such a dict as VARIANTS
(port_tools/ray_kernel_variants.py). NAME picks one, or is "orig" for the
sources as they are. PARTS, a comma-separated subset of gather, hashgrid,
ray_level, level0, flatten (default: all). A variant builds into
build/variants/<name>/; compare variants within one run on one card, one
process each. Prints the ptxas register and spill lines of the two
sources, then one JSON line:
  gather: at 2^21 seeded indices into a 2^19-row table (C = 2 float32 and
    bf16, C = 128 float32 on 4,096 rows, 8-row blocks), median / 10th / 90th
    percentile ms of 51 interleaved launches of the kernel and of
    torch.index_select, and whether the kernel is bit for bit its plain
    version;
  hashgrid: the 26 gathers of a 512^2 hash-grid RGB render, summed;
  ray_level: every launch of the 512^2 RGB frame of assets/serving_student
    at (32, 16) and (128, 64, 32), and those launches cut to their first
    16,384 and 1,024 rays (the 32^2 feature render), the same statistics of 21
    interleaved launches, and the largest difference from ray_level_plain
    (0.0 = bit for bit);
  level0: every ray_level0 launch shape of the served frames (the 512^2
    RGB frame's at T = 32 and 128, and those launches cut to the 1,024 rays
    of the 32^2 feature render);
  flatten: flatten3_nt against `x3.reshape(3, -1).clone()` at every
    [3, N, T] of those frames' levels (seeded normal values);
  both as median / 10th / 90th percentile ms of PROBE_REPS interleaved
    launches queued behind a backlog, with the largest difference from the
    plain version (0.0 = bit for bit).
"""

import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

sys.path.insert(0, os.path.join(ROOT, "port_tools"))

from chip_smoke import PROBE_REPS, interleaved_ms  # noqa: E402
from kernel_variants import load_variants, use_variant  # noqa: E402
from sanerf_tpu_torch.ops import _build  # noqa: E402
from sanerf_tpu_torch.ops import gather as ga  # noqa: E402
from sanerf_tpu_torch.ops import ray_kernels as rk  # noqa: E402

SIZE = 512
HIERARCHIES = {"32,16": (32, 16), "128,64,32": (128, 64, 32)}


def bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def gather_cases(dev):
    g = torch.Generator(device=dev).manual_seed(0)
    idx = torch.randint(0, 2 ** 19, (2 ** 21,), generator=g, device=dev,
                        dtype=torch.int32)
    t2 = torch.randn(2 ** 19, 2, generator=g, device=dev)
    t128 = torch.randn(4096, 128, generator=g, device=dev)
    out = {}
    for name, table, i, br in (
            ("C2 f32", t2, idx, 1), ("C2 bf16", t2.bfloat16(), idx, 1),
            ("C128 f32", t128, idx % 4096, 1),
            ("blk8 f32", t2, (idx[:2 ** 18] // 8).contiguous(), 8)):
        tv = table.reshape(table.shape[0] // br, br * table.shape[1])
        same = torch.equal(bits(ga.gather_rows(table, i, br)),
                           bits(ga.gather_rows_plain(table, i, br)))
        kern, lib = interleaved_ms([lambda: ga.gather_rows(table, i, br),
                                    lambda: torch.index_select(tv, 0, i)],
                                   51)
        out[name] = {"ms": kern, "library_ms": lib, "bit_for_bit": same}
    return out


def hashgrid_cases(dev):
    """The 26 gathers of a 512^2 RGB render of the hash-grid family
    (chip_smoke phase 10's model and tables): the sum over them of the
    kernel's and torch.index_select's medians of 11 interleaved launches,
    and whether every one is bit for bit."""
    import hashgrid_params as hp

    from sanerf_tpu_torch.config import ModelConfig, RenderConfig
    from sanerf_tpu_torch.models import fields, renderer
    from sanerf_tpu_torch.ops import hashgrid as hg

    model = fields.make_model(ModelConfig(field_type="hashgrid"),
                              RenderConfig())
    gen = torch.Generator().manual_seed(0)
    p32 = fields.init_params(model, gen, dev)
    p32["grid"] = hg.init_params(gen, model.grid_spec, hp.TABLE_STD, dev)
    for p, spec in zip(p32["prop"], model.prop_specs):
        p["grid"] = hg.init_params(gen, spec, hp.TABLE_STD, dev)
    params = fields.cast_params(p32, torch.bfloat16)
    o, d = (torch.from_numpy(a).to(dev) for a in hp.frame_rays(SIZE))
    calls, real = [], hg.gather_rows

    def spy(table, i, block_rows=1):
        calls.append((table, i))
        return real(table, i, block_rows)

    hg.gather_rows = spy
    try:
        renderer.run_rays(model, params, o, d)
    finally:
        hg.gather_rows = real
    out = {"launches": len(calls), "ms": 0.0, "library_ms": 0.0,
           "bit_for_bit": True}
    for table, i in calls:
        fi = i.reshape(-1)
        out["bit_for_bit"] &= torch.equal(
            bits(ga.gather_rows(table, i)), bits(ga.gather_rows_plain(table, i)))
        kern, lib = interleaved_ms([lambda: ga.gather_rows(table, i),
                                    lambda: torch.index_select(table, 0, fi)],
                                   11)
        out["ms"] += kern[0]
        out["library_ms"] += lib[0]
    return out


def frame_calls(dev, name):
    """{hierarchy: [(args, kwargs)]} of every call of the renderer's kernel
    `name` ("ray_level0" or "ray_level") in the 512^2 RGB frame of
    assets/serving_student at each hierarchy."""
    import dataclasses

    import numpy as np

    from sanerf_tpu_torch.data.rays import full_frame_rays
    from sanerf_tpu_torch.models import fields, renderer
    from sanerf_tpu_torch.models.asset import load_asset
    from sanerf_tpu_torch.utils.camera import fov_to_focal

    mc, rc, p32 = load_asset(os.path.join(ROOT, "assets", "serving_student"),
                             device=dev)
    params = fields.cast_params(p32, torch.bfloat16)
    focal = fov_to_focal(60.0, SIZE)
    pose = np.asarray([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 2.0],
                       [0, 0, 0, 1]], np.float32)
    o, d = full_frame_rays(pose, np.asarray([focal, focal, SIZE / 2,
                                             SIZE / 2], np.float32),
                           SIZE, SIZE, device=dev)
    real = getattr(renderer, name)
    calls = {}
    for h, steps in HIERARCHIES.items():
        model = fields.make_model(mc, dataclasses.replace(
            rc, num_steps=steps, max_ray_batch=SIZE * SIZE))

        def spy(*a, **k):
            calls.setdefault(h, []).append((a, k))
            return real(*a, **k)

        setattr(renderer, name, spy)
        try:
            renderer.render_frame(model, params, o, d, chunk=SIZE * SIZE)
        finally:
            setattr(renderer, name, real)
    return calls


def ray_cases(dev):
    out = {}
    for h, calls in frame_calls(dev, "ray_level").items():
        for li, (a, k) in enumerate(calls):
            for n in (a[0].shape[0], 16384, 1024):
                an = (a[0][:n].contiguous(), a[1][:n].contiguous(),
                      a[2][:n].contiguous(), *a[3:])
                got = rk.ray_level(*an, **k)
                ref = rk.ray_level_plain(*an, **k)
                err = max(float((x - y).abs().max()) for x, y in zip(got, ref))
                kern, = interleaved_ms([lambda: rk.ray_level(*an, **k)], 21)
                out[f"{h} launch {li} N={n} T0={a[1].shape[1]} T={a[3]} "
                    f"uniform={k.get('uniform_prev', False)}"] = {
                    "ms": kern, "max_abs_err": err}
                del got, ref
    return out


def level0_cases(dev):
    """ray_level0 at the served launch shapes (see the module's doc)."""
    out = {}
    for h, ((a, k),) in frame_calls(dev, "ray_level0").items():
        for n in (a[0].shape[0], 1024):
            an = (a[0][:n].contiguous(), *a[1:])
            got = rk.ray_level0(*an, **k)
            ref = rk.ray_level0_plain(*an, **k)
            err = max(float((x - y).abs().max()) for x, y in zip(got, ref))
            kern, = interleaved_ms([lambda: rk.ray_level0(*an, **k)])
            out[f"{h} N={n} T={a[1]}"] = {"ms": kern, "max_abs_err": err}
            del got, ref
    return out


def flatten_cases(dev):
    """flatten3_nt and its clone at the served [3, N, T] (see the module's
    doc)."""
    out = {}
    for steps in HIERARCHIES.values():
        for T in steps:
            for n in (SIZE * SIZE, 1024):
                g = torch.Generator(device=dev).manual_seed(n + T)
                x3 = torch.randn(3, n, T, generator=g, device=dev)
                same = torch.equal(rk.flatten3_nt(x3),
                                   rk.flatten3_nt_plain(x3))
                kern, lib = interleaved_ms(
                    [lambda: rk.flatten3_nt(x3),
                     lambda: x3.reshape(3, -1).clone()])
                out[f"3x{n}x{T}"] = {"ms": kern, "library_ms": lib,
                                     "bit_for_bit": same}
                del x3
    return out


CASES = {"gather": gather_cases, "hashgrid": hashgrid_cases,
         "ray_level": ray_cases, "level0": level0_cases,
         "flatten": flatten_cases}


def main():
    if not torch.cuda.is_available():
        sys.exit("ray_gather_variants: needs a CUDA card")
    variants, name = load_variants(sys.argv[1]), sys.argv[2]
    parts = sys.argv[3].split(",") if len(sys.argv) > 3 else list(CASES)
    use_variant(name, {} if name == "orig" else variants[name])
    logs = {}
    for src, lib in (("gather", ga._lib), ("ray_kernels", rk._lib)):
        lib()
        log = _build.BUILD_DIR / f"{src}.log"
        logs[src] = log.read_text() if log.exists() else ""
    for src, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                print("   ", src, line.strip()[:160])
    dev = torch.device("cuda")
    print(json.dumps({"variant": name,
                      **{p: CASES[p](dev) for p in parts}}), flush=True)


if __name__ == "__main__":
    main()
