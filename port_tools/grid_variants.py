"""Where the bf16 field kernels of the grid family (the V_GRID kernels of
csrc/fused_mlp_t.cu) spend their time on the card, and how they compare
with the design before them on the same launches.

    python3 port_tools/grid_variants.py            (needs a CUDA card)
    python3 port_tools/grid_variants.py NAME ...   (those variants only)

Before a call, unpack the port of the commit before V_GRID into PARENT
(`mkdir -p build/parent18 && git archive e154908 sanerf_tpu_torch | tar -x
-C build/parent18`): `grid_old` runs its own ops/fused_mlp_t.py (plan,
packing, C interface) on its own csrc. Builds every variant's copy of the
source first (build/variants/grid_<name>, one nvcc each, all started
together), then times each in a process of its own, `orig` (the source as
it is) and `grid_old` first and last. Each process prints one JSON line:
the ptxas register and spill lines of the bf16 V_SERVED kernels (the
asset's and the ladders' launches) and V_GRID kernels (tmlp_kernel and
both composite_kernel instances) and the kernels whose wgmmas ptxas
serialized (C7511 / C7520), for each launch of LAUNCHES the median and
10th / 90th percentile ms of REPS launches queued behind a backlog
(chip_smoke.interleaved_ms, the launches interleaved), a digest of its
outputs (equal digests: bit for bit equal), its plan, and at CHECKED the
largest |d| against the plain version and the outputs past chip_smoke's
GRID_TOL + GRID_TOL |ref|. `orig` also reads the rate at which the SMs
read small tables (l2_probe: port_tools/l2_probe.cu, 16-byte loads, four
consecutive ones at a pseudo-random 64-byte row, 8 in flight a thread,
8 blocks of 256 threads an SM, 256 loads a thread; through L2 alone, .cg,
and through L1 and L2, .ca; tables of 512 KB, about grid_student's 595
KB, and 4 MB; GB/s of the median of 5 rounds of 20 launches queued back
to back between two CUDA events, after a warm-up).

LAUNCHES: the composite of each 512^2 RGB frame of grid_student,
cp_ladder and vm_ladder (port_tools/grid_params.py, numpy-seeded bf16
weights) at (32, 16) and (128, 64, 32) (PERF.md section 6's row 4g),
grid_student's field through run_tmlp at 16,384 points drawn in its bounds
(the size of its interactive frame's field launch with tables, the
feature render's 32^2 rays at (32, 16): row 3g), and the asset's own
composite and first run_tmlp launch (its proposal net) at both
hierarchies (rows 4 and 3, which V_GRID leaves as they were). grid_student
takes V_GRID; the ladders, whose weights stream, keep V_SERVED
(ops/fused_mlp_t.py:_grid_net), so there the variants of the V_GRID
kernels change nothing.

VARIANTS (name -> (tree, text substitutions of its csrc/fused_mlp_t.cu,
plan constants of its ops/fused_mlp_t.py); a NAME joins variants of one
tree with "+"):
  orig            the source as it is;
  grid_old        the parent's design: each warpgroup encodes its tile,
                  then runs its chain, the weights all in shared memory
                  (grid_student) or one layer at a time, copied by the
                  whole block (the ladders);
  grid_no_tables  the encoders without the table reads (the Fourier
                  features alone; the grid columns stay zero);
  grid_no_chain   the consumers without their products (the ring's
                  handshakes, the activations, the epilogue);
  grid_serial     without the encoder's overlap: one slot a consumer, so
                  a consumer's next tile is encoded only once its chain
                  has read this one;
  grid_l1         plans of at most 164 KB of shared memory (SMEM_LIMIT;
                  V_GRID's: fewer stages), which leaves L1 92 KB for the
                  tables' rows;
  grid_no_epilogue the composites without their per-ray epilogue (the
                  rays' sums, the view head);
  grid_1c3e       one consumer warpgroup and three encoder warpgroups
                  (11 encoder warps; the consumer at 200 registers);
  grid_enc96      the encoders at 96 registers, the consumers at 160;
  grid_s4         at most four ring stages (the first plan's);
  sh_switch       every composite's epilogue as before V_GRID: the SH
                  component by a switch over k (a warp's lanes 0-15 on
                  divergent paths) and the ray's direction loaded where it
                  is used, not first;
  grid_trace      clock64() counters of block 0 (see _TR): per consumer
                  warpgroup its tiles and the clocks it waited for a
                  slot, ran its chain, (the composite) its epilogue, of
                  the chain waited for a weight unit, and of the
                  epilogue spent before the view head; per encoder warp
                  its tasks and the clocks it waited for a released slot
                  and encoded; "trace" in the JSON line (one launch a
                  launch key; its counters put branches among the
                  wgmmas, so its times are not the kernel's).
"""

import hashlib
import importlib.util
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "port_tools"))

#: the port of the commit before V_GRID (see the docstring)
PARENT = "build/parent18"
SIZE = 512
CONFIGS = ("grid_student", "cp_ladder", "vm_ladder")
HIERARCHIES = {"32,16": (32, 16), "128,64,32": (128, 64, 32)}
#: the launches also held against the plain version
CHECKED = ("3g grid_student 32,16", "4g grid_student 32,16",
           "4g cp_ladder 32,16", "4g vm_ladder 32,16")
REPS = 11

_ENC = ("    const float sg = encode_point<bf16, true>(\n"
        "        net, x, half,")
_MMA = ("    if constexpr (NW == 128)\n"
        "      wg::wgmma_ss_n128<0>(acc, da, db);\n"
        "    else if constexpr (NW == 64)\n      wg::wgmma_ss_n64<0>(acc, da, "
        "db);\n    else\n      wg::wgmma_ss_n16<0>(acc, da, db);")
_WGS = "constexpr int GRID_WGS = 2, GRID_ENC_WGS = 2;"
_REGS = "constexpr int GRID_ENC_REGS = 104,"
_EPI = "      for (int r = warp; r < rays_per_step; r += 4) {"
VARIANTS = {
    "orig": (".", [], {}),
    "grid_old": (PARENT, [], {}),
    "grid_no_tables": (".", [[_ENC, _ENC.replace("<bf16, true>",
                                                 "<bf16, true, false>")]],
                       {}),
    "grid_no_chain": (".", [[_MMA, "    if (false) {\n" + _MMA + "\n    }"]],
                      {}),
    "grid_serial": (".", [], {"GRID_SLOTS": 2}),
    "grid_l1": (".", [], {"SMEM_LIMIT": 164 * 1024}),
    "grid_no_epilogue": (".", [[_EPI, _EPI.replace("r < rays_per_step",
                                                   "r < 0 * rays_per_step")]],
                         {}),
    "grid_1c3e": (".", [[_WGS, "constexpr int GRID_WGS = 1, "
                                "GRID_ENC_WGS = 3;"]],
                  {"GRID_WGS": 1, "GRID_ENC_WGS": 3}),
    "grid_enc96": (".", [[_REGS, "constexpr int GRID_ENC_REGS = 96,"]], {}),
    "grid_s4": (".", [], {"GRID_STAGES": 4}),
    "sh_switch": (".", [
        ["  float v = 0.59004358992664352f * x * (-x2 + 3.0f * y2);\n",
         "  switch (k) {\n"
         "    case 0: return 0.28209479177387814f;\n"
         "    case 1: return -0.48860251190291987f * y;\n"
         "    case 2: return 0.48860251190291987f * z;\n"
         "    case 3: return -0.48860251190291987f * x;\n"
         "    case 4: return 1.0925484305920792f * xy;\n"
         "    case 5: return -1.0925484305920792f * yz;\n"
         "    case 6: return 0.94617469575755997f * z2 - 0.31539156525251999f;\n"
         "    case 7: return -1.0925484305920792f * xz;\n"
         "    case 8: return 0.54627421529603959f * x2 - "
         "0.54627421529603959f * y2;\n"
         "    case 9: return 0.59004358992664352f * y * (-3.0f * x2 + y2);\n"
         "    case 10: return 2.8906114426405538f * xy * z;\n"
         "    case 11: return 0.45704579946446572f * y * (1.0f - 5.0f * z2);\n"
         "    case 12: return 0.3731763325901154f * z * (5.0f * z2 - 3.0f);\n"
         "    case 13: return 0.45704579946446572f * x * (1.0f - 5.0f * z2);\n"
         "    case 14: return 1.4453057213202769f * z * (x2 - y2);\n"
         "    default: break;\n  }\n"
         "  float v = 0.59004358992664352f * x * (-x2 + 3.0f * y2);\n"],
        ["        if (H)\n#pragma unroll\n"
         "          for (int c = 0; c < 3; ++c) pdir[c] = "
         "rays8[n * 8 + 3 + c];\n", ""],
        ["          const float dx = pdir[0], dy = pdir[1], dz = pdir[2];\n",
         "          const float* rr = rays8 + n * 8;\n"
         "          const float dx = rr[3], dy = rr[4], dz = rr[5];\n"]],
        {}),
}
# grid_trace: grid_tr[row] = [count, waits, work, epilogue, unit waits,
# epilogue before the view head] summed over block 0's tiles: rows 0-3 its
# consumer warpgroups (tiles, clocks waiting for a full slot, in the chain,
# in the composite's epilogue, of the chain waiting for a weight unit, of
# the epilogue before its view head), rows 4-15 its encoder warps (tasks,
# clocks waiting for a released slot, encoding)
_TR = ("if (blockIdx.x == 0 && (threadIdx.x & 127) == 0) "
       "grid_tr[threadIdx.x >> 7]")
_TE = "if (blockIdx.x == 0 && lane == 0) grid_tr[4 + ew]"
VARIANTS["grid_trace"] = (".", [
    ['#include "wgmma.cuh"\n',
     '#include "wgmma.cuh"\n__device__ long long grid_tr[16][6];\n'],
    ["  int prev = r.stage;\n  wg::mbar_wait(r.full(), r.phase);\n",
     "  int prev = r.stage;\n"
     "  { const long long qw = clock64();\n"
     "    wg::mbar_wait(r.full(), r.phase);\n"
     f"    {_TR}[4] += clock64() - qw; }}\n"],
    ["    wg::mbar_wait(r.full(), r.phase);\n    wg::keep(acc);\n"
     "    wg::fence();\n    unit_products<NW>(acc, r, A, enc, k0,",
     "    { const long long qw = clock64();\n"
     "      wg::mbar_wait(r.full(), r.phase);\n"
     f"      {_TR}[4] += clock64() - qw; }}\n    wg::keep(acc);\n"
     "    wg::fence();\n    unit_products<NW>(acc, r, A, enc, k0,"],
    ["        __syncwarp();\n        if (H) {",
     "        __syncwarp();\n"
     f"        if (r == warp) {_TR}[5] += clock64() - tp0;\n"
     "        if (H) {"],
    ["    wg::mbar_wait(sl.full(sl.slot), sl.phase);\n    chain_wide(",
     "    const long long tq0 = clock64();\n"
     "    wg::mbar_wait(sl.full(sl.slot), sl.phase);\n"
     "    const long long tq1 = clock64();\n    chain_wide("],
    ["               warp, lane, park);\n    __syncwarp();\n"
     "    wg::count_add_if(sl.released(sl.slot), lane == 0);",
     "               warp, lane, park);\n"
     f"    {_TR}[0] += 1;\n    {_TR}[1] += tq1 - tq0;\n"
     f"    {_TR}[2] += clock64() - tq1;\n    __syncwarp();\n"
     "    wg::count_add_if(sl.released(sl.slot), lane == 0);"],
    ["    wg::count_wait(sl.released(s), 4u * (uint32_t)(q / sl.n));\n",
     "    const long long te0 = clock64();\n"
     "    wg::count_wait(sl.released(s), 4u * (uint32_t)(q / sl.n));\n"
     "    const long long te1 = clock64();\n"],
    ["    if (!half) sl.sig(s)[row] = sg;\n",
     "    if (!half) sl.sig(s)[row] = sg;\n"
     f"    {_TE}[0] += 1;\n    {_TE}[1] += te1 - te0;\n"
     f"    {_TE}[2] += clock64() - te1;\n"],
    [_EPI, "      const long long tp0 = clock64();\n" + _EPI],
    ["      wg_sync(wg);\n    }\n  }\n}\n",
     f"      {_TR}[3] += clock64() - tp0;\n"
     "      wg_sync(wg);\n    }\n  }\n}\n"],
    ["extern \"C\" int grids_size()",
     "extern \"C\" int grid_trace(long long* out, int reset) {\n"
     "  if (reset) {\n    long long z[96] = {};\n"
     "    return (int)cudaMemcpyToSymbol(grid_tr, z, sizeof(z));\n  }\n"
     "  return (int)cudaMemcpyFromSymbol(out, grid_tr, sizeof(grid_tr));\n}\n"
     "extern \"C\" int grids_size()"],
], {})
DEFAULT = [n for n in VARIANTS if n not in ("orig", "grid_old")]


def _tree(name):
    return VARIANTS[name.split("+")[0]][0]


def _prepare(name):
    """Points the build at the variant's copy of its tree's csrc and ->
    the fused_mlp_t module that launches it (the tree's own), its plan
    constants set."""
    from sanerf_tpu_torch.ops import _build
    from sanerf_tpu_torch.ops import fused_mlp_t as fm

    import kernel_variants as kv

    tree = _tree(name)
    if tree != ".":
        src = Path(ROOT) / tree / "sanerf_tpu_torch"
        if not src.is_dir():
            sys.exit(f"grid_variants: {tree} missing (see the docstring)")
        spec = importlib.util.spec_from_file_location(
            "tree_fused_mlp_t", src / "ops" / "fused_mlp_t.py")
        fm = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(fm)
        _build.CSRC = src / "csrc"
    subs, consts = [], {}
    for part in name.split("+"):
        subs += VARIANTS[part][1]
        consts.update(VARIANTS[part][2])
    if subs:
        kv.use_variant("grid_" + name, {"fused_mlp_t.cu": subs})
    else:
        _build.BUILD_DIR = Path(ROOT) / "build" / "variants" / (
            "grid_" + name) / "kernels"
    for k, v in consts.items():
        setattr(fm, k, v)
    return _build, fm


def _ptxas(log):
    """The register and spill lines of the bf16 tmlp_kernel and
    composite_kernel instances of V_SERVED (0) and V_GRID (3), and
    ptxas's advisories that it serialized their wgmma pipelines (C7511,
    C7520)."""
    tags = [f"13__nv_bfloat16Li{v}E" for v in (0, 3)]
    out, entry = [], None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)", line)
        if m:
            entry = m.group(1)
        elif (entry and "_kernelI" in entry and any(t in entry for t in tags)
              and ("registers" in line or "spill" in line)):
            out.append(f"{entry[:70]}: {line.strip()}")
        if ("C7511" in line or "C7520" in line) and any(t in line
                                                         for t in tags):
            kern = re.search(r"(tmlp|composite)_kernelI13__nv_bfloat16"
                             r"Li[03]E(Lb[01]E)?", line)
            out.append(f"serialized: {kern.group(0) if kern else line[:80]}")
    return out


def _as(fm, tm):
    """A TransposedFieldMLP of `fm` (the tree's module) with tm's weights
    and tables."""
    return fm.TransposedFieldMLP(
        [{"w": w} for w in tm.ws], tm.enc_freqs, tm.bound, tm.skip,
        leaky=tm.leaky, cp_lines=tm.cp or None,
        vm_planes=[p for p, _ in tm.vm] or None,
        vm_lines=[l for _, l in tm.vm] or None, sigma_cp_lines=tm.scp,
        sigma_vm_planes=tm.svm[0] if tm.svm else None,
        sigma_vm_lines=tm.svm[1] if tm.svm else None,
        angle_double=tm.angle_double)


def _view(fm, v):
    return fm.ViewMLP([{"w": v.w1}] + [{"w": w} for w in v.rest], v.geo + 1,
                      v.degree)


def _capture(dev):
    """[(launch, args, kwargs)] of LAUNCHES, captured from frames rendered
    with the kernels built from the source as it is (orig's build: the
    same points for every variant; a parent tree's module cannot render
    with this tree's fields)."""
    import dataclasses

    import numpy as np
    import torch

    import chip_smoke as cs
    import grid_params as gp
    from sanerf_tpu_torch.config import ModelConfig, RenderConfig
    from sanerf_tpu_torch.data.rays import full_frame_rays
    from sanerf_tpu_torch.models import fields, renderer
    from sanerf_tpu_torch.models.asset import (expected_shapes, load_asset,
                                               params_from_jax)
    from sanerf_tpu_torch.utils.camera import fov_to_focal

    out = []

    def composite_of(key, model, p, nets, o, d, tmlp_key=None):
        """The frame's composite launch under `key` (and its first
        run_tmlp launch under `tmlp_key`)."""
        seen = {}
        real = {n: getattr(fields, n) for n in ("run_tmlp",
                                               "run_tmlp_composite")}

        def spy(n):
            def wrapped(*a, **k):
                seen.setdefault(n, (a, k))
                return real[n](*a, **k)
            return wrapped

        for n in real:
            setattr(fields, n, spy(n))
        try:
            renderer.render_frame(model, p, o, d, chunk=SIZE * SIZE,
                                  nets=nets)
        finally:
            for n, f in real.items():
                setattr(fields, n, f)
        out.append((key, *seen["run_tmlp_composite"]))
        if tmlp_key:
            out.append((tmlp_key, *seen["run_tmlp"]))

    o, d = (torch.from_numpy(a).to(dev) for a in gp.frame_rays(SIZE))
    for name in CONFIGS:
        for h, steps in HIERARCHIES.items():
            model = fields.make_model(ModelConfig(**gp.CONFIGS[name]),
                                      RenderConfig(num_steps=steps,
                                                   max_ray_batch=SIZE * SIZE))
            p = fields.cast_params(params_from_jax(gp.make_flat(
                expected_shapes(model), cs.GRID_SEED), model, dev),
                torch.bfloat16)
            nets = fields.KernelNets(model, p)
            composite_of(f"4g {name} {h}", model, p, nets, o, d)
            if name == "grid_student" and h == "32,16":
                g = torch.Generator(device=dev).manual_seed(0)
                x = (torch.rand(3, 32 * 32 * 16, generator=g, device=dev)
                     * 2 - 1) * nets.field.bound
                out.append((f"3g {name} {h}", (x, nets.field),
                            {"transposed": True}))
    mc, rc, p32 = load_asset(os.path.join(ROOT, "assets", "serving_student"),
                             device=dev)
    p = fields.cast_params(p32, torch.bfloat16)
    focal = fov_to_focal(60.0, SIZE)
    ao, ad = full_frame_rays(np.asarray(cs.SERVE_POSE, np.float32),
                             np.asarray([focal, focal, SIZE / 2, SIZE / 2],
                                        np.float32), SIZE, SIZE, device=dev)
    for h, steps in HIERARCHIES.items():
        model = fields.make_model(mc, dataclasses.replace(
            rc, num_steps=steps, max_ray_batch=SIZE * SIZE))
        composite_of(f"4 asset {h}", model, p, fields.KernelNets(model, p),
                     ao, ad, f"3 asset {h}")
    torch.cuda.synchronize()
    return out


def _launches(fm, captured):
    """{launch: (fn, plain fn, plan)} of the captured launches, with fm's
    own field and view classes."""
    from sanerf_tpu_torch.ops import fused_mlp_t as this

    def conv(v):
        if isinstance(v, this.TransposedFieldMLP):
            return _as(fm, v)
        if isinstance(v, this.ViewMLP):
            return _view(fm, v)
        return v

    out = {}
    for key, a, k in captured:
        a = tuple(conv(v) for v in a)
        k = {kk: conv(v) for kk, v in k.items()}
        if key.startswith("3"):
            out[key] = ((lambda a=a, k=k: fm.run_tmlp(*a, **k)),
                        (lambda a=a, k=k: fm.run_tmlp_plain(
                            a[0] if k.get("transposed") else a[0].T, a[1])),
                        fm.kernel_plan(a[1]))
        else:
            # (xT, dl, ts, field) and fields.field_composite_T's keywords
            out[key] = ((lambda a=a, k=k: fm.run_tmlp_composite(*a, **k)),
                        (lambda a=a, k=k: fm.run_tmlp_composite_plain(*a,
                                                                      **k)),
                        fm.kernel_plan(a[3], a[1].shape[1], k["view"]))
    return out


def _l2_probe(dev, reps=20):
    """{table: {"l2_gbps", "l1_l2_gbps"}} of port_tools/l2_probe.cu (see
    the docstring)."""
    import ctypes
    import statistics

    import torch

    from sanerf_tpu_torch.ops import _build

    out, job = _build._start("l2_probe", Path(ROOT) / "port_tools",
                             Path(ROOT) / "build" / "variants" / "l2_probe")
    _build._finish("l2_probe", out, job)
    lib = ctypes.CDLL(str(out))
    lib.l2_probe.argtypes = [ctypes.c_void_p, ctypes.c_uint, ctypes.c_int,
                             ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                             ctypes.c_int, ctypes.c_void_p]
    lib.l2_probe.restype = ctypes.c_int
    blocks = torch.cuda.get_device_properties(dev).multi_processor_count * 8
    threads, iters = 256, 256
    sink = torch.empty(blocks * threads, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    res = {}
    for rows_log2, name in ((13, "512 KB"), (16, "4 MB")):
        table = torch.randint(0, 1 << 30, ((1 << rows_log2) * 16,),
                              dtype=torch.int32, device=dev)
        for l1, key in ((0, "l2_gbps"), (1, "l1_l2_gbps")):
            def launch():
                code = lib.l2_probe(table.data_ptr(), rows_log2, iters, l1,
                                    sink.data_ptr(), blocks, threads, stream)
                if code:
                    raise RuntimeError(f"l2_probe: CUDA error {code}")
            for _ in range(3):
                launch()
            ts = []
            for _ in range(5):
                a, b = (torch.cuda.Event(enable_timing=True)
                        for _ in range(2))
                torch.cuda.synchronize()
                a.record()
                for _ in range(reps):
                    launch()
                b.record()
                torch.cuda.synchronize()
                ts.append(a.elapsed_time(b) / reps)
            res.setdefault(name, {})[key] = (
                blocks * threads * iters * 16 / statistics.median(ts) / 1e6)
        del table
    return res


def one(name):
    import torch

    import chip_smoke as cs

    from sanerf_tpu_torch.ops import _build
    from sanerf_tpu_torch.ops import fused_mlp_t as this

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    # the launches' inputs, from frames on orig's build (made by main)
    _build.BUILD_DIR = Path(ROOT) / "build" / "variants" / "grid_orig" / \
        "kernels"
    captured = _capture(dev)
    _build._libs.pop("fused_mlp_t", None)
    this._lib.cache_clear()
    _build, fm = _prepare(name)
    t0 = time.perf_counter()
    fm._lib()
    build_s = time.perf_counter() - t0
    log = _build._lib_path("fused_mlp_t", _build.CSRC,
                           _build.BUILD_DIR).with_suffix(".log")
    cases = _launches(fm, captured)
    text = log.read_text() if log.exists() else ""
    res = {"variant": name, "build_s": build_s, "ptxas": _ptxas(text),
           "plan": {}, "ms": {}, "digest": {}, "plain": {}}
    if name == "orig":
        try:
            res["l2_probe"] = _l2_probe(dev)
        except Exception as e:  # the probe is not the kernels' measure
            res["l2_probe"] = {"error": str(e)[-2000:]}
    for key, (_, _, plan) in cases.items():
        res["plan"][key] = {k: getattr(plan, k) for k in (
            "variant", "wgs", "w_mode", "stages", "slots", "total", "general")
            if hasattr(plan, k)}
    lib = fm._lib()
    if hasattr(lib, "grid_trace"):  # grid_trace: one launch a launch key
        import ctypes

        lib.grid_trace.argtypes = [ctypes.c_void_p, ctypes.c_int]
        buf = (ctypes.c_longlong * 96)()
        res["trace"] = {}
        for key, (fn, _, _) in cases.items():
            fn()
            torch.cuda.synchronize()
            lib.grid_trace(None, 1)
            fn()
            torch.cuda.synchronize()
            lib.grid_trace(buf, 0)
            res["trace"][key] = [list(buf[6 * r:6 * r + 6]) for r in range(16)
                                 if buf[6 * r]]
    times = cs.interleaved_ms([c[0] for c in cases.values()], REPS)
    for key, t in zip(cases, times):
        res["ms"][key] = list(t)
    print(json.dumps({"variant": name, "ms": res["ms"]}), flush=True)
    for key, (fn, plain, _) in cases.items():
        out = fn()
        out = out if isinstance(out, tuple) else (out,)
        h = hashlib.sha256()
        for t in out:
            h.update(t.contiguous().cpu().numpy().tobytes())
        res["digest"][key] = h.hexdigest()[:16]
        if key in CHECKED:
            ref = plain()
            ref = ref if isinstance(ref, tuple) else (ref,)
            err, past = 0.0, 0
            for a, b in zip(out, ref):
                d = (a - b).abs()
                err = max(err, float(d.max()))
                past += int((d > cs.GRID_TOL + cs.GRID_TOL * b.abs()).sum())
            res["plain"][key] = {"max_abs_err": err, "past_grid_tol": past}
            del ref
        del out
        torch.cuda.empty_cache()
    print(json.dumps(res), flush=True)


def main(names):
    from sanerf_tpu_torch.ops import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    jobs = []
    csrc, bdir = _build.CSRC, _build.BUILD_DIR
    order = ["orig", "grid_old"] + names + ["grid_old", "orig"]
    for name in dict.fromkeys(order):
        _prepare(name)
        jobs.append(_build._start("fused_mlp_t", _build.CSRC,
                                  _build.BUILD_DIR))
        _build.CSRC, _build.BUILD_DIR = csrc, bdir
    t0 = time.perf_counter()
    built = set()
    for name, (out, job) in zip(dict.fromkeys(order), jobs):
        try:
            _build._finish("fused_mlp_t", out, job)
            built.add(name)
        except RuntimeError as e:
            print(json.dumps({"variant": name, "build": str(e)[-3000:]}),
                  flush=True)
    print(f"builds {time.perf_counter() - t0:.1f} s", flush=True)
    for name in (n for n in order if n in built):
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--one", name], capture_output=True, text=True,
                           timeout=600)
        sys.stdout.write(r.stdout)
        if r.returncode:
            print(json.dumps({"variant": name, "rc": r.returncode,
                              "stderr": r.stderr[-3000:]}), flush=True)


if __name__ == "__main__":
    if len(sys.argv) > 2 and sys.argv[1] == "--one":
        one(sys.argv[2])
    else:
        main(sys.argv[1:] or list(DEFAULT))
