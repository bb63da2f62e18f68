"""Where the chains of the nets wider than 128 (the bf16 V_WIDE kernels of
csrc/fused_mlp_t.cu, and with --f32 the float32 V_WIDE32 ones) spend their
time on the card, and how the designs with a ring of weight units compare
with the ones before them on the same launches.

    python3 port_tools/wide_variants.py            (needs a CUDA card)
    python3 port_tools/wide_variants.py NAME ...   (those variants only)
    python3 port_tools/wide_variants.py --f32 [NAME ...]

--f32 times the float32 launches (SHAPES_F32: PERF.md's float32 rows 3w
and 4w, the width-256 field's feature-render launch and 512^2 composites
with the Trainer's float32 weights' route) of `orig` and of F32_VARIANTS,
`orig` and `wide_f32_old` (the float32 design before the V_WIDE32 ring,
from PARENT_F32) first and last; the ptxas lines are then the V_WIDE32
kernels' (wide_f32_old: its float32 V_WIDE ones), and CHECKED_F32
launches are held at chip_smoke's F32_FAITHFUL (outputs past it counted).

Before a call, unpack the port of the commit before the bf16 ring into
PARENT (`mkdir -p build/parent17 && git archive 5cd2962 sanerf_tpu_torch |
tar -x -C build/parent17`), and for --f32 the one before the float32 ring
into PARENT_F32 (`mkdir -p build/parent_f32 && git archive 49eaa64
sanerf_tpu_torch | tar -x -C build/parent_f32`): their variants run their
own ops/fused_mlp_t.py (plan, packing, C interface) on their own csrc. Builds every variant's copy of the
source first (build/variants/wide_<name>, one nvcc each, all started
together), then times each in a process of its own, `orig` (the source as
it is) and `wide_old` first and last. Each process prints one JSON line:
the ptxas register and spill lines of the bf16 V_WIDE kernels (tmlp_kernel
and both composite_kernel instances) and the kernels whose wgmmas ptxas
serialized (its advisories C7511 / C7520), for each launch of
SHAPES the median and 10th / 90th percentile ms of REPS launches queued
behind a backlog (chip_smoke.interleaved_ms, the launches interleaved), a
digest of its outputs (equal digests: bit for bit equal), the bf16 plan
(warpgroups, ring stages), and at CHECKED the largest |d| against the
plain version and the outputs past chip_smoke's GRID_TOL + GRID_TOL |ref|.

VARIANTS (name -> (tree, text substitutions of its csrc/fused_mlp_t.cu,
or {file in csrc: substitutions}); a NAME joins variants of one tree with
"+"):
  orig             the source as it is;
  wide_old         the parent's design: the whole block copies each chunk
                   (or 64-column unit) of W^T from L2 into shared memory,
                   __syncthreads, then its products, waited on at once;
  wide_old_no_copy the parent without the copies (the products read
                   whatever the buffer holds);
  wide_old_no_chain the parent without the products (copies, encode,
                   epilogue);
  wide_no_chain    the ring without the products (unit_products' wgmma):
                   the consumers wait for each unit and release it;
  wide_no_copy     the ring without the copies: the producer marks each
                   stage full with no bytes in flight, the products read
                   whatever the ring holds;
  wide_2wg         two consumer warpgroups a block (three as it is);
  wide_no_encode   the tiles without their encode (the chain reads the
                   buffer as it is);
  wide_double_mma  each k step's wgmma issued twice (wrong sums; what the
                   products cost);
  wide_drain       each unit's products waited on before the next unit's
                   are issued (wgmma.wait_group 0, not 1);
  wide_trace       clock64() counters of block 0 (see _TR): per warpgroup
                   its tiles, and the clocks of their encode, chain, waits
                   for a stage, waits for the products and whole steps,
                   "trace" in the JSON line (one launch a shape).
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

#: the port of the commits before the bf16 and the float32 rings (see the
#: docstring)
PARENT, PARENT_F32 = "build/parent17", "build/parent_f32"
#: launch -> (field width, points of run_tmlp, or (rays, T) of the
#: composite): PERF.md section 6's rows 3w (the width-256 field of the
#: feature render of a 512^2 interactive frame), 4w (the width-256 512^2
#: RGB frames), 26-27 (widths 320 / 512, 64^2 at (128, 64, 32)), 28 (width
#: 512, 512^2 at (32, 16))
SHAPES = {
    "3w 32,16": (256, 32 * 32 * 16),
    "3w 128,64,32": (256, 32 * 32 * 32),
    "4w 32,16": (256, (512 * 512, 16)),
    "4w 128,64,32": (256, (512 * 512, 32)),
    "26 w320 64^2": (320, (64 * 64, 32)),
    "27 w512 64^2": (512, (64 * 64, 32)),
    "28 w512 32,16": (512, (512 * 512, 16)),
}
#: the launches also held against the plain version
CHECKED = ("3w 32,16", "3w 128,64,32", "26 w320 64^2", "27 w512 64^2")
REPS = 11
#: --f32: the float32 launches (as SHAPES): row 3w's feature-render field
#: launch and row 4w's 512^2 composites, width 256; widths 320 / 512 (one
#: consumer warpgroup) at 64^2
SHAPES_F32 = {
    "3w f32 32,16": (256, 32 * 32 * 16),
    "3w f32 128,64,32": (256, 32 * 32 * 32),
    "4w f32 32,16": (256, (512 * 512, 16)),
    "4w f32 128,64,32": (256, (512 * 512, 32)),
    "26 f32 w320 64^2": (320, (64 * 64, 32)),
    "27 f32 w512 64^2": (512, (64 * 64, 32)),
}
CHECKED_F32 = ("3w f32 32,16", "3w f32 128,64,32", "26 f32 w320 64^2",
               "27 f32 w512 64^2")

_COPY = ("  const int per_k = nw;  // 16-byte pieces of one k column: nw rows "
         "of 16 B\n  for (int i = threadIdx.x; i < (kb1 - kb0) * per_k; "
         "i += blockDim.x) {")
_SS = "  for (int s = 0; s < kA / 16; ++s) {\n    const int kc"
_TILE = ("  const float sg = encode_point<T, V != V_SERVED>(\n"
         "      net, x, lt & 1,\n"
         "      [&](int c, float v) { enc[enc_index<T>(row, c, pl.lde)] = "
         "fromf<T>(v); });")
_MMA = ("    if constexpr (NW == 128)\n      wg::wgmma_ss_n128<0>(acc, da, db);\n"
        "    else if constexpr (NW == 64)\n      wg::wgmma_ss_n64<0>(acc, da, "
        "db);\n    else\n      wg::wgmma_ss_n16<0>(acc, da, db);")
VARIANTS = {
    "orig": (".", []),
    "wide_old": (PARENT, []),
    "wide_old_no_copy": (PARENT, [[_COPY, _COPY.replace(
        "i < (kb1 - kb0) * per_k", "i < 0 * per_k")]]),
    "wide_old_no_chain": (PARENT, [[_SS, _SS.replace("s < kA / 16",
                                                     "s < 0 * kA")]]),
    "wide_no_chain": (".", [[_MMA, "    if (false) {\n" + _MMA + "\n    }"]]),
    "wide_no_copy": (".", [["        if (lane < nkb)\n          wg::bulk_copy(",
                            "        if (false)\n          wg::bulk_copy("],
                           ["if (lane == 0) wg::mbar_expect_tx(full, bytes);",
                            "wg::mbar_arrive_if(full, lane == 0);"]]),
    "wide_2wg": (".", [["constexpr int WIDE_WGS = 3, WIDE_F32_WGS = 2;",
                        "constexpr int WIDE_WGS = 2, WIDE_F32_WGS = 2;"]]),
    "wide_no_encode": (".", [[_TILE, "  const float sg = 0.0f * x[0];"]]),
    "wide_double_mma": (".", [[_MMA, _MMA + "\n" + _MMA]]),
    "wide_drain": (".", [["    wg::wait<1>();", "    wg::wait<0>();"]]),
}
# wide_trace: clocks of block 0's warpgroups, summed over their tiles into
# ring_tr[wg] = [tiles, encode, chain, waits on a full stage, waits on the
# products (wgmma.wait_group), the whole tile step with its output or
# epilogue], read back by ring_trace()
_TR = ("if (blockIdx.x == 0 && (threadIdx.x & 127) == 0) "
       "ring_tr[threadIdx.x >> 7]")
VARIANTS["wide_trace"] = (".", [
    ['#include "wgmma.cuh"\n',
     '#include "wgmma.cuh"\n__device__ long long ring_tr[4][6];\n'],
    ["  const int row = lt >> 1;\n  const float sg = encode_point",
     "  const int row = lt >> 1;\n  const long long tq0 = clock64();\n"
     "  const float sg = encode_point"],
    ["  if constexpr (ring_of<T>(V)) {\n    chain_wide(net, ring, pl, enc, "
     "reinterpret_cast<T*>(b.hb), acc,\n               has_sigma(net) ? "
     "b.sig : nullptr, outb, pl.ldo, warp, lane,\n               park);\n",
     "  if constexpr (ring_of<T>(V)) {\n    const long long tq1 = clock64();\n"
     "    chain_wide(net, ring, pl, enc, reinterpret_cast<T*>(b.hb), acc,\n"
     "               has_sigma(net) ? b.sig : nullptr, outb, pl.ldo, warp, "
     "lane,\n               park);\n    const long long tq2 = clock64();\n"
     f"    {_TR}[0] += 1;\n    {_TR}[1] += tq1 - tq0;\n"
     f"    {_TR}[2] += tq2 - tq1;\n"],
    ["    wg::mbar_wait(r.full(), r.phase);\n",
     "    { const long long q = clock64(); wg::mbar_wait(r.full(), "
     f"r.phase); {_TR}[3] += clock64() - q; }}\n"],
    ["    wg::wait<1>();\n",
     f"    {{ const long long q = clock64(); wg::wait<1>(); {_TR}[4] += "
     "clock64() - q; }\n"],
    ["  wg::wait<0>();\n  wg::keep(acc);\n  wg::mbar_arrive_if",
     f"  {{ const long long q = clock64(); wg::wait<0>(); {_TR}[4] += "
     "clock64() - q; }\n  wg::keep(acc);\n  wg::mbar_arrive_if"],
    ["    const long p0 = (base + (threadIdx.x >> 7)) * TILE;\n",
     "    const long p0 = (base + (threadIdx.x >> 7)) * TILE;\n"
     "    const long long tq = clock64();\n"],
    ["b.outb[p * pl.ldo + r];\n    }\n    __syncwarp();\n",
     "b.outb[p * pl.ldo + r];\n    }\n    __syncwarp();\n"
     f"    {_TR}[5] += clock64() - tq;\n"],
    ["    const long s = base + wg;\n",
     "    const long s = base + wg;\n    const long long tq = clock64();\n"],
    ["      wg_sync(wg);\n    }\n  }\n}\n",
     f"      wg_sync(wg);\n    }}\n    {_TR}[5] += clock64() - tq;\n  }}\n}}\n"],
    ["extern \"C\" int grids_size()",
     "extern \"C\" int ring_trace(long long* out, int reset) {\n"
     "  if (reset) {\n    long long z[24] = {};\n"
     "    return (int)cudaMemcpyToSymbol(ring_tr, z, sizeof(z));\n  }\n"
     "  return (int)cudaMemcpyFromSymbol(out, ring_tr, sizeof(ring_tr));\n}\n"
     "extern \"C\" int grids_size()"],
])
DEFAULT = [n for n in VARIANTS if n not in ("orig", "wide_old")]
# --f32 (chunk_units_f32 of csrc/fused_mlp_t.cu):
#   wide_f32_old     the design before the ring (PARENT_F32: float32
#                    V_WIDE, mma.sync 3xTF32, each unit of 64 columns
#                    copied by the whole block, then its products);
#   wide_f32_direct  the products summed into the chunk's accumulators
#                    themselves (no fresh accumulator, no float32 add, no
#                    drain but the chunk's last): faster, and how much
#                    larger an error against float64;
#   wide_f32_group2  a fresh accumulator every two units (16 columns),
#                    drained every six products; wide_f32_group4 and
#                    wide_f32_group16 every 32 and 128 columns;
#   wide_f32_no_chain the ring without the products (the wgmmas): the
#                    consumers wait for each unit and release it;
#   wide_f32_no_copy the ring without the copies (the producer marks each
#                    stage full with no bytes; the products read whatever
#                    the ring holds);
#   wide_f32_view_l2 the view head read through L2, not in shared memory
#                    (more ring stages where it took their room).
_F32_GROUP = "constexpr int F32_GROUP = 8;"
F32_VARIANTS = {
    "wide_f32_old": (PARENT_F32, []),
    "wide_f32_direct": (".", [
        [_F32_GROUP, "constexpr int F32_GROUP = 1 << 20;"],
        ["    uint32_t ex = unit_issue<NW, 1>(f, r, x, nw);",
         "    uint32_t ex = unit_issue<NW, 0>(acc, r, x, nw);"],
        ["    uint32_t ey = unit_issue<NW, 0>(f, r, y, nw);",
         "    uint32_t ey = unit_issue<NW, 0>(acc, r, y, nw);"],
        ["      ex = unit_issue<NW, 0>(f, r, x, nw);",
         "      ex = unit_issue<NW, 0>(acc, r, x, nw);"],
        ["      ey = unit_issue<NW, 0>(f, r, y, nw);",
         "      ey = unit_issue<NW, 0>(acc, r, y, nw);"],
        ["    wg::keep(f);\n    wg::keep(y);",
         "    wg::keep(acc);\n    wg::keep(y);"],
        ["    for (int i = 0; i < NW / 2; ++i) acc[i] += f[i];",
         "    for (int i = 0; i < 0; ++i) acc[i] += f[i];"]]),
    "wide_f32_group2": (".", [[_F32_GROUP, "constexpr int F32_GROUP = 2;"]]),
    "wide_f32_group4": (".", [[_F32_GROUP, "constexpr int F32_GROUP = 4;"]]),
    "wide_f32_group16": (".", [[_F32_GROUP,
                                "constexpr int F32_GROUP = 16;"]]),
    "wide_f32_no_chain": (".", [
        ["  if constexpr (NW == 128) {\n    wg::wgmma_tf32_n128",
         "  if constexpr (NW < 0) {\n    wg::wgmma_tf32_n128"],
        ["  } else if constexpr (NW == 64) {\n    wg::wgmma_tf32_n64",
         "  } else if constexpr (NW < 0) {\n    wg::wgmma_tf32_n64"],
        ["  } else {\n    wg::wgmma_tf32_n16",
         "  } else if constexpr (NW < 0) {\n    wg::wgmma_tf32_n16"]]),
    "wide_f32_no_copy": (".", [
        ["          wg::mbar_expect_tx(full, bytes);\n"
         "          wg::bulk_copy(wg::smem(f32_unit(r)), src, bytes, full);",
         "          wg::mbar_arrive_if(full, true);"]]),
    "wide_f32_view_l2": (".", []),
}
VARIANTS.update(F32_VARIANTS)
DEFAULT_F32 = [n for n in F32_VARIANTS if n != "wide_f32_old"]


def _tree(name):
    return VARIANTS[name.split("+")[0]][0]


def _subs(name):
    """{source file: substitutions} of `name` (a list alone is
    fused_mlp_t.cu's)."""
    out = {}
    for part in name.split("+"):
        subs = VARIANTS[part][1]
        for f, sub in (subs.items() if isinstance(subs, dict)
                       else [("fused_mlp_t.cu", subs)]):
            out.setdefault(f, []).extend(sub)
    return out


def _prepare(name):
    """Points the build at the variant's copy of its tree's csrc and ->
    the fused_mlp_t module that launches it (the tree's own)."""
    from sanerf_tpu_torch.ops import _build
    from sanerf_tpu_torch.ops import fused_mlp_t as fm

    import kernel_variants as kv

    tree = _tree(name)
    if tree != ".":
        src = Path(ROOT) / tree / "sanerf_tpu_torch"
        if not src.is_dir():
            sys.exit(f"wide_variants: {tree} missing (see the docstring)")
        spec = importlib.util.spec_from_file_location(
            "tree_fused_mlp_t", src / "ops" / "fused_mlp_t.py")
        fm = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(fm)
        _build.CSRC = src / "csrc"
    subs = _subs(name)
    if any(subs.values()):
        kv.use_variant("wide_" + name, subs)
    elif tree != ".":
        _build.BUILD_DIR = Path(ROOT) / "build" / "variants" / (
            "wide_" + name) / "kernels"
    if tree == "." and "wide_2wg" in name.split("+"):
        fm.WIDE_WGS = 2
    return _build, fm


def _ptxas(log, tag="13__nv_bfloat16Li2E"):
    """The register and spill lines of the bf16 V_WIDE kernels (`tag`; the
    V_WIDE32 ones with "IfLi4E"), and the advisories that ptxas serialized
    their wgmma pipelines (C7511, C7520: each wgmma waited on before the
    next is issued)."""
    out, entry = [], None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)", line)
        if m:
            entry = m.group(1)
        elif entry and tag in entry and (
                "registers" in line or "spill" in line):
            out.append(f"{entry[:70]}: {line.strip()}")
        if ("C7511" in line or "C7520" in line) and tag in line:
            kern = re.search(r"(tmlp|composite)_kernelI\w*?" + tag +
                             r"(Lb[01]E)?", line)
            out.append(f"serialized: {kern.group(0) if kern else line[:80]}"
                       f" ({line.split(')')[0].split('(')[-1]})")
    return out


def _nets(fm, width, dev, dtype=None):
    """The seeded field and view head of ModelConfig(mlp_field_width=width)
    (chip_smoke's phase B2 and L3 weights; bf16, or float32 with `dtype`),
    as fm's own classes."""
    import torch

    import grid_params as gp
    from sanerf_tpu_torch.config import ModelConfig, RenderConfig
    from sanerf_tpu_torch.models import fields
    from sanerf_tpu_torch.models.asset import expected_shapes, params_from_jax

    import chip_smoke as cs

    model = fields.make_model(ModelConfig(mlp_field_width=width),
                              RenderConfig())
    p = fields.cast_params(params_from_jax(gp.make_flat(
        expected_shapes(model), cs.GRID_SEED), model, dev),
        dtype or torch.bfloat16)
    kn = fields.KernelNets(model, p)
    f, v = kn.field, kn.view
    field = fm.TransposedFieldMLP(
        [{"w": w} for w in f.ws], f.enc_freqs, f.bound, f.skip,
        leaky=f.leaky, cp_lines=f.cp or None, sigma_cp_lines=f.scp,
        vm_planes=[a for a, _ in f.vm] or None,
        vm_lines=[b for _, b in f.vm] or None)
    view = fm.ViewMLP([{"w": v.w1}] + [{"w": w} for w in v.rest],
                      v.geo + 1, v.degree)
    return field, view


def one(name, f32=False):
    import torch

    import chip_smoke as cs

    _build, fm = _prepare(name)
    t0 = time.perf_counter()
    fm._lib()
    build_s = time.perf_counter() - t0
    log = _build.BUILD_DIR / "fused_mlp_t.log"
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    shapes, checked = (SHAPES_F32, CHECKED_F32) if f32 else (SHAPES, CHECKED)
    nets = {w: _nets(fm, w, dev, torch.float32 if f32 else None)
            for w in sorted({w for w, _ in shapes.values()})}
    res = {"variant": name, "build_s": build_s,
           "ptxas": (_ptxas(log.read_text(), "13__nv_bfloat16Li2E"
                            if not f32 else "IfLi2E" if _tree(name) ==
                            PARENT_F32 else "IfLi4E")
                     if log.exists() else []),
           "plan": {}, "ms": {}, "digest": {}, "plain": {}}
    if name == "wide_f32_view_l2":  # every plan with the view head in L2
        make = fm._make_plan
        fm._make_plan = lambda *a, **k: make(*a[:12], False, *a[13:], **k)
    fns = {}
    for key, (width, shape) in shapes.items():
        field, view = nets[width]
        if isinstance(shape, int):
            x = (torch.rand(3, shape, generator=g, device=dev) * 4 - 2)
            args = ("run_tmlp", (x, field), {"transposed": True})
            plan = fm.kernel_plan(field)
        else:
            N, T = shape
            x = torch.rand(3, N * T, generator=g, device=dev) * 4 - 2
            dl = torch.rand(N, T, generator=g, device=dev) * 0.05
            ts = torch.cumsum(dl, 1) + 0.5
            d = torch.randn(N, 3, generator=g, device=dev)
            r8 = torch.cat([torch.zeros_like(d), d, torch.zeros(
                N, 2, device=dev)], 1).contiguous()
            args = ("run_tmlp_composite", (x, dl, ts, field, True),
                    {"view": view, "rays8": r8})
            plan = fm.kernel_plan(field, T, view)
        kern = getattr(fm, args[0])
        plain = getattr(fm, args[0] + "_plain")
        fns[key] = (lambda k=kern, a=args: k(*a[1], **a[2]),
                    lambda p=plain, a=args: p(*a[1], **(
                        {} if a[0] == "run_tmlp" else a[2])),
                    args)
        res["plan"][key] = {k: getattr(plan, k) for k in (
            "variant", "wgs", "w_mode", "w_bytes", "unit_k", "total",
            "general", "v_bytes") if hasattr(plan, k)}
        for k in ("stages", "unit_b"):
            if hasattr(plan, k):
                res["plan"][key][k] = getattr(plan, k)
    lib = fm._lib()
    if hasattr(lib, "ring_trace"):  # wide_trace: one launch a shape
        import ctypes

        lib.ring_trace.argtypes = [ctypes.c_void_p, ctypes.c_int]
        buf = (ctypes.c_longlong * 24)()
        res["trace"] = {}
        for key, (fn, _, _) in fns.items():
            fn()
            torch.cuda.synchronize()
            lib.ring_trace(None, 1)
            fn()
            torch.cuda.synchronize()
            lib.ring_trace(buf, 0)
            res["trace"][key] = [list(buf[6 * w:6 * w + 6]) for w in range(4)]
    times = cs.interleaved_ms([f[0] for f in fns.values()], REPS)
    for key, t in zip(fns, times):
        res["ms"][key] = list(t)
    print(json.dumps({"variant": name, "ms": res["ms"]}), flush=True)
    for key, (fn, plain, (kname, a, k)) in fns.items():
        out = fn()
        out = out if isinstance(out, tuple) else (out,)
        h = hashlib.sha256()
        for t in out:
            h.update(t.contiguous().cpu().numpy().tobytes())
        res["digest"][key] = h.hexdigest()[:16]
        if key in checked:
            ref = plain()
            ref = ref if isinstance(ref, tuple) else (ref,)
            err, past, ratio = 0.0, 0, 0.0
            for a_, b_ in zip(out, ref):
                d = (a_ - b_).abs()
                err = max(err, float(d.max()))
                if f32:
                    q = d / (1.0 + b_.abs())
                    ratio = max(ratio, float(q.max()))
                    past += int((q > cs.F32_FAITHFUL).sum())
                else:
                    past += int((d > cs.GRID_TOL + cs.GRID_TOL * b_.abs())
                                .sum())
            res["plain"][key] = {"max_abs_err": err, (
                "past_f32_faithful" if f32 else "past_grid_tol"): past}
            if f32:
                e_k, e_p = cs.f64_errors(out, ref, cs.plain_f64(kname, a, k))
                res["plain"][key].update(max_ratio=ratio,
                                         vs_f64_kernel=e_k,
                                         vs_f64_cublas=e_p)
            del ref
        del out
        torch.cuda.empty_cache()
    print(json.dumps(res), flush=True)


def main(names, f32=False):
    from sanerf_tpu_torch.ops import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    jobs = []
    csrc, bdir = _build.CSRC, _build.BUILD_DIR
    ends = ["orig", "wide_f32_old"] if f32 else ["orig", "wide_old"]
    order = ends + names + ends[::-1]
    started = set()  # one nvcc a library (variants of the same source)
    for name in dict.fromkeys(order):
        _prepare(name)
        out = _build._lib_path("fused_mlp_t", _build.CSRC, _build.BUILD_DIR)
        jobs.append((out, None) if out in started else _build._start(
            "fused_mlp_t", _build.CSRC, _build.BUILD_DIR))
        started.add(out)
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
                            "--one", name] + (["--f32"] if f32 else []),
                           capture_output=True, text=True, timeout=600)
        sys.stdout.write(r.stdout)
        if r.returncode:
            print(json.dumps({"variant": name, "rc": r.returncode,
                              "stderr": r.stderr[-3000:]}), flush=True)


if __name__ == "__main__":
    f32 = "--f32" in sys.argv
    argv = [a for a in sys.argv[1:] if a != "--f32"]
    if len(argv) > 1 and argv[0] == "--one":
        one(argv[1], f32)
    else:
        main(argv or list(DEFAULT_F32 if f32 else DEFAULT), f32)
