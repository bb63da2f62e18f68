"""Times the field kernels built from a variant of csrc/fused_mlp_t.cu, at
the composite's shapes of the (32, 16) frame (`kernel_breakdown.variants`:
the composite with its view head, run_tmlp of the field with and without
its CP tables, proposal net 0).

    python3 port_tools/kernel_variants.py VARIANTS NAME    (needs a CUDA card)

VARIANTS is a JSON object {name: [[old, new], ...]} of text substitutions
in csrc/fused_mlp_t.cu, or {name: "path/to/fused_mlp_t.cu"} for a whole
source; NAME picks one, or is "orig" for the source as it is. A name
starting with "fmad" also drops -fmad=false from the build. A variant
builds into build/variants/<name>/; compare variants within one run on
one card, one process each. Prints the ptxas register and spill lines, then one
JSON line: the time of each kernel_breakdown case (CUDA events, mean of
20 launches, two rounds) and the largest kernel-vs-plain difference of
run_tmlp on 200,003 random points (and the count past 0.05).
"""

import json
import os
import shutil
import sys
from pathlib import Path

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "port_tools"))

import kernel_breakdown as kb  # noqa: E402
from sanerf_tpu_torch.ops import _build  # noqa: E402
from sanerf_tpu_torch.ops import fused_mlp_t as fm  # noqa: E402


def use_variant(name, sources):
    """Points the build at build/variants/<name>/csrc, a copy of csrc with
    `sources` applied: {file in csrc: [[old, new], ...] text substitutions,
    or the path of a whole file to put in its place}. No sources: csrc as
    it is."""
    if not sources:
        return
    d = Path(ROOT) / "build" / "variants" / name
    src = d / "csrc"
    shutil.copytree(_build.CSRC, src, dirs_exist_ok=True)
    for fname, spec in sources.items():
        p = src / fname
        if isinstance(spec, str):
            shutil.copy(os.path.join(ROOT, spec), p)
            continue
        text = p.read_text()
        for old, new in spec:
            if old not in text:
                sys.exit(f"variants: {name}: {old!r} not in {fname}")
            text = text.replace(old, new)
        p.write_text(text)
    _build.CSRC = src
    _build.BUILD_DIR = d / "kernels"


def main():
    if not torch.cuda.is_available():
        sys.exit("kernel_variants: needs a CUDA card")
    variants, name = json.loads(sys.argv[1]), sys.argv[2]
    use_variant(name, {} if name == "orig"
                else {"fused_mlp_t.cu": variants[name]})
    if name.startswith("fmad"):
        _build.NVCC_FLAGS = [f for f in _build.NVCC_FLAGS
                             if f != "-fmad=false"]
    fm._lib()
    for line in (_build.BUILD_DIR / "fused_mlp_t.log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print("   ", line.strip()[:160])
    dev = torch.device("cuda")
    _, _, nets, fns = kb.variants(dev)
    ms = {}
    for _ in range(2):
        for k, fn in fns.items():
            ms.setdefault(k, []).append(kb.cuda_ms(fn, reps=20))
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.rand(3, 200003, generator=g, device=dev) * 4 - 2
    err = {}
    for k, tm in (("field", nets.field), ("prop", nets.props[0])):
        d = (fm.run_tmlp(x, tm, True) - fm.run_tmlp_plain(x, tm)).abs()
        err[k] = [float(d.max()), int((d > 0.05).sum())]
    print(json.dumps({"variant": name, "ms": ms, "max_abs_err": err}),
          flush=True)


if __name__ == "__main__":
    main()
