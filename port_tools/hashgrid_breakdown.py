"""Where the hash-grid frame's time goes on the card: the RGB render of
`chip_smoke.py` phase 10 (`ModelConfig(field_type="hashgrid",
with_sam=True)` at full width, tables U(-TABLE_STD, TABLE_STD), bf16,
512^2 from the serving pose, (128, 64, 32)) and its 32^2 feature render,
split into their parts.

    python3 port_tools/hashgrid_breakdown.py    (needs a CUDA card)

Prints the card and JSON lines:
  stages   one RGB render and one feature render, each stage bracketed by
           CUDA events (device time, synchronised once at the end):
           hash_encode per grid (of which gather_rows), sample_pdf, the
           MLPs, contract, weights, composite; "other" is the frame less
           the stages;
  profile  a torch.profiler trace of one RGB render: device time, the
           card's busy share, the kernels with the most device time.
"""

import json
import os
import statistics
import subprocess
import sys
import time
from collections import defaultdict

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "port_tools"))

import hashgrid_params as hp  # noqa: E402
from sanerf_tpu_torch.config import ModelConfig, RenderConfig  # noqa: E402
from sanerf_tpu_torch.models import fields, renderer  # noqa: E402
from sanerf_tpu_torch.ops import hashgrid as hg  # noqa: E402

SIZE = 512
FEAT = 32


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda")
    model = fields.make_model(ModelConfig(field_type="hashgrid",
                                          with_sam=True), RenderConfig())
    gen = torch.Generator().manual_seed(0)
    p = fields.init_params(model, gen, dev)
    p["grid"] = hg.init_params(gen, model.grid_spec, hp.TABLE_STD, dev)
    p["s_grid"] = hg.init_params(gen, model.s_grid_spec, hp.TABLE_STD, dev)
    for pp, spec in zip(p["prop"], model.prop_specs):
        pp["grid"] = hg.init_params(gen, spec, hp.TABLE_STD, dev)
    params = fields.cast_params(p, torch.bfloat16)
    rays = {n: tuple(torch.from_numpy(a).to(dev) for a in hp.frame_rays(s))
            for n, s in (("rgb", SIZE), ("feature", FEAT))}

    def render(name):
        return renderer.run_rays(model, params, *rays[name],
                                 return_feats=name == "feature")

    for name in rays:
        render(name)
    torch.cuda.synchronize()

    spans = []
    grid_of = {id(model.grid_spec): "grid", id(model.s_grid_spec): "s_grid"}
    grid_of.update({id(s): f"prop{i}" for i, s in
                    enumerate(model.prop_specs)})

    def timed(mod, attr, label):
        fn = getattr(mod, attr)

        def wrapped(*a, **k):
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            out = fn(*a, **k)
            e.record()
            spans.append((label(a) if callable(label) else label, s, e))
            return out
        setattr(mod, attr, wrapped)
        return mod, attr, fn

    patches = [
        timed(hg, "hash_encode",
              lambda a: f"hash_encode/{grid_of.get(id(a[2]), '?')}"),
        timed(hg, "gather_rows", "gather_rows"),
        timed(renderer, "sample_pdf", "sample_pdf"),
        timed(renderer, "contract", "contract"),
        timed(renderer, "compute_weights", "compute_weights"),
        timed(renderer, "composite", "composite"),
        timed(fields, "apply_mlp", "mlp"),
        timed(fields, "apply_skip_mlp", "mlp"),
    ]
    stages = {}
    try:
        for name in rays:
            spans.clear()
            torch.cuda.synchronize()
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            t = time.perf_counter()
            s.record()
            render(name)
            e.record()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t) * 1e3
            ms = defaultdict(float)
            calls = defaultdict(int)
            for label, a, b in spans:
                ms[label] += a.elapsed_time(b)
                calls[label] += 1
            total = s.elapsed_time(e)
            top = sum(v for k, v in ms.items() if k != "gather_rows")
            stages[name] = {"device_ms": total, "wall_ms": wall,
                            "stages_ms": dict(ms), "calls": dict(calls),
                            "other_ms": total - top}
    finally:
        for mod, attr, fn in patches:
            setattr(mod, attr, fn)
    print(json.dumps({"stages": stages, "size": SIZE, "feature": FEAT,
                      "card": card}), flush=True)

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        render("rgb")
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    # kernels only: an operator's own entry repeats its kernels' time
    ev = [e for e in prof.key_averages()
          if e.device_type == DeviceType.CUDA
          and e.self_device_time_total > 0]
    dev_ms = sum(e.self_device_time_total for e in ev) / 1e3
    top = sorted(ev, key=lambda e: -e.self_device_time_total)[:25]
    print(json.dumps({"profile": {
        "wall_ms": wall, "device_ms": dev_ms,
        "device_busy_share": dev_ms / wall,
        "kernels": sum(e.count for e in ev),
        "top": [{"name": e.key[:90], "calls": e.count,
                 "device_ms": e.self_device_time_total / 1e3}
                for e in top]}, "card": card}), flush=True)
    ts = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        render("rgb")
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t) * 1e3)
    print(json.dumps({"rgb_render_ms": statistics.median(ts), "runs": ts,
                      "card": card}), flush=True)


if __name__ == "__main__":
    main()
