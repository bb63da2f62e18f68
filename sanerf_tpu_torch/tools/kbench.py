"""Microbench the fused composite kernel at the serving-student shape (JAX:
tools/kbench.py).

Times `run_tmlp_composite` (and ablated variants) alone on seeded inputs
at the benched frame's sizes, so that the composite's time splits into
the field MLP chain, the CP grid block, the composite epilogue and the
view epilogue: `full(grids+view)`, `no_view(grids)`, `no_grids(view)`,
`mlp_only`, `tmlp_nocomp(grids)` (the field through `run_tmlp`, no
composite), and the TPU tool's `block` sweep. The port's kernels plan
their own tiles and take no `block`: the sweep's rows time the same
launch as `full(grids+view)` and say so. Times are CUDA-event medians of
`--n` launches queued behind a sleep kernel (the card's time). The last
line is the JAX tool's JSON.

    python -m sanerf_tpu_torch.tools.kbench [--rays 262144] [--t 24]
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, Optional

import torch

from sanerf_tpu_torch.device import resolve_device
from sanerf_tpu_torch.ops import fused_mlp_t as fm
from sanerf_tpu_torch.tools import queued_ms

#: the TPU tool's block sweep on the full configuration
BLOCKS = (2048, 8192, 16384)


def operands(args, device, dtype=torch.bfloat16) -> Dict:
    """The seeded operands of the JAX tool (its shapes; draws of torch's
    generator): a depth-d bias-free decoder with the skip at d // 2 (the
    fields layout), the view MLP 31-32-32-3, CP and sigma-CP lines 0.1
    N(0, 1) in `dtype`, points U(-2, 2), deltas 0.05, midpoints their
    running sum, rays8 = [0, N(0, 1) directions, 0, 0]."""
    g = torch.Generator().manual_seed(0)
    N, T = args.rays, args.t
    B = N * T
    w, d = args.width, args.depth

    def mk(*shape):
        return (torch.randn(*shape, generator=g) * 0.1).to(dtype)

    enc_dim = 3 * (1 + 2 * args.freqs) + args.cp
    skip = (d // 2,)
    layers = []
    for layer in range(d):
        fi = enc_dim if layer == 0 else w
        if layer in skip and layer:
            fi = w + enc_dim
        fo = 16 if layer == d - 1 else w
        layers.append({"w": mk(fi, fo)})
    view_layers = [{"w": mk(31, 32)}, {"w": mk(32, 32)}, {"w": mk(32, 3)}]
    cp_lines = mk(3, args.cp_res, args.cp)
    sig_lines = mk(3, args.cp_res, args.sig)
    xT = torch.rand(3, B, generator=g) * 4.0 - 2.0
    dl = torch.full((N, T), 0.05)
    ts = torch.cumsum(dl, dim=1)
    rays8 = torch.cat([torch.zeros(N, 3), torch.randn(N, 3, generator=g),
                       torch.zeros(N, 2)], dim=1)
    ops = {"layers": layers, "view_layers": view_layers,
           "cp_lines": cp_lines, "sigma_cp_lines": sig_lines, "xT": xT,
           "dl": dl, "ts": ts, "rays8": rays8, "skip": skip}
    return _to(ops, device)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device) if torch.is_tensor(tree) else tree


def field(ops: Dict, args, grids: bool) -> fm.TransposedFieldMLP:
    """The decoder, with (grids) or without its CP and sigma-CP tables."""
    kw = {}
    if grids:
        kw = dict(cp_lines=ops["cp_lines"],
                  sigma_cp_lines=ops["sigma_cp_lines"])
        layers = ops["layers"]
    else:  # no tables: layer 0 and the skip layer lose the CP columns
        F = 3 * (1 + 2 * args.freqs)
        layers = [dict(p) for p in ops["layers"]]
        layers[0] = {"w": layers[0]["w"][:F]}
        s = ops["skip"][0]
        if s:
            w = layers[s]["w"]
            layers[s] = {"w": torch.cat([w[:args.width],
                                         w[args.width:args.width + F]])}
    return fm.TransposedFieldMLP(layers, args.freqs, args.bound,
                                 skip_layers=ops["skip"], leaky=True, **kw)


def variants(ops: Dict, args) -> Dict[str, tuple]:
    """name -> (function, arguments) of each composite variant."""
    tm_g, tm_0 = field(ops, args, True), field(ops, args, False)
    view = fm.ViewMLP(ops["view_layers"], tm_g.kout)
    x, dl, ts, r8 = ops["xT"], ops["dl"], ops["ts"], ops["rays8"]
    comp = fm.run_tmlp_composite
    return {
        "full(grids+view)": (comp, (x, dl, ts, tm_g, True, view, r8)),
        "no_view(grids)": (comp, (x, dl, ts, tm_g, True)),
        "no_grids(view)": (comp, (x, dl, ts, tm_0, True, view, r8)),
        "mlp_only": (comp, (x, dl, ts, tm_0, True)),
        "tmlp_nocomp(grids)": (fm.run_tmlp, (x, tm_g, True)),
    }


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rays", type=int, default=512 * 512)
    ap.add_argument("--t", type=int, default=24)
    ap.add_argument("--block", type=int, default=4096,
                    help="the TPU kernels' block; the port's kernels plan "
                         "their own tiles and take none")
    ap.add_argument("--depth", type=int, default=3)
    ap.add_argument("--width", type=int, default=128)
    ap.add_argument("--cp", type=int, default=96)
    ap.add_argument("--cp_res", type=int, default=256)
    ap.add_argument("--sig", type=int, default=32)
    ap.add_argument("--n", type=int, default=8)
    ap.add_argument("--freqs", type=int, default=6)
    ap.add_argument("--bound", type=float, default=128.0)
    return ap


def main(argv=None, *, device=None) -> Dict[str, Optional[float]]:
    """-> the JSON line's record ({"rays", "T", variant: ms}); on the CPU
    the plain versions run once each and nothing is timed (ms None)."""
    args = build_parser().parse_args(argv)
    dev = resolve_device(device)
    ops = operands(args, dev)
    rows: Dict[str, Optional[float]] = {}
    main.launches = {}

    def run(name, fn, a, note=""):
        before = (fm.run_tmlp_composite.launches, fm.run_tmlp.launches)
        try:
            if dev.type == "cuda":
                ms = queued_ms(lambda: fn(*a), args.n)
                rows[name] = ms
                print(f"{name:28s} {ms:7.2f} ms{note}", flush=True)
            else:
                fn(*a)
                rows[name] = None
                print(f"{name:28s} (cpu, not timed){note}", flush=True)
        except Exception as e:
            rows[name] = None
            print(f"{name:28s} FAILED {type(e).__name__}: "
                  f"{str(e).splitlines()[0][:120]}", flush=True)
        main.launches[name] = (
            fm.run_tmlp_composite.launches - before[0]
            + fm.run_tmlp.launches - before[1])

    v = variants(ops, args)
    for name, (fn, a) in v.items():
        run(name, fn, a)
    fn, a = v["full(grids+view)"]
    for blk in BLOCKS:
        run(f"full@block{blk}", fn, a,
            "  (no block in the port's kernel: the full launch again)")
    print(json.dumps({"rays": args.rays, "T": args.t, **rows}))
    return {"rays": args.rays, "T": args.t, **rows}


main.launches = {}


if __name__ == "__main__":
    main()
