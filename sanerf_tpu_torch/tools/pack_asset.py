"""Package a serving-student workspace as the serving asset
(JAX: tools/pack_asset.py).

Reads <workspace>/serving_meta.json and its latest checkpoint and writes
`<out>.npz` (the checkpoint's `params/` leaves) and `<out>.json` (the model
and render configs, and provenance: the workspace, the checkpoint, the
teacher, the distillation report). `--out` defaults to the shipped asset,
`assets/serving_student`; `main(..., asset=path)` moves that default.

    python -m sanerf_tpu_torch.tools.pack_asset /tmp/slim64 [--out PATH]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from sanerf_tpu_torch.device import resolve_device
from sanerf_tpu_torch.tools import ASSET, read_meta
from sanerf_tpu_torch.train.checkpoints import CheckpointManager


def main(argv=None, *, asset: str = ASSET, device=None) -> str:
    ap = argparse.ArgumentParser()
    ap.add_argument("workspace")
    ap.add_argument("--name", default="ngp")
    ap.add_argument("--out", default=asset)
    args = ap.parse_args(argv)
    resolve_device(device)

    meta = read_meta(args.workspace)
    path = CheckpointManager(args.workspace, name=args.name).resolve("latest")
    if path is None:
        raise SystemExit(f"no checkpoint under {args.workspace}")
    flat, _ = CheckpointManager.load_file(path)
    out = {k: v for k, v in flat.items() if k.startswith("params/")}
    np.savez(args.out + ".npz", **out)
    with open(args.out + ".json", "w") as f:
        json.dump({
            "model_config": meta["model_config"],
            "render_config": meta["render_config"],
            "provenance": {
                "workspace": args.workspace,
                "checkpoint": os.path.basename(path),
                "teacher": meta.get("teacher") or meta.get("teacher_step"),
                "report": meta.get("report"),
            },
        }, f, indent=1, default=str)
    print(f"packed {args.out}.npz ({len(out)} leaves) from {path}")
    return args.out


if __name__ == "__main__":
    main()
