"""chip_smoke's phase E (data parallelism) alone, on the CUDA card.

Builds the kernels, writes phase C's files (the 16-view textured scene,
its object masks, a seeded ViT-H checkpoint) under
build/chip_smoke_cli/, runs `chip_smoke.dp_phase` and prints its summary
lines beside the card's name and power limit; the whole record goes to
OUT (default build/dp_phase.json).

    python3 port_tools/dp_phase.py [OUT]

About 5 minutes of command time with the build.
"""

import contextlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "port_tools"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from sam_weights import seeded_state_dict  # noqa: E402
from scene_files import write_masks, write_transforms_scene  # noqa: E402
from sanerf_tpu_torch.data.synthetic import SyntheticSphereDataset  # noqa: E402
from sanerf_tpu_torch.models.sam import convert as sam_convert  # noqa: E402
from sanerf_tpu_torch.ops import _build  # noqa: E402


def main(out=os.path.join(ROOT, "build", "dp_phase.json")):
    import numpy as np

    t0 = time.time()
    _build.build_all()
    print("build", time.time() - t0, flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    base = os.path.join(ROOT, "build", "chip_smoke_cli")
    ds = SyntheticSphereDataset(H=cs.CLI_SIZE, W=cs.CLI_SIZE,
                                n_views=cs.CLI_VIEWS, scene="textured")
    scene = write_transforms_scene(ds, os.path.join(base, "scene"))
    write_masks(scene, "obj_masks", [f"r_{i}" for i in range(cs.CLI_VIEWS)],
                ds.instances >= 2)
    sam_path = os.path.join(base, "sam_vit_h_seeded.pth")
    torch.save(seeded_state_dict(sam_convert.sam_config_for("vit_h"),
                                 cs.SAM_SEED), sam_path)
    ctx = {"base": base, "scene": scene, "sam_path": sam_path}
    print("setup", time.time() - t0, flush=True)
    with contextlib.redirect_stdout(sys.stderr):
        rec = cs.dp_phase(torch, np, torch.device("cuda"), card, ctx)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(rec, f, indent=1)
    for line in rec["summary"]:
        print(line, card, flush=True)
    print("total", time.time() - t0)


if __name__ == "__main__":
    main(*sys.argv[1:])
