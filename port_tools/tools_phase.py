"""chip_smoke's phase F (the asset pipeline of sanerf_tpu_torch/tools) alone,
on the CUDA card.

Builds the kernels, runs `chip_smoke.tools_phase` (every tool through its
`main` in build/chip_smoke_tools/, deleted at the end) and prints its
summary lines beside the card's name and power limit; the whole record goes
to OUT (default build/tools_phase.json).

    python3 port_tools/tools_phase.py [OUT]

About 4 minutes of command time with the build.
"""

import contextlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from sanerf_tpu_torch.ops import _build  # noqa: E402


def main(out=os.path.join(ROOT, "build", "tools_phase.json")):
    import numpy as np

    t0 = time.time()
    _build.build_all()
    print("build", time.time() - t0, flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with contextlib.redirect_stdout(sys.stderr):
        rec = cs.tools_phase(torch, np, torch.device("cuda"), card)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(rec, f, indent=1)
    for line in rec["summary"]:
        print(line, card, flush=True)
    print("total", time.time() - t0)


if __name__ == "__main__":
    main(*sys.argv[1:])
