"""chip_smoke's phase F rehearsed on the CPU, before a chip call.

Runs `chip_smoke.tools_phase` with the plain versions at small sizes:
`check` logs instead of exiting, the iterations cut to 2, the held-out ring
at 16^2 and 2 views, each tool's `main` given small flags, the
`torch.cuda` synchronise and memory calls stubbed. Finds wrong paths,
arguments and shapes; the launch counts, F1's "above the untrained model"
and F2's JAX PSNRs fail here by design (they are the card's). Prints the
failed checks last.

    python3 port_tools/rehearse_tools_phase.py    # about 20 s
"""

import functools
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from sanerf_tpu_torch import tools  # noqa: E402
from sanerf_tpu_torch.models import import_distill  # noqa: E402
from sanerf_tpu_torch.tools import (distill_serving, eval_student,  # noqa: E402
                                    finetune_student, hierarchy_gate,
                                    import_checkpoint, mask_asset,
                                    quality_gate, redistill_asset,
                                    serve_finetune)

SMALL = ["--H", "16", "--views", "4", "--num_rays", "64"]
FLAGS = {quality_gate: SMALL, hierarchy_gate: ["--H", "16"],
         finetune_student: SMALL, serve_finetune: SMALL, mask_asset: SMALL,
         redistill_asset: ["--points", "4096", "--batch", "512"],
         import_checkpoint: ["--n_points", "4096", "--batch", "512"],
         distill_serving: ["--distill_points", "4096",
                           "--distill_batch", "512"]}


def main():
    torch.set_num_threads(4)
    failed = []

    def soft(cond, msg):
        if not cond:
            failed.append(msg)
            print("check failed:", msg, file=sys.stderr, flush=True)

    cs.check = soft
    cs.SIZE, cs.QG_ITERS, cs.TOOLS_FRAME = 32, 2, 16
    cs.TOOL_ITERS = {k: 2 for k in cs.TOOL_ITERS}
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        setattr(torch.cuda, name, lambda *a, **k: None)
    torch.cuda.max_memory_allocated = lambda *a, **k: 0
    ring = tools.heldout_ring
    for mod in (eval_student, hierarchy_gate, serve_finetune, mask_asset,
                quality_gate, finetune_student):
        mod.heldout_ring = lambda H=128, n_views=8: ring(16, 2)
    cs_fidelity = import_distill._render_fidelity
    import_distill._render_fidelity = (
        lambda tm, tp, sm, sp, n_frames, hw, device=None: cs_fidelity(
            tm, tp, sm, sp, n_frames, 16, device))
    for mod, flags in FLAGS.items():
        mod.main = functools.partial(
            lambda real, flags, argv, **kw: real(list(argv) + flags, **kw),
            mod.main, flags)
    rec = cs.tools_phase(torch, np, torch.device("cpu"), "CPU rehearsal")
    print(rec["summary"])
    print(f"{len(failed)} checks failed:")
    for msg in failed:
        print(" -", msg)


if __name__ == "__main__":
    main()
