"""Times `gather_rows_backward` built from a variant of csrc/gather.cu at
the launch shapes the hash grid's table gradient had on one full-width
training step before `hash_grid_backward` (one launch a level, on the rows
the parent's glue made; chip_smoke's `parent_launches`).

    python3 port_tools/scatter_variants.py NAME   (needs a CUDA card)

NAME is a key of VARIANTS below (text substitutions in csrc/gather.cu), or
"orig" for the source as it is; each builds into build/variants/<name>/.
Compare variants within one call on one card, one process each, with
`orig` at both ends. The step is `ModelConfig(field_type="hashgrid")`,
`RenderConfig()`, `TrainConfig()` (8,192 rays) on the textured fixture, as
chip_smoke's phase T3 drives it; its hash_grid_backward launches are
recorded (`record_fused`), each level's launch rebuilt from them, held and
timed by chip_smoke's `hold_backward`. Prints one JSON line:
the step's sums (kernel, `index_add_` and plain ms, byte bound) and, per
launch, its shape, the median / 10th / 90th percentile ms of PROBE_REPS
interleaved launches queued behind a backlog, max|ref|, the median |ref|
over the touched rows and the floor it needs against the plain version.
"""

import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "port_tools"))

from chip_smoke import (PROBE_REPS, hash_step, hold_backward,  # noqa: E402
                        parent_launches, record_fused)
from kernel_variants import use_variant  # noqa: E402

VARIANTS = {
    # one atomic a lane at every launch: no summing across the warp
    "never": [["constexpr long kWarpSumRatio = 80;",
               "constexpr long kWarpSumRatio = 1L << 40;"]],
    # summing across the warp at every launch
    "always": [["constexpr long kWarpSumRatio = 80;",
                "constexpr long kWarpSumRatio = 0;"]],
}


def main():
    if not torch.cuda.is_available():
        sys.exit("scatter_variants: needs a CUDA card")
    name = sys.argv[1]
    use_variant(name, {} if name == "orig" else {"gather.cu": VARIANTS[name]})
    from sanerf_tpu_torch.config import ModelConfig, RenderConfig, TrainConfig
    from sanerf_tpu_torch.data.synthetic import SyntheticSphereDataset
    from sanerf_tpu_torch.models import fields
    from sanerf_tpu_torch.ops import _build
    from sanerf_tpu_torch.ops import gather as ga
    from sanerf_tpu_torch.ops import hashgrid as hg
    from sanerf_tpu_torch.train import state as st

    ga._lib()
    for line in (_build.BUILD_DIR / "gather.log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print("   ", line.strip()[:160], file=sys.stderr)
    dev = torch.device("cuda")
    model = fields.make_model(ModelConfig(field_type="hashgrid"),
                              RenderConfig())
    tc = TrainConfig()
    n = st.adaptive_num_rays(tc, model.render_cfg.num_steps[-1])
    params = fields.init_params(model, torch.Generator().manual_seed(0), dev)
    ds = SyntheticSphereDataset(H=64, W=64, n_views=8, scene="textured")
    batch = {k: torch.as_tensor(v, device=dev) for k, v in
             ds.collate_train(np.random.default_rng(0), n).items()
             if isinstance(v, np.ndarray)}
    draws = st.draw_step(model, tc, n,
                         torch.Generator(device=dev).manual_seed(0), dev)
    _, fused = record_fused(
        hg, lambda: hash_step(model, tc, params, batch, draws))
    seen = [(s_, i, r) for x01, g, spec, k in fused
            for s_, i, r, _ in parent_launches(hg, x01, g, spec, k)]
    torch.cuda.synchronize()
    step, launches = hold_backward(ga, seen, dev)
    print(json.dumps({"variant": name, "card": torch.cuda.get_device_name(0),
                      "reps": PROBE_REPS, "step": step,
                      "launches": launches}))


if __name__ == "__main__":
    main()
