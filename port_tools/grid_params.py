"""The MLP family's factorized-grid configurations and their seeded float32
parameters, made with numpy alone.

Both sides of the grid reference check load the same weights from here:
`port_tools/jax_grid_reference.py` (the JAX package, on the CPU) and
`chip_smoke.py` (the port, on the card). Neither JAX nor torch is imported,
so the card's machine can run it.

    mc = ModelConfig(**CONFIGS["grid_student"])
    flat = make_flat(shapes, seed=0)
    rays_o, rays_d = frame_rays(64)

CONFIGS holds the `ModelConfig` fields that differ from the defaults (width
128, 10 frequencies, proposal nets w64 d4 at (128, 256), SH degree 4):
  - grid_student: the distilled serving student the TPU kernels were
    checked on in hardware (tools/hw_parity.py:29-31), depth 3, CP96@256,
    VM16@64, sigma-CP32@256;
  - cp_ladder: CP96@256 in 2 levels (tools/hw_parity.py:33), depth 8;
  - vm_ladder: CP48@128 and VM16@64 in 2 levels (tools/hw_parity.py:34-35),
    depth 8;
  - quality_recipe: the grid family's quality recipe
    (scripts/train_rgb_grids.sh:12-16), depth 3, CP96@2048 x 4 levels,
    VM32@1024 x 4, sigma-CP96@2048, sigma-VM16@512: 94 MB of bf16 tables,
    over RenderConfig.grid_vmem_budget, so it renders on the plain path.
`make_flat` maps `params/<path>` to arrays drawn in sorted path order from
one `np.random.default_rng(seed)`: grid tables (`cp_lines`, `vm_planes`,
`vm_lines`, their ladder levels `<name>/<i>`, the sigma tables) N(0, 1), so
that the grid features move the output; linear weights and biases, and the
LayerNorm, as port_tools/hashgrid_params.py draws them.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from hashgrid_params import SERVE_POSE, frame_rays  # noqa: F401

CONFIGS = {
    "grid_student": dict(mlp_field_depth=3, mlp_cp_rank=96, mlp_cp_res=256,
                         mlp_vm_rank=16, mlp_vm_res=64,
                         mlp_sigma_cp_rank=32, mlp_sigma_cp_res=256),
    "cp_ladder": dict(mlp_cp_rank=96, mlp_cp_res=256, mlp_cp_levels=2),
    "vm_ladder": dict(mlp_cp_rank=48, mlp_cp_res=128, mlp_vm_rank=16,
                      mlp_vm_res=64, mlp_vm_levels=2),
    "quality_recipe": dict(mlp_field_depth=3, mlp_cp_rank=96,
                           mlp_cp_res=2048, mlp_cp_levels=4, mlp_vm_rank=32,
                           mlp_vm_res=1024, mlp_vm_levels=4,
                           mlp_sigma_cp_rank=96, mlp_sigma_cp_res=2048,
                           mlp_sigma_vm_rank=16, mlp_sigma_vm_res=512),
}
#: a small model with both sigma tables (the JAX suite's
#: tests/test_sigma_grid.py:17-21 MC), and the same with CP and VM features
#: (:172-173): no configuration above has a sigma-VM table within
#: RenderConfig.grid_vmem_budget, so these hold that branch of the kernels
SIGMA = dict(mlp_sigma_cp_rank=6, mlp_sigma_cp_res=24, mlp_sigma_vm_rank=3,
             mlp_sigma_vm_res=16, mlp_enc_freqs=3, mlp_field_width=16,
             mlp_field_depth=4, mlp_prop_enc_freqs=2, mlp_prop_width=16,
             mlp_prop_depth=2, prop_resolutions=(16,))
SIGMA_VM = dict(SIGMA, mlp_cp_rank=8, mlp_cp_res=16, mlp_vm_rank=2,
                mlp_vm_res=8)
SOURCES = {
    "grid_student": "tools/hw_parity.py:29-31",
    "cp_ladder": "tools/hw_parity.py:33",
    "vm_ladder": "tools/hw_parity.py:34-35",
    "quality_recipe": "scripts/train_rgb_grids.sh:12-16",
}
GRID_TABLES = ("cp_lines", "vm_planes", "vm_lines", "sigma_cp_lines",
               "sigma_vm_planes", "sigma_vm_lines")


def make_flat(shapes: Dict[str, Tuple[int, ...]],
              seed: int = 0) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    out = {}
    for path in sorted(shapes):
        shape = tuple(shapes[path])
        leaf = path.rsplit("/", 1)[-1]
        if path.split("/")[0] in GRID_TABLES:
            v = rng.standard_normal(shape, dtype=np.float32)
        elif path.startswith("samvit_norm/"):
            v = np.full(shape, 1.0 if leaf == "w" else 0.0)
        elif leaf in ("w", "b"):
            bound = 1.0 / np.sqrt(shapes[path[:-1] + "w"][0])
            v = rng.uniform(-bound, bound, shape)
        else:
            raise ValueError(f"no rule for parameter {path!r}")
        out["params/" + path] = v.astype(np.float32)
    return out
