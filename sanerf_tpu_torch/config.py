"""Frozen configuration objects of the PyTorch/CUDA port.

Field names, defaults and `config_from_dict` are those of the JAX package's
`sanerf_tpu/config.py` (RenderConfig, HashGridConfig, ModelConfig), so a
serialized asset's `model_config` / `render_config` round-trip unchanged.
The port keeps its own copy: it imports nothing of the JAX package.

Fields that describe TPU tilings (`fused_block`, `fused_prop_block`) are
kept so configs round-trip; the CUDA kernels pick their own tiles.
`grid_vmem_budget` routes as in the JAX package: a model whose grid
tables exceed it renders on the plain path (models/renderer.py:
uses_kernels).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class RenderConfig:
    """Volume-rendering configuration."""

    # samples per proposal level; the last entry is the final NeRF level
    num_steps: Tuple[int, ...] = (128, 64, 32)
    # scene bound; with contraction the grid bound becomes 2
    bound: float = 128.0
    contract: bool = True
    min_near: float = 0.2
    # 'white' | 'random' | 'last_sample'
    background: str = "last_sample"
    # rays per chunk in staged inference
    max_ray_batch: int = 4096 * 4
    density_thresh: float = 10.0
    # inference: run the ray geometry and the MLP chains through the CUDA
    # kernels (ops/ray_kernels.py, ops/fused_mlp_t.py); False = plain path
    use_fused_mlp: bool = True
    # let the kernels compute the factorized-grid features (CP, VM, sigma)
    # themselves; False sends models with grid tables to the plain path
    cp_fused: bool = True
    # TPU point-block sizes of the JAX kernels (kept for round-trip only)
    fused_block: int = 4096
    fused_prop_block: int = 16384
    # SH + view MLP inside the composite kernel's epilogue (True) or as
    # plain ops on the composited per-ray sums (False)
    view_in_kernel: bool = True
    # off by default, as in the JAX package: the [3, N, T] -> [3, N*T]
    # pivot through the flatten3_nt kernel, and the composite reading the
    # ray kernels' packed ts/dl rows
    flatten_kernel: bool = False
    packed_epilogue: bool = False
    # the fast path takes grid tables up to this many bytes (bf16,
    # NerfModel.grid_table_bytes); larger ones render on the plain path
    grid_vmem_budget: int = 6 * 2 ** 20

    @property
    def grid_bound(self) -> float:
        return 2.0 if self.contract else self.bound


@dataclass(frozen=True)
class HashGridConfig:
    """One multiresolution hash grid (JAX: sanerf_tpu/config.py:95-108;
    reference: gridencoder/grid.py:102-142)."""

    input_dim: int = 3
    num_levels: int = 16
    level_dim: int = 2
    base_resolution: int = 16
    log2_hashmap_size: int = 19
    desired_resolution: Optional[int] = None
    per_level_scale: float = 2.0
    gridtype: str = "hash"  # 'hash' | 'tiled'
    interpolation: str = "linear"  # 'linear' | 'smoothstep'
    align_corners: bool = False


@dataclass(frozen=True)
class ModelConfig:
    """Field architecture. `field_type` selects the encoder family:
      - "mlp": Fourier features (plus CP / VM factorized grids) and MLPs,
        served through the fused kernels of ops/fused_mlp_t.py;
      - "hashgrid": the reference's instant-ngp multiresolution hash grids
        (ops/hashgrid.py, its table gather in the kernel of ops/gather.py)
        with small MLPs, served through the plain path of the renderer.
    """

    field_type: str = "mlp"  # "mlp" | "hashgrid"
    geom_feat_dim: int = 15
    # --- mlp field family ---
    mlp_enc_freqs: int = 10
    mlp_field_width: int = 128
    mlp_field_depth: int = 8
    # CP line grid feeding the field MLP (0 = off)
    mlp_cp_rank: int = 0
    mlp_cp_res: int = 256
    mlp_cp_levels: int = 1
    # VM plane+line grid (0 = off)
    mlp_vm_rank: int = 0
    mlp_vm_res: int = 64
    mlp_vm_levels: int = 1
    # direct-density grids: their component sum is added to the density logit
    mlp_sigma_cp_rank: int = 0
    mlp_sigma_cp_res: int = 256
    mlp_sigma_vm_rank: int = 0
    mlp_sigma_vm_res: int = 128
    grid_lookup: str = "auto"
    mlp_prop_enc_freqs: int = 5
    mlp_prop_width: int = 64
    mlp_prop_depth: int = 4
    mlp_sam_width: int = 256
    mlp_sam_depth: int = 4
    mlp_sam_feat_dim: int = 128
    mlp_mask_width: int = 128
    mlp_mask_depth: int = 4
    mlp_mask_feat_dim: int = 128
    # --- hashgrid family ---
    grid_num_levels: int = 16
    grid_level_dim: int = 2
    grid_log2_hashmap: int = 19
    grid_desired_resolution: int = 4096
    grid_mlp_hidden: int = 64
    grid_mlp_layers: int = 3
    # view branch: SH degree 4 -> 16 dims
    sh_degree: int = 4
    view_mlp_hidden: int = 32
    view_mlp_layers: int = 3
    # proposal networks
    prop_num_levels: int = 5
    prop_level_dim: int = 2
    prop_log2_hashmap: int = 17
    prop_resolutions: Tuple[int, ...] = (128, 256)
    prop_mlp_hidden: int = 16
    prop_mlp_layers: int = 2
    # --- SAM feature field ---
    with_sam: bool = False
    sam_feat_dim: int = 256
    s_grid_num_levels: int = 16
    s_grid_level_dim: int = 8
    s_grid_log2_hashmap: int = 19
    s_grid_desired_resolution: int = 512
    samvit_mlp_hidden: int = 256
    samvit_mlp_layers: int = 5
    samvit_skip_layers: Tuple[int, ...] = (2,)
    sam_use_view_direction: bool = False
    sum_after_mlp: bool = False
    # --- mask field ---
    with_mask: bool = False
    mask_mlp_type: str = "default"  # 'default' | 'lightweight_mask' | 'adaptive'
    adaptive_mlp_type: str = "density"  # 'density' | 'rgb' | 'sam'
    n_inst: int = 2
    redundant_instance: int = 0


def config_from_dict(cls, d: dict):
    """Rebuild a frozen config from a JSON dict: lists become tuples again;
    unknown keys are ignored so older serialized configs keep loading."""
    names = {f.name for f in dataclasses.fields(cls)}
    kw = {k: (tuple(v) if isinstance(v, list) else v)
          for k, v in d.items() if k in names}
    return cls(**kw)
