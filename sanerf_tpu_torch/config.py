"""Frozen configuration objects of the PyTorch/CUDA port.

Field names, defaults and `config_from_dict` are those of the JAX package's
`sanerf_tpu/config.py` (RenderConfig, HashGridConfig, ModelConfig,
TrainConfig, SamTrainConfig, MaskTrainConfig, DataConfig, Config), so a
serialized asset's `model_config` / `render_config` and a run's config
round-trip unchanged. The port keeps its own copy: it imports nothing of
the JAX package. SamTrainConfig, MaskTrainConfig and DataConfig are held
so that `Config` has the same fields; nothing in the port reads them yet.

Fields that describe TPU tilings (`fused_block`, `fused_prop_block`) are
kept so configs round-trip; the CUDA kernels pick their own tiles.
`grid_vmem_budget` routes as in the JAX package: a model whose grid
tables exceed it renders on the plain path (models/renderer.py:
uses_kernels).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
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


@dataclass(frozen=True)
class TrainConfig:
    """Stage-1 optimization (JAX: sanerf_tpu/config.py:239-291)."""

    iters: int = 20000
    lr: float = 1e-2
    lr_warmup_steps: int = 0  # linear warm-up (0 = none)
    grad_clip: float = 1.0  # global-norm clip (0 disables)
    adam_eps: float = 1e-15
    # lr multiplier of the factorized tables (train/state.py:GRID_LR_KEYS)
    grid_lr_mult: float = 10.0
    ema_decay: float = 0.95
    # rays a step; adaptive: num_points // num_steps[-1]
    num_rays: int = 4096
    adaptive_num_rays: bool = True
    num_points: int = 2 ** 18
    lambda_entropy: float = 0.0
    lambda_tv: float = 0.0
    # L1 sparsity of the factorized tables (MLP family)
    lambda_l1_grid: float = 0.0
    # the factorized tables start at final_res >> N and double at each of
    # these global steps (applied at epoch boundaries; optimizer reset)
    grid_upsample_steps: Tuple[int, ...] = ()
    lambda_wd: float = 0.0
    lambda_proposal: float = 1.0
    lambda_distort: float = 0.02
    # proposal nets update every step up to prop_warmup_steps, then every
    # prop_update_every-th
    prop_warmup_steps: int = 3000
    prop_update_every: int = 5
    # coarse-to-fine opening of the MLP family's encode over these steps
    # (0 = off; the hash-grid family ignores it)
    anneal_iters: int = 0
    # the native prefetching ray sampler for image datasets without
    # per-view near/far; the port raises on such a dataset (the loader
    # comes with the data-provider slice)
    use_native_loader: bool = True
    # data-parallel device count; the port raises on > 1
    n_devices: int = 1
    save_cnt: int = 20
    eval_cnt: int = 5
    max_keep_ckpt: int = 2


@dataclass(frozen=True)
class SamTrainConfig:
    """Stage-2 SAM-feature distillation (JAX: config.py:294-309)."""

    online_resolution: int = 512
    cache_size: int = 256
    cache_interval: int = 4
    sam_ckpt: str = "./pretrained/sam_vit_h_4b8939.pth"
    fovy_range: Tuple[float, float] = (50.0, 70.0)
    eval_fovy: float = 60.0
    pose_jittering: bool = False


@dataclass(frozen=True)
class MaskTrainConfig:
    """Stage-3 mask-field training (JAX: config.py:312-336)."""

    label_regularization_weight: float = 0.0
    patch_size: int = 1
    incoherent_uncertainty_weight: float = 1.0
    rgb_similarity_loss_weight: float = 0.0
    rgb_similarity_threshold: float = 0.3
    epsilon: float = 1e-6
    rgb_similarity_exp_weight: float = 10.0
    rgb_similarity_num_sample: int = 1
    rgb_similarity_iter: int = -1
    rgb_similarity_use_pred_logistics: bool = False
    mixed_sampling: bool = False
    local_sample_patch_size: int = 16
    num_local_sample: int = 2
    error_map: bool = False
    error_map_size: int = 128
    use_multi_res: bool = False
    multi_res_update_iter: int = 100
    max_multi_res_level: int = 2
    use_dynamic_incoherent: bool = False
    incoherent_update_iter: int = 50
    incoherent_downsample_scale: int = 1
    mask_folder_name: Optional[str] = None


@dataclass(frozen=True)
class DataConfig:
    """Dataset configuration (JAX: config.py:339-357)."""

    path: str = "."
    data_type: str = "mip"
    train_split: str = "train"
    test_split: str = "val"
    val_type: str = "default"
    downscale: int = 1
    scale: float = -1.0
    offset: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    enable_cam_near_far: bool = False
    enable_cam_center: bool = False
    random_image_batch: bool = False
    preload: bool = True
    camera_traj: str = "interp"
    scene_name: str = "garden"
    object_name: str = "table_whole"


@dataclass(frozen=True)
class Config:
    """Top-level bundle (JAX: config.py:360-382)."""

    workspace: str = "workspace"
    seed: int = 0
    ckpt: str = "latest"  # latest | latest_model | best | scratch | <path>
    init_ckpt: str = ""
    test: bool = False
    gui: bool = False
    render_mask_type: str = "heatmap"  # mask | composition | heatmap
    render_mask_instance_id: int = 0
    use_wandb: bool = False
    render: RenderConfig = field(default_factory=RenderConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    sam: SamTrainConfig = field(default_factory=SamTrainConfig)
    mask: MaskTrainConfig = field(default_factory=MaskTrainConfig)
    data: DataConfig = field(default_factory=DataConfig)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def replace(cfg, **kw):
    """dataclasses.replace for any of the frozen configs."""
    return dataclasses.replace(cfg, **kw)


_NESTED = {"render": RenderConfig, "model": ModelConfig,
           "train": TrainConfig, "sam": SamTrainConfig,
           "mask": MaskTrainConfig, "data": DataConfig}


def config_from_dict(cls, d: dict):
    """Rebuild a frozen config from a JSON dict (a dataclasses.asdict round
    trip): lists become tuples again; unknown keys are ignored so older
    serialized configs keep loading; a `Config`'s sections, given as dicts,
    are rebuilt as their own configs."""
    names = {f.name for f in dataclasses.fields(cls)}
    kw = {}
    for k, v in d.items():
        if k not in names:
            continue
        if cls is Config and k in _NESTED and isinstance(v, dict):
            v = config_from_dict(_NESTED[k], v)
        kw[k] = tuple(v) if isinstance(v, list) else v
    return cls(**kw)
