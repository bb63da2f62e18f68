"""SAM's decode side in PyTorch: prompt encoder, two-way transformer, mask
decoder and predictor (JAX: sanerf_tpu/models/sam/). The ViT image encoder
is not ported yet; the interactive frame decodes rendered features."""

from sanerf_tpu_torch.models.sam.predictor import (SamConfig, SamPredictor,
                                                   ViTConfig, init_params)

__all__ = ["SamConfig", "SamPredictor", "ViTConfig", "init_params"]
