"""SAM in PyTorch: the ViT image encoder, prompt encoder, two-way
transformer, mask decoder, predictor and the official checkpoint's
converter (JAX: sanerf_tpu/models/sam/)."""

from sanerf_tpu_torch.models.sam.convert import (convert_checkpoint,
                                                 convert_state_dict)
from sanerf_tpu_torch.models.sam.image_encoder import ViTConfig
from sanerf_tpu_torch.models.sam.predictor import (SamConfig, SamPredictor,
                                                   init_params)

__all__ = ["SamConfig", "SamPredictor", "ViTConfig", "convert_checkpoint",
           "convert_state_dict", "init_params"]
