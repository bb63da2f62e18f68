"""Ops of the port: plain PyTorch math, and the wrappers of the CUDA
kernels (ray_kernels, fused_mlp_t, gather), each beside its plain version."""

from sanerf_tpu_torch.ops.activation import shifted_softplus, trunc_exp
from sanerf_tpu_torch.ops.composite import (composite, compute_weights,
                                            compute_weights_from_deltas)
from sanerf_tpu_torch.ops.sampling import (contract, contract_T,
                                           near_far_from_aabb, sample_pdf,
                                           spacing_fn, spacing_fn_inv,
                                           uncontract, uniform_bins)

__all__ = [
    "shifted_softplus", "trunc_exp", "composite", "compute_weights",
    "compute_weights_from_deltas", "contract", "contract_T",
    "near_far_from_aabb", "sample_pdf", "spacing_fn", "spacing_fn_inv",
    "uncontract", "uniform_bins",
]
