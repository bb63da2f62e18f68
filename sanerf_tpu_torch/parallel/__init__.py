"""Data parallelism over torch.distributed (JAX: sanerf_tpu/parallel):
one process per device, the same global batch on every rank, averaged
gradients, sharded renders."""

from sanerf_tpu_torch.parallel.multihost import (distribute_batch,
                                                 global_mesh, initialize,
                                                 local_batch_size,
                                                 process_shard_indices)
from sanerf_tpu_torch.parallel.dp import (Mesh, make_dp_mask_train_step,
                                          make_dp_render,
                                          make_dp_sam_train_step,
                                          make_dp_train_step, make_mesh,
                                          render_frame_dp, replicate_state,
                                          shard_batch, shard_mask_batch)
