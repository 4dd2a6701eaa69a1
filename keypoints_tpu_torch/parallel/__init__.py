"""Data parallelism — port of ``keypoints_tpu/parallel``.

JAX's ``data_parallel_mesh`` has no counterpart: the process group that
``multihost.initialize`` joins is the mesh. Nor has ``make_dp_fused_chunk``
as a function: its per-rank in-step sampling lives in
``train.InStepBatches``, and its one dispatch a step is the DP step's CUDA
graph (``training.make_graphed_train_step`` with a group); its scan of
steps in one dispatch is not ported (``dp`` module docstring).
"""

from keypoints_tpu_torch.parallel import multihost
from keypoints_tpu_torch.parallel.dp import (GradBucket, broadcast_rows,
                                             make_dp_extract,
                                             make_dp_train_step, replicate,
                                             shard_batch, shard_generator)

__all__ = ["GradBucket", "broadcast_rows", "make_dp_extract",
           "make_dp_train_step", "multihost", "replicate", "shard_batch",
           "shard_generator"]
