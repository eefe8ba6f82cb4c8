"""Cloud-to-cloud exact nearest neighbours (torch port of the part of
``pylidar_slam_tpu.ops.icp3d`` the surfel map needs; ``icp_align`` waits
for the loop closure, ROADMAP.md A.16).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from pylidar_slam_tpu_torch.ops.kernels.nn_argmin import nn_argmin


def brute_force_nn(queries: torch.Tensor, refs: torch.Tensor,
                   ref_mask: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact 1-NN: (M, 3) queries vs (V, 3) refs -> (idx (M,) int32,
    sq_dist (M,)); lowest index on ties, index 0 / +inf when no ref is
    valid.  Kernel B2 on CUDA tensors, its plain version
    (``nn_argmin_plain``, the JAX function's chunked composite) on CPU
    tensors."""
    return nn_argmin(queries, refs, ref_mask)
