"""pyLiDAR-SLAM on PyTorch + hand-written CUDA kernels for NVIDIA Hopper.

A port of ``pylidar_slam_tpu`` (the JAX/TPU package beside it, which stays the
reference): module paths mirror the JAX package so each function's
counterpart is found at the same place.  The package imports ``torch`` and
never ``jax``; only the tests import both.

Slice 1 covers the aggregated-map frame-to-model ICP odometry
(``slam.odometry.icp_odometry.ICPFrameToModel`` in aggregated mode), with the
fused window-association + normal-equation kernel in CUDA
(``ops.kernels.assoc_gn``).  Branches not ported yet raise
``NotImplementedError`` naming their ROADMAP.md item.
"""

__version__ = "0.1.0"

import torch as _torch

# Reduced-precision matmuls / convolutions cost this system accuracy before
# (a bf16 matmul pass doubled the trajectory error): everything runs in full
# float32.  cuDNN convolutions default to TF32 on Ampere+ cards.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
