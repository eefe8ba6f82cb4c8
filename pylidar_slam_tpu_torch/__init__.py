"""pyLiDAR-SLAM on PyTorch + hand-written CUDA kernels for NVIDIA Hopper.

A port of ``pylidar_slam_tpu`` (the JAX/TPU package beside it, which stays the
reference): module paths mirror the JAX package so each function's
counterpart is found at the same place.  The package imports ``torch`` and
never ``jax``; only the tests import both.

``slam.odometry.icp_odometry.ICPFrameToModel`` runs the frame-to-model ICP
odometry with the aggregated map, on the fused window-association +
normal-equation kernel in CUDA (``ops.kernels.assoc_gn``), and with the
surfel ("kdtree") map, on the exact 1-NN kernel in CUDA
(``ops.kernels.nn_argmin``).  ``parallel`` runs the point-sharded surfel
odometry and data- and tensor-parallel training over ``torch.distributed``
ranks; ``viz`` writes the map's PLY, views and HTML viewer.  Every upload
codec of the JAX package (f32, packed, rimg, rimg16, rimg8, rimg12 and
int16 with dither) is ported, and a PoseNet checkpoint written by the JAX
trainer loads without JAX (``models.from_jax.read_jax_checkpoint``).
"""

__version__ = "0.1.0"

import torch as _torch

# Reduced-precision matmuls / convolutions cost this system accuracy before
# (a bf16 matmul pass doubled the trajectory error): everything runs in full
# float32.  cuDNN convolutions default to TF32 on Ampere+ cards.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
