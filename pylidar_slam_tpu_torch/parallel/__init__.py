"""Multi-rank execution (torch port of ``pylidar_slam_tpu.parallel``).

The JAX package is single-controller: one process drives every device
through ``shard_map`` and GSPMD.  The port runs one process per rank under
``torch.distributed``, and each psum of the JAX code becomes an
``all_reduce`` over the ranks of one mesh axis.
"""
from pylidar_slam_tpu_torch.parallel.mesh import Mesh, make_mesh
from pylidar_slam_tpu_torch.parallel.sharded_icp import point_sharded_gauss_newton_step
