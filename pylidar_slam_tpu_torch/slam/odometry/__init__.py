"""Registry of odometry algorithms (discriminator field: ``algorithm``).

``icp_F2M`` is the frame-to-model ICP odometry; ``posenet``, the deep
odometry, is not ported yet (ROADMAP.md A.15).
"""
from pylidar_slam_tpu_torch.config import Registry

ODOMETRY = Registry("odometry", type_key="algorithm")


class _DeepOdometry:
    def __init__(self, config, **kwargs):
        raise NotImplementedError(
            "the deep (PoseNet) odometry is not ported yet: ROADMAP.md A.15")


def _register_all():
    from pylidar_slam_tpu_torch.slam.odometry.icp_odometry import (
        ICPFrameToModel, ICPFrameToModelConfig, OdometryConfig)
    ODOMETRY.register("icp_F2M", ICPFrameToModel, ICPFrameToModelConfig)
    ODOMETRY.register("posenet", _DeepOdometry, OdometryConfig)


_register_all()
