"""Registry of odometry algorithms (discriminator field: ``algorithm``):
``icp_F2M``, the frame-to-model ICP odometry, and ``posenet``, the deep
odometry.
"""
from pylidar_slam_tpu_torch.config import Registry

ODOMETRY = Registry("odometry", type_key="algorithm")


def _register_all():
    from pylidar_slam_tpu_torch.slam.odometry.icp_odometry import (
        ICPFrameToModel, ICPFrameToModelConfig)
    from pylidar_slam_tpu_torch.slam.odometry.posenet_odometry import (
        PoseNetOdometry, PoseNetOdometryConfig)
    ODOMETRY.register("icp_F2M", ICPFrameToModel, ICPFrameToModelConfig)
    ODOMETRY.register("posenet", PoseNetOdometry, PoseNetOdometryConfig)


_register_all()
