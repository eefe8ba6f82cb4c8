from pylidar_slam_tpu_torch.utils.checks import assert_debug, check_tensor
