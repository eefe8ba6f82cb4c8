from pylidar_slam_tpu_torch.config import Registry

# Registry of pose-regression networks.
POSENET = Registry("posenet", type_key="type")

from pylidar_slam_tpu_torch.models import posenet  # noqa: E402,F401  (registration)
