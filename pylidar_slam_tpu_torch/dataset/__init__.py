"""Registry of dataset loaders (discriminator field: ``dataset``).

``synthetic`` is ported; every other loader of the JAX package raises
``NotImplementedError`` (ROADMAP.md A.17).
"""
from pylidar_slam_tpu_torch.config import Registry

DATASET = Registry("dataset", type_key="dataset")

# The JAX package's other loaders, not ported yet.
UNPORTED = ("kitti", "kitti_360", "nclt", "ford_campus", "nhcd", "rosbag",
            "urban_loco", "ct_icp")


class _Unported:
    def __init__(self, config, **kwargs):
        raise NotImplementedError(
            f"dataset '{config.dataset}' is not ported yet: ROADMAP.md A.17")


def _register_all():
    from pylidar_slam_tpu_torch.dataset.configuration import DatasetConfig
    from pylidar_slam_tpu_torch.dataset.synthetic import (SyntheticConfig,
                                                          SyntheticDatasetLoader)
    DATASET.register("synthetic", SyntheticDatasetLoader, SyntheticConfig)
    for name in UNPORTED:
        DATASET.register(name, _Unported, DatasetConfig)


_register_all()
