"""Registry of dataset loaders (discriminator field: ``dataset``), the nine
of the JAX package: the KITTI odometry benchmark, KITTI-360, NCLT, Ford
Campus, NHCD, generic rosbags, UrbanLoco, CT-ICP PLY directories and the
synthetic raycast world.
"""
from pylidar_slam_tpu_torch.config import Registry

DATASET = Registry("dataset", type_key="dataset")


def _register_all():
    from pylidar_slam_tpu_torch.dataset import (ct_icp_dataset, ford_dataset,
                                                kitti_360_dataset, kitti_dataset,
                                                nclt_dataset, nhcd_dataset,
                                                rosbag_dataset, synthetic,
                                                urban_loco_dataset)
    for name, loader, config in (
            ("kitti", kitti_dataset.KITTIDatasetLoader, kitti_dataset.KITTIConfig),
            ("synthetic", synthetic.SyntheticDatasetLoader, synthetic.SyntheticConfig),
            ("kitti_360", kitti_360_dataset.KITTI360DatasetLoader,
             kitti_360_dataset.KITTI360Config),
            ("nclt", nclt_dataset.NCLTDatasetLoader, nclt_dataset.NCLTConfig),
            ("ford_campus", ford_dataset.FordCampusDatasetLoader,
             ford_dataset.FordCampusConfig),
            ("nhcd", nhcd_dataset.NHCDDatasetLoader, nhcd_dataset.NHCDConfig),
            ("rosbag", rosbag_dataset.RosbagDatasetLoader, rosbag_dataset.RosbagConfig),
            ("urban_loco", urban_loco_dataset.UrbanLocoDatasetLoader,
             urban_loco_dataset.UrbanLocoConfig),
            ("ct_icp", ct_icp_dataset.CTICPDatasetLoader, ct_icp_dataset.CTICPConfig)):
        DATASET.register(name, loader, config)


_register_all()
