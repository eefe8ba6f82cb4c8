"""Offline UrbanLoco ground-truth generation (port of
``scripts/generate_urban_loco_gt.py``): walks each sequence's rosbag and
writes ``<seq>.poses.txt`` beside it (host only, numpy).

    python -m pylidar_slam_tpu_torch.dataset.generate_urban_loco_gt --root_dir <dir> \
        [--sequences A B ...]
"""
import argparse

from pylidar_slam_tpu_torch.dataset.urban_loco_dataset import (SEQNAME_TO_FILENAME,
                                                               UrbanLocoConfig,
                                                               UrbanLocoDatasetLoader)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root_dir", required=True)
    parser.add_argument("--sequences", nargs="*", default=list(SEQNAME_TO_FILENAME))
    args = parser.parse_args(argv)
    loader = UrbanLocoDatasetLoader(UrbanLocoConfig(root_dir=args.root_dir))
    loader.generate_ground_truth(args.sequences)


if __name__ == "__main__":
    main()
