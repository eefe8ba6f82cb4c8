"""Deterministic re-run of a previous SLAM run (torch port of the root
``replay.py``):

    python -m pylidar_slam_tpu_torch.replay --root_dir <run dir> --sequence 00 \\
        [--start_index 0] [--num_frames -1] [--lc_state <npz>] [--html <file>] \\
        [overrides...]

Loads the run's saved ``config.yaml`` (the port's own YAML reader), applies
the overrides (``key=value``, as on the CLI), windows the sequence and runs
the SLAM loop over it without the runner's evaluation, on the device the
config names.  ``--lc_state`` restores a saved loop-closure state first;
``--html`` writes the interactive viewer of the window's map and
trajectory.  The relative poses go to
``<root_dir>/replay_<sequence>.poses.txt`` (KITTI rows).
"""
from __future__ import annotations

import argparse
import logging
from pathlib import Path

import numpy as np

from pylidar_slam_tpu_torch.config import (_deep_set, _parse_scalar, dataclass_from_dict,
                                           load_yaml_file)
from pylidar_slam_tpu_torch.dataset import DATASET
from pylidar_slam_tpu_torch.dataset.configuration import WindowDataset
from pylidar_slam_tpu_torch.slam.odometry_runner import resolve_device
from pylidar_slam_tpu_torch.slam.slam import SLAM, SLAMConfig


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser()
    parser.add_argument("--root_dir", required=True,
                        help="A previous run directory containing config.yaml")
    parser.add_argument("--sequence", required=True)
    parser.add_argument("--start_index", type=int, default=0)
    parser.add_argument("--num_frames", type=int, default=-1)
    parser.add_argument("--lc_state", default="",
                        help="Path to a loop_closure_<seq>.npz saved by a previous run; "
                             "restores the submap state so the replay resumes with its "
                             "loop-closure context")
    parser.add_argument("--html", default="",
                        help="Write an interactive WebGL viewer (map + trajectory) of "
                             "the replayed window to this path")
    parser.add_argument("overrides", nargs="*", default=[])
    args = parser.parse_args(argv)

    config_path = Path(args.root_dir) / "config.yaml"
    assert config_path.exists(), f"No config.yaml under {args.root_dir}"
    saved = load_yaml_file(config_path)
    cfg = saved["config"] if "config" in saved else saved

    for override in args.overrides:
        key, value = override.split("=", 1)
        _deep_set(cfg, key, _parse_scalar(value))

    device = resolve_device(cfg.get("device"))
    dataset_loader = DATASET.load(dict(cfg["dataset"]))
    (datasets, names), _, _, _ = dataset_loader.sequences()
    assert args.sequence in names, f"Unknown sequence {args.sequence} ({names})"
    dataset = datasets[names.index(args.sequence)]
    length = args.num_frames if args.num_frames > 0 else len(dataset) - args.start_index
    window = WindowDataset(dataset, args.start_index, length)

    slam = SLAM(dataclass_from_dict(SLAMConfig, dict(cfg["slam"])),
                projector=dataset_loader.projector(), pose=cfg.get("pose", "euler"),
                device=device)
    slam.init()
    if args.lc_state:
        assert slam.loop_closure is not None, \
            "--lc_state given but the replayed config has no loop closure"
        slam.loop_closure.load_state(args.lc_state)
        logging.info("restored loop-closure state from %s", args.lc_state)
    clouds = []
    for i in range(len(window)):
        frame = window[i]
        if args.html and "numpy_pc" in frame:
            clouds.append(np.asarray(frame["numpy_pc"], np.float32)[:, :3])
        slam.host_prepare(frame)  # what the runner's loader threads do
        slam.process_next_frame(frame)
        if (i + 1) % 50 == 0:
            logging.info("replayed %d / %d frames", i + 1, len(window))
    slam.finish()

    relative = slam.get_relative_poses()
    if args.html and clouds:
        from pylidar_slam_tpu_torch.viz.html_viewer import write_html_viewer
        from pylidar_slam_tpu_torch.viz.viz3d import aggregate_map_cloud
        absolutes = [np.eye(4)]
        for rel in relative[1:]:
            absolutes.append(absolutes[-1] @ np.asarray(rel, np.float64))
        cloud = aggregate_map_cloud(clouds, relative, device=device)
        write_html_viewer(args.html, cloud, trajectory=np.stack(absolutes),
                          title=f"replay {args.sequence}")
        logging.info("wrote interactive viewer -> %s", args.html)
    out_file = Path(args.root_dir) / f"replay_{args.sequence}.poses.txt"
    np.savetxt(str(out_file), relative[:, :3, :].reshape(len(relative), 12))
    logging.info("Replay done: %d poses -> %s", len(relative), out_file)
    return relative


if __name__ == "__main__":
    main()
