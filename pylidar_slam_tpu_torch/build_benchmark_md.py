"""Benchmark aggregation CLI (port of the root ``build_benchmark_md.py``).

Recursively scans a directory tree for SLAM run outputs (dirs containing
``metrics.yaml`` + ``<seq>.poses.txt``), recomputes KITTI metrics against the
saved GT poses with the port's ``eval.eval_odometry``, ranks entries by
average translation error, and emits the root script's markdown table with
the stamped git hashes.  It reads YAML with the port's reader and poses with
``utils.io``: no PyYAML and no pandas.

    python -m pylidar_slam_tpu_torch.build_benchmark_md --root_dir .outputs/multirun \
        --output benchmark.md
"""
import argparse
from pathlib import Path

import numpy as np

from pylidar_slam_tpu_torch.config import YAMLError, load_yaml_file
from pylidar_slam_tpu_torch.eval.eval_odometry import compute_kitti_metrics
from pylidar_slam_tpu_torch.utils.io import read_poses_from_disk


def scan_entries(root_dir: Path):
    """Yields (run_dir, git_hash, command, {seq: (tr_err, rot_err, nsecs)})."""
    for metrics_file in sorted(root_dir.rglob("metrics.yaml")):
        run_dir = metrics_file.parent
        git_hash = "unknown"
        config_file = run_dir / "config.yaml"
        if config_file.exists():
            try:
                git_hash = (load_yaml_file(config_file) or {}).get("git_hash", "unknown")
            except YAMLError:
                pass
        # the command line from the stamped overrides
        command = ""
        overrides_file = run_dir / ".hydra" / "overrides.yaml"
        if overrides_file.exists():
            try:
                ovs = load_yaml_file(overrides_file) or []
                command = "python run.py " + " ".join(str(o) for o in ovs)
            except YAMLError:
                pass
        saved_metrics = load_yaml_file(metrics_file) or {}

        entry = {}
        for pose_file in run_dir.glob("*.poses.txt"):
            if pose_file.name.endswith("_gt.poses.txt") or \
                    pose_file.name.startswith("replay_"):
                continue
            seq = pose_file.name[: -len(".poses.txt")]
            gt_file = run_dir / f"{seq}_gt.poses.txt"
            if not gt_file.exists():
                continue
            tr_err, rot_err, _ = compute_kitti_metrics(read_poses_from_disk(pose_file),
                                                       read_poses_from_disk(gt_file))
            nsecs = saved_metrics.get(seq, {}).get("nsecs_per_frame", None)
            if tr_err is not None:
                entry[seq] = (tr_err, rot_err, nsecs)
        if entry:
            yield run_dir, git_hash, command, entry


def build_markdown(root_dir: str, output: str) -> str:
    root = Path(root_dir)
    entries = list(scan_entries(root))
    rows = []
    all_seqs = sorted({s for _, _, _, e in entries for s in e})
    for run_dir, git_hash, command, entry in entries:
        avg_tr = 100.0 * float(np.mean([v[0] for v in entry.values()]))
        times = [v[2] for v in entry.values() if v[2] is not None]
        avg_ms = 1000.0 * float(np.mean(times)) if times else -1.0
        rows.append((avg_tr, avg_ms, run_dir, git_hash, command, entry))
    rows.sort(key=lambda r: r[0])

    lines = ["# Benchmark", "",
             "| run | AVG tr_err (%) | time/frame (ms) | git |" +
             "".join(f" {s} |" for s in all_seqs),
             "|---|---|---|---|" + "---|" * len(all_seqs)]
    for avg_tr, avg_ms, run_dir, git_hash, command, entry in rows:
        seq_cells = "".join(
            f" {100.0 * entry[s][0]:.4f} |" if s in entry else " |"
            for s in all_seqs)
        lines.append(f"| {run_dir.relative_to(root)} | {avg_tr:.4f} | "
                     f"{avg_ms:.3f} | {git_hash[:8]} |" + seq_cells)
    lines.append("")
    lines.append("Command lines (recovered from .hydra/overrides.yaml):")
    for avg_tr, _, run_dir, _, command, _ in rows:
        if command:
            lines.append(f"- `{run_dir.relative_to(root)}` "
                         f"(tr_err {avg_tr:.4f}%): `{command}`")
    text = "\n".join(lines) + "\n"
    with open(output, "w") as f:
        f.write(text)
    print(text)
    return text


def main(argv=None) -> str:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root_dir", default=".outputs")
    parser.add_argument("--output", default="benchmark.md")
    args = parser.parse_args(argv)
    return build_markdown(args.root_dir, args.output)


if __name__ == "__main__":
    main()
