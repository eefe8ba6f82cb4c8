"""``python -m pylidar_slam_tpu_torch.build_benchmark_md`` against the root
``build_benchmark_md.py`` on the outputs of a port multirun on the CPU: two
synthetic jobs of 12 frames (32x256, the aggregated map) at 9.5 and 10.5
m/frame, so that each run spans a KITTI window of 100 m.  The two markdown
texts must be equal byte for byte.

At 10 m/frame a frame lies exactly 100 m from the window's start, where
the window rule (a frame strictly past 100 m) is decided by the last bit of
the parsed ground truth: the port parses it with numpy, correctly rounded
(100.0), the root script with pandas' fast parser (100.00000000000001), and
the two tables then differ (ROADMAP.md §C10).  A second test pins that edge
on one run at 10 m/frame: the two parses differ in the last bits only, the
port's metric and the JAX package's agree exactly on either parse, and only
the parse moves the table.  A third holds the YAML errors to the root
script's: a config or overrides file it cannot read is passed over, a
metrics file it cannot read raises."""
import numpy as np
import pytest
import yaml

import build_benchmark_md as root_bbm
from pylidar_slam_tpu.eval.eval_odometry import compute_kitti_metrics as jcompute_kitti_metrics

from test_torch_odometry import _one_torch_thread  # noqa: F401
from pylidar_slam_tpu_torch import build_benchmark_md
from pylidar_slam_tpu_torch import run as trun
from pylidar_slam_tpu_torch.config import YAMLError
from pylidar_slam_tpu_torch.eval.eval_odometry import compute_kitti_metrics
from pylidar_slam_tpu_torch.utils.io import read_poses_from_disk, write_poses_to_disk

JOB = ["dataset=synthetic", "dataset.num_frames=12", "dataset.lidar_height=32",
       "dataset.lidar_width=256", "slam.odometry.max_num_alignments=2",
       "slam.odometry.num_points_padded=8192", "slam/odometry/local_map=aggregated",
       "device=cpu"]
MULTIRUN = ["-m"] + JOB + ["dataset.speed=9.5,10.5"]
BROKEN_YAML = "a: [1, 2"  # an unclosed flow sequence: an error to both readers


def test_markdown_equals_the_root_scripts(tmp_path, capsys):
    sweep = tmp_path / "multirun"
    trun.main(MULTIRUN + [f"log_dir={sweep}"])
    ours = build_benchmark_md.main(["--root_dir", str(sweep),
                                    "--output", str(tmp_path / "ours.md")])
    ref = root_bbm.build_markdown(str(sweep), str(tmp_path / "ref.md"))
    capsys.readouterr()
    assert (tmp_path / "ours.md").read_bytes() == (tmp_path / "ref.md").read_bytes()
    assert ours == ref
    lines = ours.splitlines()
    rows = [line for line in lines if line.startswith("| 0 ") or line.startswith("| 1 ")]
    assert len(rows) == 2  # both jobs span a 100 m window
    assert all(np.isfinite(float(r.split("|")[2])) for r in rows)
    assert sum(line.startswith("- `") for line in lines) == 2  # their command lines


def _table_rows(markdown: str) -> list:
    return [line for line in markdown.splitlines()
            if line.startswith("| ") and not line.startswith("| run ")]


def test_the_100m_edge_differs_only_in_the_parse(tmp_path, capsys):
    run = tmp_path / "edge"
    trun.main(JOB + ["dataset.speed=10.0", f"log_dir={run}"])
    parsed = {}
    for name in ("synth_00", "synth_00_gt"):
        path = run / f"{name}.poses.txt"
        ours, pandas_ = read_poses_from_disk(path), root_bbm.load_absolute_poses(path)
        rows = np.array([[float(x) for x in line.split(",")]
                         for line in path.read_text().splitlines()[1:]])
        # numpy parses every decimal correctly rounded, as float() does;
        # pandas' fast parser misses some by the last bits
        assert np.array_equal(ours[:, :3].reshape(len(rows), 12), rows)
        assert not np.array_equal(ours, pandas_)
        np.testing.assert_allclose(pandas_, ours, rtol=0, atol=1e-13)
        parsed[name] = (ours, pandas_)
    tr_errs = []
    for k in (0, 1):  # the port's parse, then the root script's
        est, gt = parsed["synth_00"][k], parsed["synth_00_gt"][k]
        tr_err, rot_err, _ = compute_kitti_metrics(est, gt)
        assert (tr_err, rot_err) == jcompute_kitti_metrics(est, gt)[:2]
        tr_errs.append(tr_err)
    assert tr_errs[0] != tr_errs[1]  # the window at the edge counts under one parse only
    ours = build_benchmark_md.main(["--root_dir", str(run), "--output", str(tmp_path / "o.md")])
    ref = root_bbm.build_markdown(str(run), str(tmp_path / "r.md"))
    capsys.readouterr()
    [our_row], [ref_row] = _table_rows(ours), _table_rows(ref)
    assert f" {100.0 * tr_errs[0]:.4f} |" in our_row
    assert f" {100.0 * tr_errs[1]:.4f} |" in ref_row
    assert our_row != ref_row


def _fabricated_run(run_dir):
    """A straight 9.5 m/frame ground truth over 12 frames, an estimate that
    drifts sideways, and their metrics.yaml, as the runner writes them."""
    run_dir.mkdir(parents=True)
    gt = np.tile(np.eye(4), (12, 1, 1))
    gt[:, 0, 3] = 9.5 * np.arange(12)
    est = gt.copy()
    est[:, 1, 3] = 0.01 * np.arange(12) ** 1.5
    write_poses_to_disk(str(run_dir / "synth_00_gt.poses.txt"), gt)
    write_poses_to_disk(str(run_dir / "synth_00.poses.txt"), est)
    (run_dir / "metrics.yaml").write_text("synth_00:\n  nsecs_per_frame: 0.05\n")
    (run_dir / "config.yaml").write_text("git_hash: 0123456789abcdef\n")
    (run_dir / ".hydra").mkdir()
    (run_dir / ".hydra" / "overrides.yaml").write_text("- dataset=synthetic\n")


@pytest.mark.parametrize("broken", ["config.yaml", ".hydra/overrides.yaml", "metrics.yaml"])
def test_yaml_errors_as_the_root_script(tmp_path, capsys, broken):
    root = tmp_path / "runs"
    _fabricated_run(root / "0")
    (root / "0" / broken).write_text(BROKEN_YAML)
    if broken == "metrics.yaml":
        with pytest.raises(yaml.YAMLError):
            root_bbm.build_markdown(str(root), str(tmp_path / "r.md"))
        with pytest.raises(YAMLError):
            build_benchmark_md.main(["--root_dir", str(root), "--output", str(tmp_path / "o.md")])
        return
    ours = build_benchmark_md.main(["--root_dir", str(root), "--output", str(tmp_path / "o.md")])
    ref = root_bbm.build_markdown(str(root), str(tmp_path / "r.md"))
    capsys.readouterr()
    assert ours == ref
    [row] = _table_rows(ours)
    assert ("| unknown |" in row) == (broken == "config.yaml")
    assert any(line.startswith("- `") for line in ours.splitlines()) == \
        (broken == "config.yaml")
