"""The port's SLAM pipeline against the JAX package's, on the CPU:
initialization, preprocessing, the batched pose stream, ``SLAM`` with loop
closure and the backend, and the CLI.

Tolerances: initialization priors and filters 1e-5 (one float32 op chain
in each framework); the pose streams of batch 1 and batch 4 1e-4 (float32
matrices against float64 rebuilds of the same params).  Whole runs drift
apart as the odometry does (``test_torch_odometry.py``): trajectories are
held at 1e-3 m over frames 0-6 and by metric after; loop pairs must be
identical.
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import pandas as pd
import pytest
import torch

from pylidar_slam_tpu.config import compose as jcompose, dataclass_from_dict as jdfd
from pylidar_slam_tpu.dataset.synthetic import (SyntheticConfig as JCfg,
                                                SyntheticDatasetLoader as JLoader)
from pylidar_slam_tpu.slam import initialization as jinit, preprocessing as jpre
from pylidar_slam_tpu.slam.slam import SLAM as JSLAM, SLAMConfig as JSLAMConfig
from pylidar_slam_tpu.utils import prewarm

from pylidar_slam_tpu_torch.config import compose as tcompose, dataclass_from_dict as tdfd
from pylidar_slam_tpu_torch.dataset.synthetic import (SyntheticConfig as TCfg,
                                                      SyntheticDatasetLoader as TLoader)
from pylidar_slam_tpu_torch.eval import eval_odometry as tev
from pylidar_slam_tpu_torch.ops.kernels import nn_argmin
from pylidar_slam_tpu_torch.slam import initialization as tinit, preprocessing as tpre
from pylidar_slam_tpu_torch.slam.odometry_runner import SLAMRunner
from pylidar_slam_tpu_torch.slam.slam import SLAM as TSLAM, SLAMConfig as TSLAMConfig

ROOT = Path(__file__).resolve().parents[1]
CONFIG = str(ROOT / "config")
TIGHT_M = 1e-3
TIGHT_FRAMES = 7  # frames 0-6


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def frames():
    ds = TLoader(TCfg(num_frames=4, lidar_height=32, lidar_width=256)).sequences()[0][0][0]
    return [ds[i] for i in range(4)]


# -- initialization -------------------------------------------------------------

def test_ni_and_cv_priors():
    ni = tinit.INITIALIZATION.load({"type": "ni"})
    d = {}
    ni.next_frame(d)
    assert d["init_rpose"] is None
    cv = tinit.INITIALIZATION.load({"type": "cv"})
    cv.init()
    d = {}
    cv.next_frame(d)
    np.testing.assert_array_equal(d["init_rpose"], np.eye(4))
    pose = torch.eye(4)
    pose[0, 3] = 1.1
    cv.save_real_motion(pose, {})
    cv.next_frame(d)
    assert d["init_rpose"] is pose  # the odometry's tensor, fed straight back
    ref = jinit.INITIALIZATION.load({"type": "cv"})
    ref.init()
    jd = {}
    ref.next_frame(jd)
    np.testing.assert_array_equal(jd["init_rpose"], np.eye(4))


def test_ei_prior_matches_jax(frames):
    cfg = {"type": "ei", "im_size": 128, "pixel_size": 0.5, "num_yaw_steps": 24}
    ours = tinit.INITIALIZATION.load(cfg, device="cpu")
    with jax.enable_x64(False):
        ref = jinit.INITIALIZATION.load(cfg)
    ours.init(), ref.init()
    for f in frames:
        d_ours, d_ref = dict(f), dict(f)
        ours.next_frame(d_ours)
        with jax.enable_x64(False):
            ref.next_frame(d_ref)
        if d_ref["init_rpose"] is None:
            assert d_ours["init_rpose"] is None
            continue
        np.testing.assert_allclose(d_ours["init_rpose"], np.asarray(d_ref["init_rpose"]),
                                   atol=1e-5)


# -- preprocessing --------------------------------------------------------------

def _filter_frame(frame):
    pc = frame["numpy_pc"]
    ts = np.linspace(0.0, 0.1, len(pc))
    rpose = np.eye(4)
    rpose[:3, :3] = [[np.cos(0.05), -np.sin(0.05), 0], [np.sin(0.05), np.cos(0.05), 0], [0, 0, 1]]
    rpose[:3, 3] = [1.1, 0.05, 0.0]
    return {"numpy_pc": pc, "numpy_pc_timestamps": ts, "init_rpose": rpose}


@pytest.mark.parametrize("name", ["voxelization", "grid_sample", "distortion", "to_tensor",
                                  "grid_sample.yaml"])
def test_filters_match_jax(frames, name):
    if name.endswith(".yaml"):  # the shared config's chain: distortion, grid sample
        cfg = tcompose(CONFIG, "slam", ["dataset=synthetic", "slam/preprocessing=grid_sample"])[
            "slam"]["preprocessing"]
    else:
        cfg = {"filters": {"1": {"filter_name": name, "keys": {"numpy_pc": "pc_tensor"},
                                 "voxel_size": 0.4}}}
    ours, ref = tpre.Preprocessing(cfg, device="cpu"), jpre.Preprocessing(cfg)
    d_ours, d_ref = _filter_frame(frames[1]), _filter_frame(frames[1])
    ours.forward(d_ours)
    with jax.enable_x64(False):
        ref.forward(d_ref)
    assert ours.worker_safe == ref.worker_safe
    assert sorted(d_ours) == sorted(d_ref)
    for key in d_ref:
        a, b = d_ours[key], np.asarray(d_ref[key])
        if isinstance(a, torch.Tensor):
            a = a.numpy()
        assert a.shape == b.shape, key
        np.testing.assert_allclose(a, b, atol=1e-5, err_msg=key)


# -- the batched pose stream ----------------------------------------------------

def _odometry_cfg(batch):
    return {"algorithm": "icp_F2M", "batch_size": batch, "max_num_alignments": 6,
            "data_key": "numpy_pc", "num_points_padded": 16384,
            "local_map": {"type": "aggregated_local_map", "max_neighbor_dist": 0.6},
            "alignment": {"gauss_newton_config": {"scheme": "geman_mcclure", "sigma": 0.4}}}


def test_pose_stream_is_the_same_at_batch_1_and_4():
    """Frames of a batch get their poses when the batch's copy lands; the
    stream handed downstream equals batch 1's frame by frame."""
    loader = TLoader(TCfg(num_frames=10, lidar_height=32, lidar_width=256))
    ds = loader.sequences()[0][0][0]
    # a loop closure that never finds a candidate: its backend takes the stream
    lc = {"type": "elevation_image", "local_map_size": 2, "overlap": 1,
          "min_id_distance": 1000, "im_size": 64, "icp_num_points": 256}
    streams = {}
    for batch in (1, 4):
        slam = TSLAM(TSLAMConfig(initialization={"type": "cv"}, odometry=_odometry_cfg(batch),
                                 loop_closure=lc, backend={"type": "graph_slam"}),
                     projector=loader.projector(), device="cpu")
        slam.init()
        assert slam.odometry.emit_batch_poses
        pending = []
        for i in range(len(ds)):
            slam.process_next_frame(ds[i])
            pending.append(len(slam._deferred_frames))
        slam.finish()
        assert not slam._deferred_frames
        streams[batch] = ([c[1] for c in slam.backend.registered_odometry_constraints()],
                          pending)
    (one, one_pending), (four, four_pending) = streams[1], streams[4]
    assert len(one) == len(four) == len(ds) - 1
    assert max(one_pending) == 0 and max(four_pending) > 0  # batch 4 deferred frames
    for a, b in zip(one, four):
        np.testing.assert_allclose(a, b, atol=1e-4)


# -- SLAM with loop closure and the backend -------------------------------------

# A small run whose every loop candidate matches (each constraint within
# 0.25 m and 1 degree of the ground truth in both packages): 64x512 scans,
# the acceptance world, rimg8 uploads (the f32-upload path differs between
# the packages from the first step, ROADMAP.md C), a submap every 2 frames
# and the nearest eligible submap as the one candidate, so the loop pairs
# are decided by the trajectory, not by a score near its threshold.
SLAM_OVERRIDES = [
    "dataset=synthetic", "dataset.num_frames=24", "dataset.lidar_height=64",
    "dataset.lidar_width=512", "dataset.turn_rate=0.01", "dataset.num_walls=40",
    "dataset.num_pillars=25", "slam/odometry/local_map=aggregated",
    "slam/odometry/alignment=point_to_plane_GN",
    "slam.odometry.alignment.gauss_newton_config.sigma=0.4",
    "slam.odometry.local_map.max_neighbor_dist=0.6", "slam.odometry.max_num_alignments=8",
    "slam.odometry.reassoc_every=8", "slam.odometry.upload_format=rimg8",
    "slam.odometry.num_points_padded=33280",
    "slam/loop_closure=elevation_image", "slam.loop_closure.local_map_size=3",
    "slam.loop_closure.overlap=1", "slam.loop_closure.min_id_distance=6",
    "slam.loop_closure.max_distance=1e6", "slam.loop_closure.im_size=256",
    "slam.loop_closure.pixel_size=0.25", "slam.loop_closure.min_score=0.02",
    "slam.loop_closure.icp_num_points=1024", "slam.loop_closure.max_num_candidates=1",
    "slam/backend=graph_slam"]


def _run_slam(package, overrides):
    if package == "jax":
        cfg = jcompose(CONFIG, "slam", overrides)
        loader = JLoader(jdfd(JCfg, cfg["dataset"]))
        slam = JSLAM(jdfd(JSLAMConfig, cfg["slam"]), projector=loader.projector())
    else:
        cfg = tcompose(CONFIG, "slam", overrides)
        loader = TLoader(tdfd(TCfg, cfg["dataset"]))
        slam = TSLAM(tdfd(TSLAMConfig, cfg["slam"]), projector=loader.projector(),
                     device="cpu")
    slam.init()
    ds = loader.sequences()[0][0][0]
    for i in range(len(ds)):
        slam.process_next_frame(ds[i])
    slam.finish()
    return slam, ds.poses_gt


def _constraint_errors(loops, gt):
    out = []
    for i, j, mat, _ in loops:
        d = np.linalg.inv(np.linalg.inv(gt[i]) @ gt[j]) @ mat
        angle = np.degrees(np.arccos(np.clip((np.trace(d[:3, :3]) - 1) / 2, -1, 1)))
        out.append((np.linalg.norm(d[:3, 3]), angle))
    return np.array(out)


def test_slam_with_loop_closure_matches_jax():
    with jax.enable_x64(False):
        ref, gt = _run_slam("jax", SLAM_OVERRIDES)
        for t in list(prewarm._threads):
            t.join()
    before = nn_argmin.nn_argmin.launches
    ours, _ = _run_slam("torch", SLAM_OVERRIDES)
    assert nn_argmin.nn_argmin.launches == before  # CPU: the plain version

    loops_ref = ref.backend.registered_loop_constraints()
    loops = ours.backend.registered_loop_constraints()
    assert len(loops_ref) > 0
    assert [(i, j) for i, j, *_ in loops] == [(i, j) for i, j, *_ in loops_ref]
    for errs in (_constraint_errors(loops, gt), _constraint_errors(loops_ref, gt)):
        assert errs[:, 0].max() < 0.25 and errs[:, 1].max() < 1.0, errs
    assert sum(s["refine_trips"] for s in ours.loop_closure.match_stats) > 0

    grel = tev.compute_relative_poses(gt)
    odo, odo_ref = ours.odometry.get_relative_poses(), ref.odometry.get_relative_poses()
    a, b = tev.compute_absolute_poses(odo), tev.compute_absolute_poses(odo_ref)
    assert np.abs(a[:TIGHT_FRAMES, :3, 3] - b[:TIGHT_FRAMES, :3, 3]).max() < TIGHT_M
    opt, opt_ref = ours.get_relative_poses(), np.asarray(ref.get_relative_poses())
    assert opt.shape == opt_ref.shape == (len(gt), 4, 4)
    ate, ate_ref = tev.compute_ate(opt, grel)[0], tev.compute_ate(opt_ref, grel)[0]
    assert ate < 0.01 and abs(ate - ate_ref) < 0.002, (ate, ate_ref)
    ate_odo = tev.compute_ate(odo, grel)[0]
    assert abs(ate_odo - tev.compute_ate(odo_ref, grel)[0]) < 0.002


@pytest.mark.slow
def test_slam_loop_closure_full_width_matches_jax():
    """The configuration of tests/test_slam_e2e.py:367-390 at 64x1024 and
    the loop closure's published widths (512 px images, 4096-point refine,
    10 candidates), batch 1, with candidates within 20 m as chip_smoke.py
    runs it (farther ones give spurious peaks around min_score): the loop
    constraints match the ground truth in both packages and the optimized
    trajectories by metric."""
    overrides = [
        "dataset=synthetic", "dataset.num_frames=40", "dataset.turn_rate=0.01",
        "slam/odometry/local_map=aggregated", "slam.odometry.max_num_alignments=6",
        "slam.odometry.num_points_padded=65536", "slam/loop_closure=elevation_image",
        "slam.loop_closure.local_map_size=4", "slam.loop_closure.overlap=1",
        "slam.loop_closure.min_id_distance=9", "slam.loop_closure.max_distance=20",
        "slam/backend=graph_slam"]
    with jax.enable_x64(False):
        ref, gt = _run_slam("jax", overrides)
    ours, _ = _run_slam("torch", overrides)
    loops_ref = ref.backend.registered_loop_constraints()
    loops = ours.backend.registered_loop_constraints()
    assert len(loops) > 0 and len(loops_ref) > 0
    for errs in (_constraint_errors(loops, gt), _constraint_errors(loops_ref, gt)):
        assert errs[:, 0].max() < 0.15 and errs[:, 1].max() < 0.25, errs
    grel = tev.compute_relative_poses(gt)
    ate = tev.compute_ate(ours.get_relative_poses(), grel)[0]
    ate_ref = tev.compute_ate(np.asarray(ref.get_relative_poses()), grel)[0]
    assert ate < 0.05 and abs(ate - ate_ref) < 0.005, (ate, ate_ref)


# -- the CLI ---------------------------------------------------------------------

CLI_OVERRIDES = ["dataset=synthetic", "dataset.num_frames=8", "dataset.lidar_height=32",
                 "dataset.lidar_width=256", "dataset.num_walls=40", "dataset.num_pillars=25",
                 "slam/odometry/local_map=aggregated", "slam.odometry.num_points_padded=16384",
                 "slam.odometry.upload_format=rimg8", "slam/odometry/alignment=point_to_plane_GN",
                 "slam.odometry.alignment.gauss_newton_config.sigma=0.4",
                 "slam.odometry.local_map.max_neighbor_dist=0.6"]


def _read_poses(path):
    df = pd.read_csv(path, sep=",")
    assert list(df.columns) == [str(i) for i in range(12)]
    return df.values.reshape(-1, 3, 4)


def test_cli_run_matches_jax(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "pylidar_slam_tpu_torch.run", *CLI_OVERRIDES, "device=cpu",
         f"log_dir={tmp_path / 'torch'}"], cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    sys.path.insert(0, str(ROOT))
    import run as jrun
    with jax.enable_x64(False):
        jrun.main(CLI_OVERRIDES + [f"log_dir={tmp_path / 'jax'}"])

    import yaml
    metrics = yaml.safe_load((tmp_path / "torch" / "metrics.yaml").read_text())
    ref_metrics = yaml.safe_load((tmp_path / "jax" / "metrics.yaml").read_text())
    assert sorted(metrics) == sorted(ref_metrics) == ["AVG", "synth_00"]
    assert sorted(metrics["synth_00"]) == sorted(ref_metrics["synth_00"])
    assert abs(metrics["synth_00"]["ATE"] - ref_metrics["synth_00"]["ATE"]) < 2e-3
    assert yaml.safe_load((tmp_path / "torch" / ".hydra" / "overrides.yaml").read_text()) \
        == CLI_OVERRIDES + ["device=cpu", f"log_dir={tmp_path / 'torch'}"]
    for name in ("synth_00.poses.txt", "synth_00_gt.poses.txt"):
        ours, ref = _read_poses(tmp_path / "torch" / name), _read_poses(tmp_path / "jax" / name)
        assert ours.shape == ref.shape == (8, 3, 4)
        np.testing.assert_allclose(ours[:TIGHT_FRAMES], ref[:TIGHT_FRAMES], atol=TIGHT_M)
    # the file holds the bytes pandas writes for the same array
    path = tmp_path / "torch" / "synth_00.poses.txt"
    exact = pd.read_csv(path, sep=",", float_precision="round_trip")
    assert path.read_text() == exact.to_csv(sep=",", index=False)


def test_runner_outputs_and_refusals(tmp_path, monkeypatch):
    cfg = tcompose(CONFIG, "slam", CLI_OVERRIDES[:6] + [
        "slam/odometry/local_map=aggregated", "slam.odometry.num_points_padded=16384",
        "slam/loop_closure=elevation_image", "slam.loop_closure.local_map_size=2",
        "slam.loop_closure.overlap=1", "slam.loop_closure.min_id_distance=4",
        "slam.loop_closure.im_size=128", "slam.loop_closure.icp_num_points=512",
        "slam.loop_closure.max_num_candidates=2", "slam/backend=graph_slam",
        "dataset.num_frames=6", "device=cpu", f"log_dir={tmp_path}"])
    runner = SLAMRunner(dict(cfg, save_map=True))
    metrics = runner.run_odometry()
    assert "synth_00" in metrics and "AVG" in metrics
    for name in ("config.yaml", "metrics.yaml", "synth_00.poses.txt",
                 "loop_closure_synth_00.npz", "constraints_synth_00/loop_constraints.txt",
                 "synth_00_map.ply", "synth_00_map.html"):
        assert (tmp_path / name).exists(), name
    odo = pd.read_csv(tmp_path / "constraints_synth_00" / "odometry_constraints.txt", sep=",")
    assert list(odo.columns)[:3] == ["Unnamed: 0", "src", "tgt"] and len(odo) == 5
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device=cpu"):
        SLAMRunner(dict(cfg, device="tpu"))
    from pylidar_slam_tpu_torch import run as trun
    fixed = [o for o in CLI_OVERRIDES if not o.startswith("dataset.num_frames=")]
    out = trun.run_multirun(Path(CONFIG), fixed + [
        "device=cpu", "dataset.num_frames=2,3", "parallel_jobs=2",
        f"log_dir={tmp_path / 'sweep'}"])
    assert len(out) == 2
    for idx, n in enumerate((2, 3)):
        assert len(_read_poses(tmp_path / "sweep" / str(idx) / "synth_00.poses.txt")) == n
