"""The port's viz, utils and replay modules against the JAX package's, on
the CPU, on numpy-seeded inputs.

* colors: the viridis table and lookup against matplotlib's, exactly, and
  ``tensor_to_image`` against the JAX package's (which calls matplotlib);
* the PNG writer (zlib + struct) read back by PIL, bit for bit;
* PLY files byte for byte the JAX package's, and read back;
* ``aggregate_map_cloud`` (the voxel dedupe in torch) against the JAX
  package's numpy version, exactly;
* the HTML viewer's page byte for byte the JAX package's for the same
  inputs (payloads and page text);
* the CSV poses byte for byte pandas' (the JAX package's writer), read both
  ways; the timer and the module flags;
* ``save_map``, ``viz_debug`` and the trainer's ``visualize`` through their
  entry points;
* ``python -m pylidar_slam_tpu_torch.replay`` against the root
  ``replay.py`` on runs of both CLIs (the port-vs-JAX CLI bar of
  tests/test_torch_slam.py, 1e-3 m over frames 0-6), and against its own
  run's poses, bit for bit.
"""
import base64
import json
import logging
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from pylidar_slam_tpu.utils import io as jio
from pylidar_slam_tpu.utils import modules as jmodules
from pylidar_slam_tpu.viz import color_map as jcm
from pylidar_slam_tpu.viz import html_viewer as jhtml
from pylidar_slam_tpu.viz import viz3d as jviz3d

from test_torch_odometry import _one_torch_thread  # noqa: F401
from pylidar_slam_tpu_torch.eval import eval_odometry as tev
from pylidar_slam_tpu_torch.utils import io as tio
from pylidar_slam_tpu_torch.utils import modules as tmodules
from pylidar_slam_tpu_torch.utils import timer as ttimer
from pylidar_slam_tpu_torch.viz import color_map as tcm
from pylidar_slam_tpu_torch.viz import html_viewer as thtml
from pylidar_slam_tpu_torch.viz import viz3d as tviz3d
from pylidar_slam_tpu_torch.viz.visualizer import ImageVisualizer

ROOT = Path(__file__).resolve().parents[1]
CLI_TIGHT_M = 1e-3  # tests/test_torch_slam.py's CLI bar, frames 0-6
CLI_TIGHT_FRAMES = 7
CLI = ["dataset=synthetic", "dataset.num_frames=8", "dataset.lidar_height=32",
       "dataset.lidar_width=256", "dataset.num_walls=40", "dataset.num_pillars=25",
       "slam/odometry/local_map=aggregated", "slam.odometry.num_points_padded=16384",
       "slam.odometry.upload_format=rimg8", "slam/odometry/alignment=point_to_plane_GN",
       "slam.odometry.alignment.gauss_newton_config.sigma=0.4",
       "slam.odometry.local_map.max_neighbor_dist=0.6"]


# ----------------------------------------------------------------------------
# colors and images
# ----------------------------------------------------------------------------

def test_viridis_is_matplotlibs():
    import matplotlib
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.uniform(size=20000), np.linspace(0, 1, 4097), [0.0, 1.0]])
    table = matplotlib.colormaps["viridis"]
    assert np.array_equal(tcm._VIRIDIS, np.asarray(table.colors))
    assert np.array_equal(tcm.scalar_gray_cmap(x, "viridis", 0.0, 1.0), table(x)[:, :3])
    values = rng.normal(size=5000) * 7 + 3
    assert np.array_equal(tcm.scalar_gray_cmap(values), jcm.scalar_gray_cmap(values))
    assert np.array_equal(tcm.scalar_gray_cmap(values, z_min=-1.0, z_max=4.0),
                          jcm.scalar_gray_cmap(values, z_min=-1.0, z_max=4.0))
    with pytest.raises(KeyError, match="viridis"):
        tcm.scalar_gray_cmap(values, "jet")


@pytest.mark.parametrize("shape", [(16, 40), (3, 16, 40), (16, 40, 3)])
def test_tensor_to_image_matches_jax(shape):
    arr = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    assert np.array_equal(tcm.tensor_to_image(arr), jcm.tensor_to_image(arr))


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_writer_reads_back_with_pil(tmp_path, channels):
    from PIL import Image
    img = np.random.default_rng(channels).integers(0, 256, (23, 37, channels), dtype=np.uint8)
    path = tmp_path / "x.png"
    tcm.save_image(str(path), img if channels > 1 else img[..., 0])
    back = np.asarray(Image.open(path))
    assert np.array_equal(back.reshape(img.shape), img)


def test_image_visualizer_writes_frames(tmp_path):
    viz = ImageVisualizer(output_dir=str(tmp_path / "v"), use_window=True)
    assert not viz.use_window or "DISPLAY" in __import__("os").environ
    rng_img = np.random.default_rng(2).uniform(1, 50, (16, 64))
    viz.update(rng_img, tag="model_range")
    viz.update(rng_img, tag="model_range")
    from PIL import Image
    frames = sorted((tmp_path / "v").glob("model_range_*.png"))
    assert [f.name for f in frames] == ["model_range_000000.png", "model_range_000001.png"]
    assert np.array_equal(np.asarray(Image.open(frames[0])), jcm.tensor_to_image(rng_img))


# ----------------------------------------------------------------------------
# PLY, the map cloud, the HTML viewer
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("binary", [True, False])
@pytest.mark.parametrize("colors", [None, "float", "uint8"])
def test_ply_bytes_match_jax(tmp_path, binary, colors):
    rng = np.random.default_rng(3)
    pts = (rng.normal(size=(500, 3)) * 10).astype(np.float32)
    col = {None: None, "float": rng.uniform(size=(500, 3)),
           "uint8": rng.integers(0, 256, (500, 3), dtype=np.uint8)}[colors]
    tviz3d.write_ply(str(tmp_path / "t.ply"), pts, colors=col, binary=binary)
    jviz3d.write_ply(str(tmp_path / "j.ply"), pts, colors=col, binary=binary)
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
    back = tviz3d.read_ply(str(tmp_path / "j.ply"))
    assert np.array_equal(back, jviz3d.read_ply(str(tmp_path / "t.ply")))
    np.testing.assert_allclose(back, pts, atol=0 if binary else 1e-5)


def _clouds(seed=4, frames=6, n=3000):
    rng = np.random.default_rng(seed)
    clouds = [(rng.normal(size=(n, 3)) * [6.0, 6.0, 1.0]).astype(np.float32)
              for _ in range(frames)]
    rel = np.tile(np.eye(4), (frames, 1, 1))
    for i in range(1, frames):
        c, s = np.cos(0.05 * i), np.sin(0.05 * i)
        rel[i, :2, :2] = [[c, -s], [s, c]]
        rel[i, :3, 3] = rng.uniform(-1, 1, 3)
    return clouds, rel


@pytest.mark.parametrize("voxel,max_points", [(0.2, 2_000_000), (1.0, 2_000_000),
                                              (0.5, 2000), (0.0, 5000)])
def test_aggregate_map_cloud_matches_jax_exactly(voxel, max_points):
    clouds, rel = _clouds()
    ref = jviz3d.aggregate_map_cloud(clouds, rel, voxel_size=voxel, max_points=max_points)
    ours = tviz3d.aggregate_map_cloud(clouds, rel, voxel_size=voxel, max_points=max_points,
                                      device=torch.device("cpu"))
    host = tviz3d.aggregate_map_cloud_numpy(clouds, rel, voxel_size=voxel,
                                            max_points=max_points)
    assert ours.dtype == ref.dtype == np.float32
    assert np.array_equal(ours, ref) and np.array_equal(host, ref)
    if voxel >= 1.0:
        assert len(ref) < sum(len(c) for c in clouds) // 2  # the dedupe did work


def test_aggregate_map_cloud_chains_poses():
    cloud0 = np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0]])
    rel = np.tile(np.eye(4), (2, 1, 1))
    rel[1, 0, 3] = 1.0
    merged = tviz3d.aggregate_map_cloud([cloud0, cloud0 - [1.0, 0.0, 0.0]], rel,
                                        voxel_size=0.01)
    assert merged.shape[0] == 2


@pytest.mark.parametrize("case", ["colors", "height_colors", "positions", "subsampled"])
def test_html_viewer_matches_jax(tmp_path, case):
    rng = np.random.default_rng(5)
    pts = (rng.normal(size=(4096, 3)) * [20.0, 20.0, 2.0]).astype(np.float32)
    poses = np.tile(np.eye(4), (32, 1, 1))
    poses[:, 0, 3] = np.arange(32) * 0.5
    kw = {"colors": dict(colors=rng.uniform(size=(4096, 3)), trajectory=poses),
          "height_colors": dict(trajectory=poses),
          "positions": dict(trajectory=poses[:, :3, 3], title="t"),
          "subsampled": dict(max_points=1000)}[case]
    ours = thtml.write_html_viewer(str(tmp_path / "t.html"), pts, **kw)
    ref = jhtml.write_html_viewer(str(tmp_path / "j.html"), pts, **kw)
    html = Path(ours).read_text()
    assert html == Path(ref).read_text()
    meta = json.loads(re.search(r"const META = (\{.*?\});", html).group(1))
    q = np.frombuffer(base64.b64decode(re.search(
        r'decode\("([A-Za-z0-9+/=]+)", Uint16Array\)', html).group(1)), np.uint16)
    assert q.size == 3 * meta["n"]


def test_render_map_views_and_trajectory_plots(tmp_path, monkeypatch, caplog):
    pts = (np.random.default_rng(6).normal(size=(3000, 3)) * 5).astype(np.float32)
    poses = np.tile(np.eye(4), (10, 1, 1))
    poses[:, 0, 3] = np.arange(10)
    written = tviz3d.render_map_views(str(tmp_path / "seq"), pts, poses)
    assert [Path(w).name for w in written] == ["seq_map_topdown.png", "seq_map_3d.png"]
    assert all(Path(w).stat().st_size > 1000 for w in written)
    assert tev.draw_trajectory_files([poses[:, 0, 3]], [poses[:, 1, 3]],
                                     str(tmp_path / "traj.png"), labels=["prediction"])
    assert (tmp_path / "traj.png").stat().st_size > 1000
    # without matplotlib (the card's machine): one log line each, no file
    import importlib.util
    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == "matplotlib" else real(name, *a))
    with caplog.at_level(logging.INFO):
        assert tviz3d.render_map_views(str(tmp_path / "none"), pts, poses) == []
        assert not tev.draw_trajectory_files([poses[:, 0, 3]], [poses[:, 1, 3]],
                                             str(tmp_path / "none.png"))
    assert not list(tmp_path.glob("none*"))
    assert sum("need matplotlib" in r.getMessage() for r in caplog.records) == 2


# ----------------------------------------------------------------------------
# utils
# ----------------------------------------------------------------------------

def test_csv_poses_match_pandas_both_ways(tmp_path):
    rng = np.random.default_rng(7)
    poses = np.tile(np.eye(4), (9, 1, 1))
    poses[:, :3, :] = rng.normal(size=(9, 3, 4))
    tio.write_poses_to_disk(str(tmp_path / "t.csv"), poses)
    jio.write_poses_to_disk(str(tmp_path / "j.csv"), poses)
    assert (tmp_path / "t.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()
    # the port reads the JAX package's file back exactly (round-trip parse);
    # pandas' default parser may be one ulp off, so JAX's reading of the
    # port's file is its reading of its own
    assert np.array_equal(tio.read_poses_from_disk(str(tmp_path / "j.csv")), poses)
    assert np.array_equal(jio.read_poses_from_disk(str(tmp_path / "t.csv")),
                          jio.read_poses_from_disk(str(tmp_path / "j.csv")))
    tio.write_kitti_poses(str(tmp_path / "k.txt"), poses)
    np.testing.assert_array_equal(tio.read_kitti_poses(str(tmp_path / "k.txt")),
                                  jio.read_kitti_poses(str(tmp_path / "k.txt")))


def test_timer_and_module_flags():
    d = ttimer.Duration()
    for _ in range(3):
        with d.scope("a"):
            pass
    assert d.counts["a"] == 3 and "over 3 calls" in d.report()
    lines = []
    with ttimer.timer("t", log=lines.append):
        pass
    with ttimer.device_timer("d", log=lines.append) as ctx:
        ctx.sync = torch.ones(3)
    assert lines[0].startswith("[timer] t:") and lines[1].startswith("[device_timer] d:")
    for flag in ("_with_cv2", "_with_o3d", "_with_g2o", "_with_viz3d", "_with_ct_icp"):
        assert getattr(tmodules, flag) == getattr(jmodules, flag), flag


def test_trace_writes_a_chrome_trace(tmp_path):
    with ttimer.trace(str(tmp_path)):
        torch.ones(64).sum()
    assert json.loads((tmp_path / "trace.json").read_text())["traceEvents"]


# ----------------------------------------------------------------------------
# entry points: save_map, visualize, replay
# ----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    from pylidar_slam_tpu_torch import run as trun
    log_dir = tmp_path_factory.mktemp("port_run")
    trun.main(CLI + ["device=cpu", "save_map=true", f"log_dir={log_dir}"])
    return log_dir


def test_save_map_writes_ply_views_and_html(port_run):
    cloud = tviz3d.read_ply(str(port_run / "synth_00_map.ply"))
    assert cloud.shape[0] > 1000 and np.all(np.isfinite(cloud))
    html = (port_run / "synth_00_map.html").read_text()
    meta = json.loads(re.search(r"const META = (\{.*?\});", html).group(1))
    assert meta["n"] == cloud.shape[0] and meta["nTraj"] == 8
    for name in ("synth_00_map_topdown.png", "synth_00_map_3d.png", "trajectory_synth_00.png",
                 "trajectory_synth_00_with_gt.png"):
        assert (port_run / name).stat().st_size > 1000, name


def _replay_port(run_dir, *args):
    from pylidar_slam_tpu_torch import replay as treplay
    return treplay.main(["--root_dir", str(run_dir), "--sequence", "synth_00", *args])


def _absolute(relative):
    return tev.compute_absolute_poses(np.asarray(relative, np.float64))


def test_replay_gives_the_runs_poses(port_run):
    relative = _replay_port(port_run, "--html", str(port_run / "replay.html"))
    saved = np.loadtxt(port_run / "replay_synth_00.poses.txt").reshape(-1, 3, 4)
    assert np.array_equal(saved, relative[:, :3, :])
    run_poses = tio.read_poses_from_disk(str(port_run / "synth_00.poses.txt"))
    assert np.array_equal(_absolute(relative), run_poses)
    assert "const META" in (port_run / "replay.html").read_text()
    window = _replay_port(port_run, "--start_index", "2", "--num_frames", "4",
                          "slam.odometry.max_num_alignments=4")
    assert window.shape == (4, 4, 4)


def test_replay_matches_root_replay_on_both_clis(tmp_path, port_run):
    sys.path.insert(0, str(ROOT))
    import replay as jreplay
    import run as jrun
    jax_run = tmp_path / "jax"
    with jax.enable_x64(False):
        jrun.main(CLI + [f"log_dir={jax_run}"])
    for run_dir in (jax_run, port_run):
        with jax.enable_x64(False):
            ref = jreplay.main(["--root_dir", str(run_dir), "--sequence", "synth_00"])
        ours = _replay_port(run_dir, "device=cpu")
        assert ours.shape == ref.shape == (8, 4, 4)
        np.testing.assert_allclose(_absolute(ours)[:CLI_TIGHT_FRAMES],
                                   _absolute(ref)[:CLI_TIGHT_FRAMES], atol=CLI_TIGHT_M)


def test_replay_module_runs_as_a_script(port_run):
    proc = subprocess.run([sys.executable, "-m", "pylidar_slam_tpu_torch.replay",
                           "--root_dir", str(port_run), "--sequence", "synth_00",
                           "--num_frames", "3"], cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert np.loadtxt(port_run / "replay_synth_00.poses.txt").shape == (3, 12)


def test_trainer_visualize_writes_range_images(tmp_path):
    from test_torch_training_loop import _tiny_trainer
    tr = _tiny_trainer(tmp_path, visualize=True, tensorboard_image_frequency=1,
                       do_eval=False)
    tr.init()
    tr.train(1)
    frames = sorted(p.name for p in (tmp_path / "viz").glob("*.png"))
    # 2 steps x the pair's 2 range images, numbered in the order written
    assert frames == sorted(f"train_vm{k % 2}_{k:06}.png" for k in range(4))
