"""The port's ICPFrameToModel against the JAX package's on its other
paths (per-frame steps, the f32 upload), its config, and what it refuses;
the tolerances are those of tests/test_torch_odometry.py, whose docstring
gives their reasons.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from pylidar_slam_tpu.eval import acceptance as jacc
from pylidar_slam_tpu.ops import projection as jproj
from pylidar_slam_tpu.slam.odometry.icp_odometry import ICPFrameToModel as JICP

from pylidar_slam_tpu_torch.dataset.synthetic import (
    SyntheticConfig as TCfg, SyntheticDatasetLoader as TLoader)
from pylidar_slam_tpu_torch.eval import acceptance as tacc
from pylidar_slam_tpu_torch.slam.odometry import aggregated_map as tam
from pylidar_slam_tpu_torch.slam.odometry.icp_odometry import ICPFrameToModel as TICP

from test_torch_ct_paths import step_like_jax
from test_torch_odometry import (H, SEQ, TIGHT_FRAMES, W, _assert_poses_close,
                                 _configs, _one_torch_thread)  # noqa: F401

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def frames():
    ds = TLoader(TCfg(**SEQ)).sequences()[0][0][0]
    return [ds[i] for i in range(TIGHT_FRAMES)]


def test_champion_config_matches_the_jax_package():
    t, j = tacc.champion_configs()["aggregated"], jacc.champion_configs()["aggregated"]
    td, jd = dataclasses.asdict(t), dataclasses.asdict(j)
    assert td.pop("device") == "cuda" and jd.pop("device") == "tpu"
    assert td == jd
    assert tacc.SEQ_KW == jacc.SEQ_KW


def test_agg_state_roundtrip():
    rng = np.random.default_rng(0)
    arrays = {"xyz": rng.normal(size=(4, 8, 3)).astype(np.float32),
              "normal": rng.normal(size=(4, 8, 3)).astype(np.float32),
              "rng": rng.random((4, 8)).astype(np.float32),
              "age": rng.integers(0, 20, (4, 8)).astype(np.int32),
              "anchor_from_cur": np.eye(4, dtype=np.float32)}
    back = tam.agg_state_to_numpy(tam.agg_state_from_numpy(arrays, "cpu"))
    for name, a in arrays.items():
        assert back[name].dtype == a.dtype and np.array_equal(back[name], a)


@pytest.mark.parametrize("upload_format", ["rimg8", "f32"])
def test_per_frame_path_matches_jax(frames, upload_format):
    """batch_size=1 (one device step per frame, EI bootstrap through the
    per-frame init) with both ported upload formats.

    f32 clouds are rasterized on the device.  On the synthetic sensor's
    exact pixel-center beams every projected column sits on a .5 rounding
    boundary, where a one-ulp atan2 difference decides the pixel, so the
    f32 case uses de-calibrated beams (0.1 deg jitter) -- the sensors the
    f32 upload exists for."""
    if upload_format == "f32":
        seq = TLoader(TCfg(**dict(SEQ, num_frames=TIGHT_FRAMES,
                                  beam_jitter_deg=0.1))).sequences()[0][0][0]
        frames = [seq[i] for i in range(TIGHT_FRAMES)]
    tcfg, jcfg = _configs(batch_size=1, upload_format=upload_format)
    proj = TLoader(TCfg(**SEQ)).projector()
    t = TICP(tcfg, projector=proj)
    j = JICP(jcfg, projector=jproj.SphericalProjection(*proj))
    j.init()
    for f in frames[:TIGHT_FRAMES]:
        t.process_next_frame(dict(f))
    with jax.enable_x64(False):
        for f in frames[:TIGHT_FRAMES]:
            j.process_next_frame(dict(f))
        jp = j.get_relative_poses()
    _assert_poses_close(t.get_relative_poses(), jp, f"per-frame {upload_format}")


@pytest.mark.parametrize("over,match", [
    (dict(upload_format="rimg16"), "leaves out"),
    (dict(upload_quantization=0.01), "leaves out"),
])
def test_unported_branches_raise(over, match):
    cfg = dataclasses.replace(tacc.champion_configs()["aggregated"], device="cpu", **over)
    with pytest.raises(NotImplementedError, match=match):
        TICP(cfg, projector=TLoader(TCfg(**SEQ)).projector())


def _aggregated_poses(frames, **over):
    tcfg, _ = _configs(batch_size=1, **over)
    t = TICP(tcfg, projector=TLoader(TCfg(**SEQ)).projector())
    for f in frames[:3]:
        t.process_next_frame(dict(f))
    return t.get_relative_poses()


def test_viz_debug_writes_the_model_range_images(frames, tmp_path, monkeypatch):
    """viz_debug: one colormapped model range image per frame after the
    first, under ./viz_debug, and the same poses as without it."""
    monkeypatch.chdir(tmp_path)
    poses = _aggregated_poses(frames, viz_debug=True)
    written = sorted(p.name for p in (tmp_path / "viz_debug").glob("*.png"))
    assert written == ["model_range_000000.png", "model_range_000001.png"]
    assert np.array_equal(poses, _aggregated_poses(frames))


def test_shard_points_is_ignored_on_the_aggregated_map(frames):
    """As in the JAX package, shard_points is read in kdtree mode only: on
    the aggregated map it needs no process group and changes nothing."""
    assert np.array_equal(_aggregated_poses(frames, shard_points=2), _aggregated_poses(frames))


_GN = {"scheme": "geman_mcclure", "sigma": 0.4, "max_iters": 1}


@pytest.mark.parametrize("over", [
    dict(alignment={"mode": "point_to_point_gauss_newton", "gauss_newton_config": _GN}),
    dict(alignment={"gauss_newton_config": dict(_GN, beta_constant_velocity=0.1)}),
    dict(alignment={"elastic": True, "gauss_newton_config": _GN}),
    dict(local_map=dict(tacc.champion_configs()["aggregated"].local_map, model_normals=True)),
    dict(local_map=dict(tacc.champion_configs()["aggregated"].local_map,
                        normals_fit="centered")),
    dict(pose_type="mid_pose"),
], ids=["point_to_point_gauss_newton", "beta_constant_velocity", "elastic",
        "model_normals", "normals_fit_centered", "pose_type_mid_pose"])
def test_former_a5b_branches_step_like_jax(over):
    """The branches that raised before the rest of the aggregated map was
    ported now run: one step each on the CPU from the JAX package's map
    state, held to it as tests/test_torch_ct_paths.py holds every mode."""
    cfg = dataclasses.replace(tacc.champion_configs()["aggregated"], batch_size=1, **over)
    step_like_jax(cfg, label=str(over))


def test_vertex_map_input_raises(frames):
    """Vertex-map inputs run on every map (tests/test_torch_projective.py);
    one that does not fit the projector raises."""
    t = TICP(_configs()[0], projector=TLoader(TCfg(**SEQ)).projector())
    vmap = np.zeros((3, H // 2, W), np.float32)
    with pytest.raises(AssertionError, match="does not fit"):
        t.process_next_frame({"numpy_pc": vmap})


def test_port_imports_no_jax():
    """Every module of the port imports with neither jax nor the JAX package
    loaded (the card's machine has no jax)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import pylidar_slam_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'pylidar_slam_tpu' or m.startswith('pylidar_slam_tpu.')]\n"
        "assert not bad, bad\n"
        "assert len(names) >= 20, names\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
