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
import torch

from pylidar_slam_tpu.eval import acceptance as jacc
from pylidar_slam_tpu.ops import projection as jproj
from pylidar_slam_tpu.slam.odometry.icp_odometry import ICPFrameToModel as JICP

from pylidar_slam_tpu_torch.dataset.synthetic import (
    SyntheticConfig as TCfg, SyntheticDatasetLoader as TLoader)
from pylidar_slam_tpu_torch.eval import acceptance as tacc
from pylidar_slam_tpu_torch.slam.odometry import aggregated_map as tam
from pylidar_slam_tpu_torch.slam.odometry.icp_odometry import ICPFrameToModel as TICP

from test_torch_ct_paths import step_like_jax
from test_torch_odometry import (DRIFT, H, SEQ, TIGHT, TIGHT_FRAMES, W,  # noqa: F401
                                 _assert_poses_close, _configs, _one_torch_thread,
                                 _pose_errors)

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


# upload -> the config fields that select it (the codecs of
# test_torch_codecs.py)
UPLOADS = {"rimg8": {}, "f32": {}, "rimg": {}, "rimg16": {},
           "rimg12": dict(num_points_padded=4 * 2304),  # 4 x its 2,304 rows
           "packed": {}, "int16": dict(upload_format="f32", upload_quantization=0.004),
           "int16_dither": dict(upload_format="f32", upload_quantization=0.004,
                                upload_dither=True)}


def forced_step_gaps(t, j, monkeypatch) -> list:
    """Runs the port's step beside each step of the JAX odometry `j`, from
    the JAX step's own inputs (its map state converted with
    agg_state_from_numpy, the same upload bytes, the same prior), and
    records the pair of relative poses."""
    pairs = []
    step = j._step

    def wrapped(state, delta, points, mask, init):
        tstate = tam.agg_state_from_numpy(
            {k: np.asarray(v) for k, v in state._asdict().items()}, "cpu")
        targs = [torch.from_numpy(np.array(a)) for a in (delta, points, mask, init)]
        out = step(state, delta, points, mask, init)
        pairs.append((t._map.step(tstate, *targs)[2].numpy(), np.asarray(out[2])))
        return out
    monkeypatch.setattr(j, "_step", wrapped)
    return pairs


@pytest.mark.parametrize("upload_format", list(UPLOADS))
def test_per_frame_path_matches_jax(frames, upload_format, monkeypatch):
    """batch_size=1 (one device step per frame, EI bootstrap through the
    per-frame init) with every upload codec.

    f32 clouds are rasterized on the device.  On the synthetic sensor's
    exact pixel-center beams every projected column sits on a .5 rounding
    boundary, where a one-ulp atan2 difference decides the pixel, so every
    case but rimg8 uses de-calibrated beams (0.1 deg jitter) -- the
    sensors the per-pixel codecs exist for.

    Every step of the JAX run is repeated by the port from the same inputs
    (map state, upload bytes, prior) and held to TIGHT.  The free runs are
    held to TIGHT over frames 0-6 for rimg8 and f32, and to DRIFT under the
    other codecs: the two packages' image normal fits part on some
    (ill-conditioned) pixels of frame 0's insert under every upload, f32
    with identical inputs included, and under these codecs the maps carry
    that past TIGHT within frames 0-6 (1.1e-3 to 7.4e-3 m here)."""
    if upload_format != "rimg8":
        seq = TLoader(TCfg(**dict(SEQ, num_frames=TIGHT_FRAMES,
                                  beam_jitter_deg=0.1))).sequences()[0][0][0]
        frames = [seq[i] for i in range(TIGHT_FRAMES)]
    over = dict(dict(upload_format=upload_format), **UPLOADS[upload_format])
    tcfg, jcfg = _configs(batch_size=1, **over)
    proj = TLoader(TCfg(**SEQ)).projector()
    t = TICP(tcfg, projector=proj)
    j = JICP(jcfg, projector=jproj.SphericalProjection(*proj))
    j.init()
    for f in frames[:TIGHT_FRAMES]:
        t.process_next_frame(dict(f))
    forced = forced_step_gaps(TICP(tcfg, projector=proj), j, monkeypatch)
    with jax.enable_x64(False):
        for f in frames[:TIGHT_FRAMES]:
            j.process_next_frame(dict(f))
        jp = j.get_relative_poses()
    assert len(forced) == TIGHT_FRAMES - 1
    trans, rot = _pose_errors(*(np.stack(x).astype(np.float64) for x in zip(*forced)))
    print(f"\nper-frame {upload_format}, each step from the JAX inputs: "
          f"{trans.max():.3e} m, {rot.max():.3e} rad")
    assert trans.max() < TIGHT["trans"] and rot.max() < TIGHT["rot"], (trans, rot)
    tp = t.get_relative_poses()
    if upload_format in ("rimg8", "f32"):
        _assert_poses_close(tp, jp, f"per-frame {upload_format}")
        return
    trans, rot = _pose_errors(tp, jp)
    print(f"per-frame {upload_format}, free runs: {trans.max():.3e} m, {rot.max():.3e} rad")
    assert trans.max() < DRIFT["trans"] and rot.max() < DRIFT["rot"], (trans, rot)


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
