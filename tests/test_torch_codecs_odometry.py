"""The port's odometry under each upload codec against the JAX package's,
on the CPU, on de-calibrated beams (0.1 deg jitter): the batched aggregated
map, the surfel and the voxel map under rimg.  The per-frame aggregated
path is held in tests/test_torch_odometry_paths.py
(``test_per_frame_path_matches_jax``), each codec's buffers and decoders in
tests/test_torch_codecs.py.

The batched runs upload the same bytes, batch for batch (the dither drawn
in frame order on both sides), and their poses are held to DRIFT
(tests/test_torch_odometry.py), for the reason
``test_per_frame_path_matches_jax`` gives.
"""
import dataclasses

import jax
import numpy as np
import pytest

from pylidar_slam_tpu.ops import projection as jproj
from pylidar_slam_tpu.slam.odometry.icp_odometry import ICPFrameToModel as JICP

from test_torch_odometry import (DRIFT, SEQ, TIGHT_FRAMES, _capture_diags,  # noqa: F401
                                 _configs, _one_torch_thread, _pose_errors)
from test_torch_odometry_paths import UPLOADS
from test_torch_surfel import TIGHT as SURFEL_TIGHT
from test_torch_surfel import _configs as surfel_configs
from test_torch_surfel import _run
from test_torch_voxel_map import SEQ as VOXEL_SEQ
from test_torch_voxel_map import _config as voxel_config
from pylidar_slam_tpu_torch.dataset.synthetic import (
    SyntheticConfig as TCfg, SyntheticDatasetLoader as TLoader)
from pylidar_slam_tpu_torch.eval import eval_odometry as tev
from pylidar_slam_tpu_torch.slam.odometry.icp_odometry import ICPFrameToModel as TICP

N = 9  # frame 0, two batches of 4
JITTERED = dict(SEQ, num_frames=N, beam_jitter_deg=0.1)


@pytest.fixture(scope="module")
def loader():
    return TLoader(TCfg(**JITTERED))


@pytest.fixture(scope="module")
def frames(loader):
    ds = loader.sequences()[0][0][0]
    return [ds[i] for i in range(N)]


def _pair(loader, **over):
    tcfg, jcfg = _configs(**over)
    t = TICP(tcfg, projector=loader.projector())
    j = JICP(jcfg, projector=jproj.SphericalProjection(*loader.projector()))
    j.init()
    return t, j


def _record_batches(odom, monkeypatch) -> list:
    """The host bytes of every batch the odometry's batched step receives."""
    seen = []
    local_map = getattr(odom, "_map", None)  # the port drives its map's record
    batch_step = odom._batch_step if local_map is None else local_map.batch_step

    def wrapped(state, delta, rpose, points, masks):
        seen.append(np.array(points))
        return batch_step(state, delta, rpose, points, masks)
    if local_map is None:
        monkeypatch.setattr(odom, "_batch_step", wrapped)
    else:
        monkeypatch.setattr(odom, "_map", local_map._replace(batch_step=wrapped))
    return seen


def _feed(odom, frames):
    for f in frames:
        odom.process_next_frame(dict(f))
    odom.finish()
    return odom.get_relative_poses()


@pytest.mark.parametrize("upload", [u for u in UPLOADS if u not in ("rimg8", "f32")])
def test_batched_codec_matches_jax(loader, frames, upload, monkeypatch):
    over = dict(dict(upload_format=upload, batch_size=4), **UPLOADS[upload])
    t, j = _pair(loader, **over)
    tb, jb = _record_batches(t, monkeypatch), _record_batches(j, monkeypatch)
    tp = _feed(t, frames)
    with jax.enable_x64(False):
        jp = _feed(j, frames)
    assert len(tb) == len(jb) == 2
    for a, b in zip(tb, jb):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert tp.shape == jp.shape == (N, 4, 4)
    trans, rot = _pose_errors(tp, jp)
    print(f"\nbatched {upload}: max per-frame gap {trans.max():.3e} m, {rot.max():.3e} rad")
    assert trans.max() < DRIFT["trans"] and rot.max() < DRIFT["rot"], (trans, rot)
    gt = loader.get_ground_truth("synth_00")[:N]
    t_ate, _ = tev.compute_ate(tp, gt)
    j_ate, _ = tev.compute_ate(jp, gt)
    assert t_ate < 0.05 and abs(t_ate - j_ate) < 0.2 * j_ate + 2e-3


def test_surfel_map_under_rimg(frames, loader, monkeypatch):
    """The surfel map (image normals, exact NN) at batch 1 under rimg, at
    tests/test_torch_surfel.py's bars, with the same insert decisions."""
    tcfg, jcfg = surfel_configs(normals_mode="image", nn_backend="exact")
    over = dict(upload_format="rimg", batch_size=1)
    t = TICP(dataclasses.replace(tcfg, **over), projector=loader.projector())
    j = JICP(dataclasses.replace(jcfg, **over),
             projector=jproj.SphericalProjection(*loader.projector()))
    j.init()
    tlog = _capture_diags(t, lambda x: x.numpy(), monkeypatch)
    jlog = _capture_diags(j, np.asarray, monkeypatch)
    tp = _run(t, frames)
    with jax.enable_x64(False):
        jp = _run(j, frames)
    assert [bool(d[3]) for d in tlog] == [bool(d[3]) for d in jlog]
    trans, rot = _pose_errors(tp, jp)
    print(f"\nsurfel map, rimg: max per-frame gap {trans.max():.3e} m, {rot.max():.3e} rad "
          f"(frames < {TIGHT_FRAMES}: {trans[:TIGHT_FRAMES].max():.3e} m)")
    assert trans[:TIGHT_FRAMES].max() < SURFEL_TIGHT["trans"]
    assert rot[:TIGHT_FRAMES].max() < SURFEL_TIGHT["rot"]
    assert trans.max() < DRIFT["trans"] and rot.max() < DRIFT["rot"]


def test_voxel_map_under_rimg(monkeypatch):
    """The voxel map's bench configuration at 64x1024 (it does not track at
    32x256) under rimg, batch 1, frames 0-6: DRIFT, as its rimg8 case in
    tests/test_torch_voxel_map.py, with the same insert decisions."""
    vloader = TLoader(TCfg(**dict(VOXEL_SEQ, beam_jitter_deg=0.1)))
    ds = vloader.sequences()[0][0][0]
    vframes = [ds[i] for i in range(len(ds))]
    tcfg, jcfg = voxel_config(batch_size=1, upload_format="rimg", num_points_padded=65536)
    t = TICP(tcfg, projector=vloader.projector())
    j = JICP(jcfg, projector=jproj.SphericalProjection(*vloader.projector()))
    j.init()
    tlog = _capture_diags(t, lambda x: x.numpy(), monkeypatch)
    jlog = _capture_diags(j, np.asarray, monkeypatch)
    tp = _run(t, vframes)
    with jax.enable_x64(False):
        jp = _run(j, vframes)
    assert [bool(d[3]) for d in tlog] == [bool(d[3]) for d in jlog]
    trans, rot = _pose_errors(tp, jp)
    print(f"\nvoxel map, rimg: max per-frame gap {trans.max():.3e} m, {rot.max():.3e} rad")
    assert trans.max() < DRIFT["trans"] and rot.max() < DRIFT["rot"]
