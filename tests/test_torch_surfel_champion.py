"""The surfel champion's k-NN map normals over a sequence: the port
against the JAX package, held by metric, and the port's batched path
against its per-frame path.  Sizes, frames and the reasons for the
tolerances are those of tests/test_torch_surfel.py.
"""
import dataclasses

import jax

from pylidar_slam_tpu.ops import projection as jproj
from pylidar_slam_tpu.slam.odometry.icp_odometry import ICPFrameToModel as JICP

from pylidar_slam_tpu_torch.eval import eval_odometry as tev
from pylidar_slam_tpu_torch.slam.odometry.icp_odometry import ICPFrameToModel as TICP

from test_torch_odometry import DRIFT, TIGHT_FRAMES, _one_torch_thread  # noqa: F401
from test_torch_odometry import _pose_errors
from test_torch_surfel import N, _configs, _run, frames, loader  # noqa: F401


def test_whole_slice_champion_normals(frames, loader):
    """The champion's knn normals, held by metric, and the batched path
    (batch 4, the prior chained on the device) against the per-frame path
    of the port itself over frames 0-6."""
    tcfg, jcfg = _configs()
    t = TICP(tcfg, projector=loader.projector())
    j = JICP(jcfg, projector=jproj.SphericalProjection(*loader.projector()))
    j.init()
    tp = _run(t, frames)
    with jax.enable_x64(False):
        jp = _run(j, frames)
    gt = loader.get_ground_truth("synth_00")[:N]
    t_ate, _ = tev.compute_ate(tp, gt)
    j_ate, _ = tev.compute_ate(jp, gt)
    trans, rot = _pose_errors(tp, jp)
    print(f"\nknn normals: ATE {t_ate:.4f} m (JAX {j_ate:.4f}); max per-frame "
          f"gap {trans.max():.3e} m, {rot.max():.3e} rad")
    assert t_ate < 0.05 and j_ate < 0.05
    assert trans.max() < 5 * DRIFT["trans"] and rot.max() < 5 * DRIFT["rot"]

    tb = TICP(dataclasses.replace(tcfg, batch_size=4), projector=loader.projector())
    bp = _run(tb, frames[:TIGHT_FRAMES])
    trans, rot = _pose_errors(bp, tp[:TIGHT_FRAMES])
    assert trans.max() < 1e-5 and rot.max() < 1e-6
