"""The plain reference against the program at a tiny size, its control in
the lower precision, and its independence of the program."""
from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import torch

from conftest import REPO, TINY_H, TINY_W, run_cell
from slambench import correct
from slambench.reference import odometry as ref_odometry
from slambench.traffic import generator


def tiny_case(frames=12, batch=4):
    cfg = json.loads((REPO / "slambench/configs/hdl64-aggregated.json").read_text())
    cfg["sensor"].update(lidar_height=TINY_H, lidar_width=TINY_W)
    cfg["program"]["num_points_padded"] = TINY_H * TINY_W + (TINY_H + TINY_W + 1) // 2
    mix = json.loads((REPO / "slambench/traffic/road.json").read_text())
    mix["route"]["cycle_frames"] = frames
    # one cycle of a 128-frame road: the same curvature at a few frames' cost
    mix["route"]["amplitude_m"] *= frames / 128.0
    torch.set_num_threads(4)
    scans = generator.make_scans(mix, cfg["sensor"], 7, "cpu")
    from pylidar_slam_tpu_torch.slam.odometry.icp_odometry import ICPFrameToModel
    from slambench.harness import projector_of
    odom = ICPFrameToModel(dict(cfg["program"], batch_size=batch, device="cpu"),
                           projector=projector_of(cfg["sensor"]), device=torch.device("cpu"))
    for cloud in scans.clouds:
        frame = {"numpy_pc": cloud}
        if batch > 1:
            frame["encoded_upload"] = odom.encode_upload(cloud)
        odom.process_next_frame(frame)
    return cfg, scans.clouds, odom.fetch_params_log()


def test_reference_odometry_agrees_and_its_control_does_not():
    cfg, clouds, ours = tiny_case()
    ref = correct.reference_params(cfg, clouds, len(clouds), "cpu")
    gap_t, gap_r = correct.pose_gaps(ours, ref)
    limits = cfg["checks"]
    assert gap_t < limits["odom_trans_gap_m"] and gap_r < limits["odom_rot_gap_deg"]
    got = correct.numbers(cfg, clouds, len(clouds), {"params": ours}, "cpu", 0, control=True)
    assert got["odom_trans_gap_m"] > cfg["checks"]["odom_trans_gap_m"]


def test_rimg8_encoder_copy_matches_the_program():
    """The reference's frozen copy of the rimg8 encoder against the
    program's (its native encoder where it builds): at most a few plane
    bytes apart."""
    from pylidar_slam_tpu_torch.ops.projection import (SphericalProjection,
                                                       np_encode_range_image)
    _, clouds, _ = tiny_case(frames=4)
    proj = SphericalProjection(TINY_H, TINY_W, 3.0, -24.0)
    sensor = ref_odometry.Sensor(TINY_H, TINY_W, 3.0, -24.0)
    for cloud in clouds:
        ours = np_encode_range_image(cloud, proj, planes=True)
        ref = ref_odometry.encode_rimg8(cloud, sensor)
        assert ours.shape == ref.shape
        assert int((ours != ref).sum()) <= 16


def test_loop_closure_reference_agrees_and_its_control_does_not(tiny_root, capsys):
    """A whole slam-revisit run at the tiny size: the program's constraints
    and trajectory against the reference's, and the control's numbers."""
    rc, line = run_cell(tiny_root, "slam-revisit", seed=5, seconds=4.0, control=True,
                        capsys=capsys)
    assert rc == 0 and line["correct"], line["checks"]
    checks, ctl = line["checks"], line["control"]
    assert checks["lc_event_mismatches"]["value"] == 0
    assert checks["lc_constraint_gap_m"]["value"] < 1e-4
    assert checks["backend_gap_m"]["value"] <= 1e-9
    assert any(ctl[k] > checks[k]["limit"] for k in ctl)


def test_the_reference_imports_nothing_of_the_program():
    script = (f"import sys; sys.path.insert(0, {str(REPO)!r})\n"
              "import slambench.reference.odometry, slambench.reference.loop_closure\n"
              "import slambench.reference.bev\n"
              "print(sorted({m.split('.')[0] for m in sys.modules} & "
              "{'pylidar_slam_tpu_torch', 'pylidar_slam_tpu', 'jax'}))\n")
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def test_pose_gaps_are_inf_on_a_missing_output():
    ref = np.zeros((3, 6), np.float32)
    assert correct.pose_gaps(None, ref) == (float("inf"), float("inf"))
    assert correct.pose_gaps(ref[:2], ref) == (float("inf"), float("inf"))
