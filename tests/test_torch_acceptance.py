"""The port's card-recorded acceptance fixture and its code stamp.

``tests/fixtures/torch_e2e.npz`` holds both champions' trajectories over the
140-frame acceptance sequence, recorded on the card by ``python -m
pylidar_slam_tpu_torch.eval.record_e2e``.  These tests hold it to the
reference's own runs on the same sequence (``reference_e2e.npz``), as
``tests/test_reference_parity.py`` holds the JAX package's ``ours_e2e.npz``,
and hold its stamp to the sources: a change on a champion path fails
``test_fixture_stamp_matches_current_code`` until the fixture is recorded
again on the card.
"""
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from pylidar_slam_tpu.eval.eval_odometry import \
    compute_kitti_metrics as jax_kitti_metrics

from pylidar_slam_tpu_torch.dataset.synthetic import (SyntheticConfig,
                                                      SyntheticDatasetLoader)
from pylidar_slam_tpu_torch.eval import acceptance, record_e2e
from pylidar_slam_tpu_torch.eval.eval_odometry import (compute_absolute_poses,
                                                        compute_kitti_metrics)

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "fixtures"
BAR_PT = 0.001  # the round's bar: within 0.1 pt of the reference's tr_err
RERECORD = "re-record it on the card: python -m pylidar_slam_tpu_torch.eval.record_e2e"


@pytest.fixture(scope="module")
def ours():
    assert record_e2e.FIXTURE.exists(), f"missing {record_e2e.FIXTURE.name}: {RERECORD}"
    return np.load(record_e2e.FIXTURE)


@pytest.fixture(scope="module")
def reference():
    return np.load(FIXTURES / "reference_e2e.npz")


def test_fixture_sequence_is_the_references(ours, reference):
    np.testing.assert_array_equal(ours["seq_params"], reference["seq_params"])
    np.testing.assert_allclose(ours["gt_absolute"], reference["gt_absolute"], atol=1e-9)


def test_fixture_ground_truth_is_the_ports_synthetic_sequence(ours):
    loader = SyntheticDatasetLoader(SyntheticConfig(**acceptance.SEQ_KW))
    gt = compute_absolute_poses(loader.get_ground_truth("synth_00"))
    np.testing.assert_allclose(ours["gt_absolute"], gt, atol=1e-9)


def test_fixture_was_recorded_on_the_card(ours):
    card = str(ours["card"])
    assert card and card != "cpu", f"recorded on {card!r}"


@pytest.mark.parametrize("name", ["aggregated", "surfel"])
def test_fixture_tr_err_integrity(ours, name):
    """tr_err recomputed from the recorded trajectory, by the port's and by
    the JAX package's metric, equals the stored value."""
    traj = ours[f"{name}_trajectory"]
    assert traj.shape == ours["gt_absolute"].shape and np.all(np.isfinite(traj))
    for metrics in (compute_kitti_metrics, jax_kitti_metrics):
        tr_err, _, _ = metrics(traj, ours["gt_absolute"])
        np.testing.assert_allclose(tr_err, float(ours[f"{name}_tr_err"]), atol=1e-9)


@pytest.mark.parametrize("name,bar", [("aggregated", "kdtree"), ("aggregated", "projective"),
                                      ("surfel", "kdtree")])
def test_e2e_accuracy_vs_reference(ours, reference, name, bar):
    """The champion's card trajectory within 0.1 pt absolute tr_err of the
    reference's `bar` mode on the same sequence (the reference's kd-tree
    mode is its best)."""
    tr_err, _, _ = compute_kitti_metrics(ours[f"{name}_trajectory"], ours["gt_absolute"])
    ref = float(reference[f"{bar}_tr_err"])
    assert tr_err <= ref + BAR_PT, (
        f"{name} {tr_err:.6f} vs reference {bar} {ref:.6f} (+0.1 pt bar {ref + BAR_PT:.6f})")


def test_fixture_stamp_matches_current_code(ours):
    recorded = bytes(ours["stamp"]).decode()
    current = acceptance.code_stamp()
    assert recorded == current, (
        f"torch_e2e.npz was recorded under code stamp {recorded[:12]}, the sources "
        f"stamp {current[:12]}: {RERECORD}")


def test_stamp_is_the_same_in_a_fresh_process():
    """No process state (JAX's x64 switch, which this suite's conftest sets,
    the torch build, the working directory) enters the stamp."""
    out = subprocess.run(
        [sys.executable, "-c", "from pylidar_slam_tpu_torch.eval import acceptance; "
                               "print(acceptance.code_stamp())"],
        cwd=REPO / "tests", env={"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin"},
        capture_output=True, text=True, timeout=300, check=True)
    assert out.stdout.strip() == acceptance.code_stamp()


def _copy_sources(dest: Path) -> Path:
    """The package's stamped sources and the host encoder's source under
    `dest`; returns the package copy."""
    pkg = dest / "pylidar_slam_tpu_torch"
    for f in acceptance.stamp_files() + sorted((acceptance.PACKAGE_DIR / "csrc").glob("*.cu")):
        rel = f.relative_to(acceptance.PACKAGE_DIR)
        (pkg / rel).parent.mkdir(parents=True, exist_ok=True)
        shutil.copyfile(f, pkg / rel)
    (dest / "native").mkdir()
    shutil.copyfile(REPO / acceptance.STAMP_NATIVE, dest / acceptance.STAMP_NATIVE)
    return pkg


@pytest.mark.parametrize("source,edit,changes", [
    ("slam/odometry/aggregated_map.py", "\nMAX_TRIPS = 9\n", True),
    ("ops/kernels/assoc_gn.py", "\ndef _unused():\n    return 0\n", True),
    ("csrc/nn_argmin.cu", "\n// a comment\n", True),
    ("csrc/assoc_gn.cu", "\n#define UNUSED_FLAG 1\n", True),
    ("ops/se3.py", "\n# a comment and blank lines\n\n\n", False),
])
def test_stamp_follows_the_sources(tmp_path, source, edit, changes):
    """The stamp of a copy of the sources equals the tree's; editing a
    champion-path source changes it, unless the edit is a comment of a
    Python module."""
    pkg = _copy_sources(tmp_path)
    assert acceptance.code_stamp(pkg) == acceptance.code_stamp()
    with open(pkg / source, "a") as f:
        f.write(edit)
    assert (acceptance.code_stamp(pkg) != acceptance.code_stamp()) == changes


STEP_SCRIPT = """
import dataclasses, sys
import numpy as np
from pylidar_slam_tpu_torch.eval import acceptance
from pylidar_slam_tpu_torch.ops.projection import SphericalProjection
from pylidar_slam_tpu_torch.slam.odometry.icp_odometry import ICPFrameToModel
proj = SphericalProjection(32, 128, acceptance.UP_FOV, acceptance.DOWN_FOV)
rng = np.random.default_rng(0)
for name, cfg in acceptance.champion_configs().items():
    # the champion at a small size: batch 2, fewer map points and targets
    lm = dict(cfg.local_map, points_per_frame=512, target_samples=1024) \\
        if name == "surfel" else cfg.local_map
    cfg = dataclasses.replace(cfg, num_points_padded=4352, batch_size=min(cfg.batch_size, 2),
                              local_map=lm)
    odom = ICPFrameToModel(cfg, projector=proj, device="cpu")
    for _ in range(3):
        odom.process_next_frame({"numpy_pc": (10 * rng.normal(size=(2000, 3))).astype(np.float32)})
    assert np.all(np.isfinite(odom.get_relative_poses()))
for mod in list(sys.modules.values()):
    f = getattr(mod, "__file__", None)
    if mod.__name__.startswith("pylidar_slam_tpu_torch") and f:
        print(f)
"""


def test_stamp_covers_every_module_a_champion_step_loads():
    out = subprocess.run([sys.executable, "-c", STEP_SCRIPT], cwd=REPO, capture_output=True,
                         text=True, timeout=600, check=True)
    loaded = {Path(f).resolve() for f in out.stdout.split()}
    assert any(f.name == "surfel_map.py" for f in loaded)
    missing = sorted(str(f.relative_to(acceptance.PACKAGE_DIR))
                     for f in loaded - set(acceptance.stamp_files()))
    assert not missing, f"modules of a champion step outside the stamp: {missing}"
