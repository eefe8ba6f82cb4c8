"""The cells ``kdtree-offline`` and ``slam-straight``: both resolve from their
files, and each fault the surfel map's odometry can have, planted under a
whole run on the CPU, reads ``correct`` false against the configuration's
own reference (``slambench/reference/kdtree_f2m.py``).

The tiny size (32 x 512, a ring of K = 4 frames x S = 512 points, M =
2,048 targets) leaves the map so sparse that most points have fewer than k
neighbours within the gate, where the program's hash-grid k-NN and the
reference's exact k-NN part (PERF.md section 2); the runs here give the
program the exact k-NN (a grid of 8 buckets that holds every point, then
brute force), so that a sound run is correct and a fault is all that can
make it not.  The ``gpu`` case runs the cells at their own size.
"""
from __future__ import annotations

import json

import pytest
import torch

from conftest import make_root, run_cell

NEW_CELLS = {"kdtree-offline": ("hdl64-kdtree-f2m", "road-fullmap", 37),
             "slam-straight": ("hdl64-slam-lc", "road-slam", 61)}


@pytest.fixture
def kdtree_root(tiny_root, monkeypatch):
    path = tiny_root / "slambench/configs/hdl64-kdtree-f2m.json"
    cfg = json.loads(path.read_text())
    cfg["program"]["local_map"].update(local_map_size=4, points_per_frame=512,
                                       target_samples=2048, hash_buckets=8,
                                       hash_capacity=4 * 512)
    path.write_text(json.dumps(cfg))
    from pylidar_slam_tpu_torch.slam.odometry import surfel_map as sm
    from slambench.reference import kdtree_f2m

    def exact_knn(queries, points, slots, voxel, n_buckets, cap, radius, k):
        ids = torch.sort(slots[1].reshape(-1)[slots[1].reshape(-1) >= 0].long()).values
        d = kdtree_f2m.sq_dists(queries, points[ids])
        # k missing neighbours at +inf, index 0, as the grid reports them
        d = torch.cat([d, d.new_full((d.shape[0], k), float("inf"))], dim=1)
        ids = torch.cat([ids, ids.new_zeros(k)])
        d, j = torch.sort(d, dim=1, stable=True)
        return ids[j[:, :k]].to(torch.int32), d[:, :k]

    monkeypatch.setattr(sm, "hash_grid_knn", exact_knn)
    return tiny_root


def test_new_cells_resolve(tiny_root):
    from slambench import harness
    for name, (config, traffic, setup) in NEW_CELLS.items():
        cell = harness.load_cell(tiny_root, name)
        assert cell["cell"]["config"] == config and cell["cell"]["traffic"] == traffic
        assert cell["config"]["name"] == config and callable(cell["reference"])
        mix = cell["traffic"]
        assert "base" not in mix and mix["setup_frames"] == setup
        assert mix["route"]["shape"] == "sine" and mix["batch"] == 12
        assert mix["prep_workers"] == 3 and mix["loop"] == "closed"
    per_layer = {n: {m["name"] for m in harness.load_cell(tiny_root, n)["per_layer"]}
                 for n in NEW_CELLS}
    assert per_layer["kdtree-offline"] == {
        "dispatch_ms_per_frame", "kernels_per_frame", "idle_share", "b2_odom_roofline_share",
        "nn_passes_per_frame", "register_ms_per_frame"}
    assert per_layer["slam-straight"] == {
        "lc_backend_ms_per_frame", "lc_event_ms_per_event", "dispatch_ms_per_frame",
        "kernels_per_frame", "b1_roofline_share", "idle_share"}


def _surfel_wrapper(monkeypatch, broken):
    from pylidar_slam_tpu_torch.slam.odometry import surfel_map as sm
    make = sm.make_surfel_icp_frame_step

    def patched(*a, **k):
        step, first, batch_step = make(*a, **k)
        return step, first, broken(batch_step)

    monkeypatch.setattr(sm, "make_surfel_icp_frame_step", patched)


def _state_unchanged(monkeypatch):
    """The map insert writes nothing into the ring."""
    from pylidar_slam_tpu_torch.slam.odometry import surfel_map as sm
    monkeypatch.setattr(sm, "_rows_write", lambda table, slot, rows, k: table)


def _half_batch(monkeypatch):
    """The batched step runs the first half of its frames; the other half
    get the mean of their poses."""
    def broken(batch_step):
        def run(state, delta, last, pts, msks):
            half = max(1, pts.shape[0] // 2)
            state, delta, last, params, diags = batch_step(state, delta, last,
                                                           pts[:half], msks[:half])
            rest = params.mean(dim=0, keepdim=True).expand(pts.shape[0] - half, 6)
            return state, delta, last, torch.cat([params, rest]), diags
        return run
    _surfel_wrapper(monkeypatch, broken)


def _answer_altered(monkeypatch):
    """Each batch's last pose is moved 5 cm where it is produced."""
    def broken(batch_step):
        def run(*a):
            state, delta, last, params, diags = batch_step(*a)
            params = params.clone()
            params[-1, 0] += 0.05
            return state, delta, last, params, diags
        return run
    _surfel_wrapper(monkeypatch, broken)


def test_sound_run_is_correct(kdtree_root, capsys):
    rc, line = run_cell(kdtree_root, "kdtree-offline", seed=9, seconds=3.0, capsys=capsys)
    assert rc == 0 and line["correct"] is True, line["checks"]


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch, _answer_altered])
def test_a_planted_fault_fails_the_check(kdtree_root, capsys, monkeypatch, fault):
    fault(monkeypatch)
    rc, line = run_cell(kdtree_root, "kdtree-offline", seed=9, seconds=3.0, capsys=capsys)
    assert rc == 0
    assert line["correct"] is False, line["checks"]


@pytest.mark.gpu
@pytest.mark.parametrize("workload", list(NEW_CELLS))
def test_new_cell_is_correct_and_its_control_is_not(card, tmp_path, capsys, workload):
    root = make_root(tmp_path, tiny=False)
    rc, line = run_cell(root, workload, seed=4242, seconds=8.0, control=True, capsys=capsys)
    assert rc == 0 and line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"
    assert any(line["control"][k] > c["limit"] for k, c in line["checks"].items())
