"""Each fault the cells can have, planted under a whole run on the CPU at a
tiny size (the card check skipped): ``correct`` must come out false.

The cells run on one card, so the fault of an exchange between chips has no
place here."""
from __future__ import annotations

import pytest
import torch

from conftest import run_cell


def _state_unchanged(monkeypatch):
    """The map insert returns the map as it was."""
    from pylidar_slam_tpu_torch.slam.odometry import aggregated_map as am
    monkeypatch.setattr(am, "insert_scan", lambda state, *a, **k: state)


def _batch_step_wrapper(monkeypatch, broken):
    from pylidar_slam_tpu_torch.slam.odometry import aggregated_map as am
    make = am.make_agg_icp_frame_step

    def patched(*a, **k):
        step, first, batch_step = make(*a, **k)
        return step, first, broken(batch_step)

    monkeypatch.setattr(am, "make_agg_icp_frame_step", patched)


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
    _batch_step_wrapper(monkeypatch, broken)


def _answer_altered(monkeypatch):
    """Each batch's last pose is moved 5 cm where it is produced."""
    def broken(batch_step):
        def run(*a):
            state, delta, last, params, diags = batch_step(*a)
            params = params.clone()
            params[-1, 0] += 0.05
            return state, delta, last, params, diags
        return run
    _batch_step_wrapper(monkeypatch, broken)


def _constraint_altered(monkeypatch):
    """Every loop-closure match's transform is moved 20 cm."""
    from pylidar_slam_tpu_torch.slam.loop_closure import ElevationImageLoopClosure
    match = ElevationImageLoopClosure._match_batch

    def broken(self, *a):
        score, transforms, trips = match(self, *a)
        transforms = transforms.clone()
        transforms[:, 0, 3] += 0.2
        return score, transforms, trips

    monkeypatch.setattr(ElevationImageLoopClosure, "_match_batch", broken)


def _no_candidates(monkeypatch):
    """The candidate search finds nothing: every submap event is stored and
    never matched."""
    from pylidar_slam_tpu_torch.slam.loop_closure import ElevationImageLoopClosure
    event = ElevationImageLoopClosure._event

    def broken(self, aggregated, cand_ids, mid_frame_id):
        return event(self, aggregated, [], mid_frame_id)

    monkeypatch.setattr(ElevationImageLoopClosure, "_event", broken)


def _constraint_dropped(monkeypatch):
    """The loop constraints that the matches hand over never reach the
    backend, though each match counts them as accepted."""
    from pylidar_slam_tpu_torch.slam.loop_closure import ElevationImageLoopClosure
    drain = ElevationImageLoopClosure.drain_pending

    def broken(self, data_dict, wait=True):
        before = set(data_dict)
        drain(self, data_dict, wait)
        for key in set(data_dict) - before:
            del data_dict[key]

    monkeypatch.setattr(ElevationImageLoopClosure, "drain_pending", broken)


def _backend_unchanged(monkeypatch):
    """The backend's optimization leaves its poses as they were."""
    from pylidar_slam_tpu_torch.slam.backend import GraphSLAM
    monkeypatch.setattr(GraphSLAM, "optimize", lambda self, *a, **k: None)


@pytest.mark.parametrize("workload,fault", [
    ("agg-offline", _state_unchanged),
    ("agg-offline", _half_batch),
    ("agg-offline", _answer_altered),
    ("agg-online10hz", _state_unchanged),
    ("slam-revisit", _constraint_altered),
    ("slam-revisit", _no_candidates),
    ("slam-revisit", _constraint_dropped),
    ("slam-revisit", _backend_unchanged),
])
def test_a_planted_fault_fails_the_check(tiny_root, capsys, monkeypatch, workload, fault):
    fault(monkeypatch)
    rc, line = run_cell(tiny_root, workload, seed=9, seconds=3.0, capsys=capsys)
    assert rc == 0
    assert line["correct"] is False, line["checks"]
