"""The loop closure's warm-up at ``init()``, and its submap event inline on
the pipeline thread, on the CPU.

The warm-up runs the match path on zeros and builds one image, at the
event's shapes, and must leave every answer as it was: a run with it and a
run without it (``_prewarm`` patched out) register the same loop
constraints, match statistics and trajectory, bit for bit.  A failure in
the warm-up or in a submap event is raised to the caller, never logged
away.  The configurations are ``test_torch_slam.py``'s loop-closure SLAM
and ``test_torch_loop_closure.py``'s revisit world.
"""
import numpy as np
import pytest

from pylidar_slam_tpu_torch.config import compose as tcompose, dataclass_from_dict as tdfd
from pylidar_slam_tpu_torch.dataset.synthetic import (SyntheticConfig as TCfg,
                                                      SyntheticDatasetLoader as TLoader)
from pylidar_slam_tpu_torch.slam.loop_closure import (EILoopClosureConfig as TLCConfig,
                                                      ElevationImageLoopClosure as TLC)
from pylidar_slam_tpu_torch.slam.slam import SLAM as TSLAM, SLAMConfig as TSLAMConfig

from test_loop_closure import _structured_cloud
from test_torch_loop_closure import LC_KW, N_FRAMES, _drive, _finish
from test_torch_odometry import _one_torch_thread  # noqa: F401
from test_torch_slam import CONFIG, SLAM_OVERRIDES, _run_slam

# One submap event, the last: four frames, submaps of three with overlap 1.
SHORT_OVERRIDES = [
    "dataset=synthetic", "dataset.num_frames=4", "dataset.lidar_height=32",
    "dataset.lidar_width=256", "slam/odometry/local_map=aggregated",
    "slam.odometry.num_points_padded=16384", "slam/loop_closure=elevation_image",
    "slam.loop_closure.local_map_size=3", "slam.loop_closure.overlap=1",
    "slam.loop_closure.im_size=128", "slam.loop_closure.icp_num_points=512",
    "slam.loop_closure.max_num_candidates=2", "slam/backend=graph_slam"]


def _record(monkeypatch):
    """The warm-ups and submap events that ran, in order, with the shapes
    of each call of the match path."""
    runs = []
    for name in ("_prewarm", "_event"):
        fn = getattr(TLC, name)

        def recorded(self, *args, _fn=fn, _name=name):
            runs.append(_name)
            return _fn(self, *args)
        monkeypatch.setattr(TLC, name, recorded)
    match = TLC._match_batch

    def match_batch(self, *args):
        runs.append(("_match_batch", [tuple(a.shape) for a in args]))
        return match(self, *args)
    monkeypatch.setattr(TLC, "_match_batch", match_batch)
    return runs


def _loops(slam):
    return [(i, j, np.asarray(t)) for i, j, t, _ in slam.backend.registered_loop_constraints()]


def _failing_build(monkeypatch, *, warmup: bool):
    """`_build_image` raising on the warm-up's one-point image, or else on
    the first submap image."""
    build = TLC._build_image

    def build_image(self, aggregated):
        if (len(aggregated) == 1) == warmup:
            raise RuntimeError("image build failed")
        return build(self, aggregated)
    monkeypatch.setattr(TLC, "_build_image", build_image)


def _errors(caplog):
    return [r for r in caplog.records if r.levelname in ("ERROR", "CRITICAL")]


@pytest.fixture(scope="module")
def world():
    return _structured_cloud(np.random.default_rng(4), 4000)


@pytest.mark.parametrize("batch", [1, 4])
def test_warmup_changes_no_answer(monkeypatch, batch):
    overrides = SLAM_OVERRIDES + [f"slam.odometry.batch_size={batch}"]
    runs = _record(monkeypatch)
    warm, _ = _run_slam("torch", overrides)
    assert runs[0] == "_prewarm" and "_prewarm" not in runs[1:] and "_event" in runs
    monkeypatch.setattr(TLC, "_prewarm", lambda self: None)
    cold, _ = _run_slam("torch", overrides)
    loops, loops_cold = _loops(warm), _loops(cold)
    assert len(loops) > 0
    assert [(i, j) for i, j, _ in loops] == [(i, j) for i, j, _ in loops_cold]
    for (_, _, t), (_, _, t_cold) in zip(loops, loops_cold):
        np.testing.assert_array_equal(t, t_cold)
    np.testing.assert_array_equal(warm.get_absolute_poses(), cold.get_absolute_poses())
    assert warm.loop_closure.match_stats == cold.loop_closure.match_stats


def test_init_warms_up_and_leaves_the_state_empty():
    lc = TLC(TLCConfig(**LC_KW), device="cpu")
    assert lc.warmup_seconds == 0.0
    lc.init()
    assert lc.warmup_seconds > 0
    assert lc.saved_images == [] and lc.saved_clouds == [] and lc.maps_frame_ids == []
    assert lc._pending_matches == [] and lc.match_stats == []
    assert lc.current_frame_id == 0 and lc.current_map_pcs == []


def test_warmup_runs_the_events_shapes(world, monkeypatch):
    """The warm-up's match has the shapes of every real event's: the
    candidates are padded to `max_num_candidates`."""
    runs = _record(monkeypatch)
    lc = TLC(TLCConfig(**LC_KW), device="cpu")
    lc.init()
    found = _finish(lc, _drive(lc, world, 0, N_FRAMES, None)[0])
    assert len(found) > 0
    matches = [shapes for run in runs if isinstance(run, tuple) for shapes in run[1:]]
    assert runs[0] == "_prewarm" and len(matches) > 1
    c, s, n = LC_KW["max_num_candidates"], LC_KW["im_size"], LC_KW["icp_num_points"]
    assert matches[0] == [(c, s, s), (c, n, 3), (c, n), (s, s), (n, 3), (n,)]
    assert all(shapes == matches[0] for shapes in matches[1:])


def test_warmup_failure_raises_from_init(monkeypatch, caplog):
    _failing_build(monkeypatch, warmup=True)
    lc = TLC(TLCConfig(**LC_KW), device="cpu")
    with pytest.raises(RuntimeError, match="image build failed"):
        lc.init()
    assert not _errors(caplog)


@pytest.mark.parametrize("batch", [1, 4])
def test_event_failure_raises_to_the_caller(monkeypatch, caplog, batch):
    """At batch 1 the submap event runs in the frame's
    ``process_next_frame``; at batch 4 the four frames are still deferred
    and the event runs in ``SLAM.finish``."""
    _failing_build(monkeypatch, warmup=False)
    cfg = tcompose(CONFIG, "slam", SHORT_OVERRIDES + [f"slam.odometry.batch_size={batch}"])
    loader = TLoader(tdfd(TCfg, cfg["dataset"]))
    slam = TSLAM(tdfd(TSLAMConfig, cfg["slam"]), projector=loader.projector(), device="cpu")
    slam.init()
    ds = loader.sequences()[0][0][0]
    with pytest.raises(RuntimeError, match="image build failed"):
        for i in range(len(ds)):
            slam.process_next_frame(ds[i])
        assert batch == 4, "the event ran at batch 1 without raising"
        slam.finish()
    assert not _errors(caplog)


def test_clean_then_init_warms_again_with_the_same_answers(world, monkeypatch):
    runs = _record(monkeypatch)
    lc = TLC(TLCConfig(**LC_KW), device="cpu")
    lc.init()
    first = _finish(lc, _drive(lc, world, 0, N_FRAMES, None)[0])
    lc.clean()
    assert lc.saved_images == [] and lc.match_stats == [] and lc.current_frame_id == 0
    lc.init()
    second = _finish(lc, _drive(lc, world, 0, N_FRAMES, None)[0])
    names = [run for run in runs if isinstance(run, str)]
    assert names.count("_prewarm") == 2 and names[0] == "_prewarm"
    assert names[names.index("_prewarm", 1) - 1] == "_event"
    assert len(first) > 0 and sorted(second) == sorted(first)
    for key in first:
        np.testing.assert_array_equal(second[key][0], first[key][0])
