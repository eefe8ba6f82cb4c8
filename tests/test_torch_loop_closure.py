"""The port's loop closure and backend against the JAX package's, on the
CPU: the BEV registrations, the ICP refine, the pose-graph solvers, the
GraphSLAM constraint protocol and the elevation-image loop closure.

Seeded numpy inputs go through both packages; the JAX side runs in float32
(``jax.enable_x64(False)``).  Tolerances: BEV (yaw, dy, dx, score) 1e-4;
the ICP transform 1e-4; the float64 host solver 1e-9; the float32 PCG 1e-4
(the two frameworks' float32 rounding, compounded over the CG steps); loop
constraint keys identical, their transforms within 1e-3 m and 1e-3 of each
rotation entry.
"""
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pylidar_slam_tpu.ops import bev as jbev, icp3d as jicp, pose_graph as jpg, se3 as jse3
from pylidar_slam_tpu.slam import backend as jbackend
from pylidar_slam_tpu.slam.loop_closure import (EILoopClosureConfig as JLCConfig,
                                                ElevationImageLoopClosure as JLC)

from pylidar_slam_tpu_torch.ops import bev as tbev, icp3d as ticp, pose_graph as tpg
from pylidar_slam_tpu_torch.slam import backend as tbackend
from pylidar_slam_tpu_torch.slam.loop_closure import (EILoopClosureConfig as TLCConfig,
                                                      ElevationImageLoopClosure as TLC)

from test_backend import _circle_poses
from test_loop_closure import _structured_cloud

BEV_TOL = 1e-4
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _moved(cloud, yaw, tx, ty):
    c, s = np.cos(yaw), np.sin(yaw)
    rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    return (cloud @ rot.T + np.array([tx, ty, 0], np.float32)).astype(np.float32)


@pytest.fixture(scope="module")
def bev_images():
    """Elevation images of a structured cloud and of three moved copies
    (the candidate batch): (references (3, S, S), moving image (S, S))."""
    cloud = _structured_cloud(np.random.default_rng(1))
    with jax.enable_x64(False):
        img_b = np.asarray(jbev.build_elevation_image(jnp.asarray(cloud), None, 0.25, 128))
        refs = np.stack([np.asarray(jbev.build_elevation_image(
            jnp.asarray(_moved(cloud, *m)), None, 0.25, 128))
            for m in [(0.35, 2.0, -1.5), (-1.2, -3.0, 0.5), (2.8, 0.5, 4.0)]])
    tb = tbev.build_elevation_image(torch.from_numpy(cloud), None, 0.25, 128).numpy()
    assert np.array_equal(tb, img_b)
    return refs, img_b


def _jax_result(fn, *args, **kw):
    with jax.enable_x64(False):
        res = fn(*(jnp.asarray(a) for a in args), **kw)
        return np.array([float(res.yaw), float(res.dy), float(res.dx), float(res.score)])


def _torch_result(res):
    return np.stack([res.yaw.numpy(), res.dy.numpy(), res.dx.numpy(), res.score.numpy()], -1)


def test_polar_spectrum_and_theta_shift_match_jax(bev_images):
    refs, img_b = bev_images
    with jax.enable_x64(False):
        jpa = np.stack([np.asarray(jbev._polar_spectrum(jnp.asarray(r), 180, 128)) for r in refs])
        jpb = np.asarray(jbev._polar_spectrum(jnp.asarray(img_b), 180, 128))
        jshift = np.array([float(jbev._circular_shift_theta(jnp.asarray(p), jnp.asarray(jpb)))
                           for p in jpa])
    tpa = tbev._polar_spectrum(torch.from_numpy(refs), 180, 128).numpy()
    tpb = tbev._polar_spectrum(torch.from_numpy(img_b), 180, 128).numpy()
    np.testing.assert_allclose(tpa, jpa, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(tpb, jpb, rtol=1e-5, atol=1e-4)
    tshift = tbev._circular_shift_theta(torch.from_numpy(jpa), torch.from_numpy(jpb)).numpy()
    np.testing.assert_allclose(tshift, jshift, atol=BEV_TOL)


def test_register_bev_fm_matches_jax(bev_images):
    refs, img_b = bev_images
    ref = np.stack([_jax_result(jbev.register_bev_fm, r, img_b) for r in refs])
    batched = _torch_result(tbev.register_bev_fm(torch.from_numpy(refs),
                                                 torch.from_numpy(img_b)))
    np.testing.assert_allclose(batched, ref, atol=BEV_TOL)
    for k, r in enumerate(refs):  # one pair at a time, as the JAX function runs
        one = _torch_result(tbev.register_bev_fm(torch.from_numpy(r), torch.from_numpy(img_b)))
        np.testing.assert_allclose(one, ref[k], atol=BEV_TOL)


def test_coarse_register_bev_matches_jax(bev_images):
    refs, img_b = bev_images
    ref = np.stack([_jax_result(jbev.register_bev, r, img_b, num_yaw_steps=36,
                                coarse_factor=2) for r in refs])
    ours = _torch_result(tbev.register_bev(torch.from_numpy(refs), torch.from_numpy(img_b),
                                           num_yaw_steps=36, coarse_factor=2))
    np.testing.assert_allclose(ours, ref, atol=BEV_TOL)
    # the full sweep, batched over references
    full = np.stack([_jax_result(jbev.register_bev, r, img_b, num_yaw_steps=24) for r in refs])
    ours = _torch_result(tbev.register_bev(torch.from_numpy(refs), torch.from_numpy(img_b),
                                           num_yaw_steps=24))
    np.testing.assert_allclose(ours, full, atol=BEV_TOL)


def test_bev_transform_to_se3_batched():
    res = tbev.BEVRegistrationResult(*(torch.tensor([0.3, -2.0]) for _ in range(4)))
    mats = tbev.bev_transform_to_se3(res, 0.25)
    for k in range(2):
        with jax.enable_x64(False):
            ref = np.asarray(jbev.bev_transform_to_se3(
                jbev.BEVRegistrationResult(*(jnp.float32(v[k]) for v in res)), 0.25))
        np.testing.assert_allclose(mats[k].numpy(), ref, atol=1e-7)


def _icp_case():
    cloud = _structured_cloud(np.random.default_rng(3), 2000)
    with jax.enable_x64(False):
        params = jnp.asarray([0.4, -0.3, 0.05, 0.01, -0.02, 0.08], jnp.float32)
        gt = jse3.build_pose_matrix(params[None])[0]
        target = np.asarray(jse3.apply_transformation(jnp.asarray(cloud)[None], gt[None])[0])
    return cloud, target, np.asarray(gt)


def test_icp_align_matches_jax():
    cloud, target, gt = _icp_case()
    with jax.enable_x64(False):
        ref = jicp.icp_align(jnp.asarray(cloud), jnp.asarray(target), max_iters=30,
                             max_corr_dist=2.0)
    ours = ticp.icp_align(torch.from_numpy(cloud), torch.from_numpy(target), max_iters=30,
                          max_corr_dist=2.0)
    np.testing.assert_allclose(ours.transform.numpy(), np.asarray(ref.transform), atol=1e-4)
    np.testing.assert_allclose(ours.transform.numpy(), gt, atol=0.02)
    assert int(ours.num_iters) == int(ref.num_iters)
    np.testing.assert_allclose(float(ours.mean_residual), float(ref.mean_residual), atol=1e-4)


def test_icp_align_batched_candidates_and_the_active_flag():
    """Candidates are aligned as pairs; a False flag freezes a candidate at
    its initial transform with no trip run."""
    cloud, target, _ = _icp_case()
    src, tgt = torch.from_numpy(cloud), torch.from_numpy(target)
    inits = torch.eye(4).repeat(3, 1, 1)
    inits[1, 0, 3] = 0.3
    masks = torch.ones((3, len(target)), dtype=torch.bool)
    masks[2, ::3] = False
    out = ticp.icp_align(src, tgt.expand(3, -1, -1).contiguous(), init_transform=inits,
                         target_mask=masks, max_iters=15, max_corr_dist=2.0,
                         active=torch.tensor([True, True, False]))
    for k in range(2):
        one = ticp.icp_align(src, tgt, init_transform=inits[k], target_mask=masks[k],
                             max_iters=15, max_corr_dist=2.0)
        assert torch.equal(out.transform[k], one.transform)
        assert int(out.num_iters[k]) == int(one.num_iters) > 0
    assert torch.equal(out.transform[2], inits[2]) and int(out.num_iters[2]) == 0


def _noisy_loop(n, radius, seed, noise):
    rng = np.random.default_rng(seed)
    gt = _circle_poses(n, radius=radius)
    gt = np.linalg.inv(gt[0]) @ gt
    relatives = np.linalg.inv(gt[:-1]) @ gt[1:]
    edge_i, edge_j, meas, infos, poses = [], [], [], [], [np.eye(4)]
    for k, rel in enumerate(relatives):
        noisy = rel.copy()
        noisy[:3, 3] += rng.normal(scale=noise, size=3)
        poses.append(poses[-1] @ noisy)
        edge_i.append(k), edge_j.append(k + 1), meas.append(noisy)
        infos.append(np.diag([2.0] * 3 + [5.0] * 3))
    edge_i.append(0), edge_j.append(n - 1), meas.append(np.eye(4))
    infos.append(np.diag([10.0] * 6))
    return np.stack(poses), edge_i, edge_j, np.stack(meas), np.stack(infos), gt


@pytest.mark.parametrize("n,priors", [(61, False), (300, False), (40, True)])
def test_host_pose_graph_solver_matches_jax(n, priors):
    poses, ei, ej, meas, infos, gt = _noisy_loop(n, 20.0, n, 0.03)
    kw = {}
    if priors:  # absolute (GPS) priors every 5 poses
        idx = list(range(5, n, 5))
        kw = dict(prior_idx=idx, prior_measurements=np.linalg.inv(gt[idx]),
                  prior_information=np.tile(np.diag([50.0] * 3 + [1e-3] * 3), (len(idx), 1, 1)))
    ref = jpg.optimize_pose_graph_host(poses, ei, ej, meas, infos, num_iters=15, **kw)
    ours = tpg.optimize_pose_graph_host(poses, ei, ej, meas, infos, num_iters=15, **kw)
    assert ours.dtype == np.float64
    np.testing.assert_allclose(ours, ref, atol=1e-9)


def test_pcg_pose_graph_solver_matches_jax():
    poses, ei, ej, meas, infos, _ = _noisy_loop(40, 20.0, 5, 0.02)
    with jax.enable_x64(False):
        graph = jpg.PoseGraph(jnp.asarray(ei, jnp.int32), jnp.asarray(ej, jnp.int32),
                              jnp.asarray(meas, jnp.float32), jnp.asarray(infos, jnp.float32),
                              jnp.asarray([3], jnp.int32), jnp.eye(4, dtype=jnp.float32)[None],
                              jnp.asarray(np.diag([1.0] * 6)[None], jnp.float32))
        ref = np.asarray(jpg.optimize_pose_graph(jnp.asarray(poses, jnp.float32), graph,
                                                 num_iters=3, cg_iters=20))
    graph = tpg.PoseGraph(*(torch.as_tensor(np.asarray(a)) for a in graph))
    ours = tpg.optimize_pose_graph(torch.as_tensor(poses, dtype=torch.float32), graph,
                                   num_iters=3, cg_iters=20).numpy()
    np.testing.assert_allclose(ours, ref, atol=1e-4)


@pytest.mark.parametrize("n", [1, 7])
def test_so3_maps_match_jax(n):
    w = np.random.default_rng(n).uniform(-2, 2, (32, 3)).astype(np.float32)
    w[0] = 0.0
    w[1] = [1e-9, 0.0, 0.0]
    with jax.enable_x64(False):
        rot = np.asarray(jpg.exp_rotation(jnp.asarray(w)))
        log = np.asarray(jpg.log_rotation(jnp.asarray(rot)))
        se3m = np.asarray(jpg.exp_se3(jnp.asarray(np.concatenate([w, w], -1))))
    np.testing.assert_allclose(tpg.exp_rotation(torch.from_numpy(w)).numpy(), rot, atol=1e-6)
    np.testing.assert_allclose(tpg.log_rotation(torch.from_numpy(rot)).numpy(), log, atol=1e-5)
    np.testing.assert_allclose(tpg.exp_se3(torch.from_numpy(np.concatenate([w, w], -1))).numpy(),
                               se3m, atol=1e-6)


def test_graph_slam_protocol_matches_jax():
    """The key protocol, the default informations, the optimization trigger
    and the optimized poses, fed the same constraint stream."""
    rng = np.random.default_rng(3)
    gt = _circle_poses(41)
    relatives = np.linalg.inv(gt[:-1]) @ gt[1:]
    backends = [m.GraphSLAM(m.GraphSLAMConfig(max_optim_iterations=15))
                for m in (jbackend, tbackend)]
    for b in backends:
        b.init()
    for k, rel in enumerate(relatives):
        noisy = rel.copy()
        noisy[:3, 3] += rng.normal(scale=0.03, size=3)
        d = {"se3_odometry_constraint_%d" % k: (noisy, None), "unrelated_key": 42}
        if k == 20:
            d["se3_absolute_constraint_5"] = (np.eye(4), None)
            d["se3_loop_closure_constraint_0_2"] = (np.eye(4), None)  # |i - j| <= 2
        for b in backends:
            b.next_frame(dict(d))
            assert not b.need_to_update_pose
    for b in backends:
        b.next_frame({b.se3_loop_closure_constraint(0, 40): (np.eye(4), np.eye(6) * 10)})
        assert b.need_to_update_pose
    (j, t) = backends
    for name in ("registered_odometry_constraints", "registered_loop_constraints",
                 "registered_absolute_constraints"):
        assert [c[:2] for c in getattr(t, name)()] == [c[:2] for c in getattr(j, name)()]
    assert [e[:2] for e in t._edges] == [e[:2] for e in j._edges]
    for (_, _, _, it), (_, _, _, ij) in zip(t._edges, j._edges):
        np.testing.assert_array_equal(it, ij)
    np.testing.assert_allclose(t.absolute_poses(), j.absolute_poses(), atol=1e-9)
    np.testing.assert_allclose(t.relative_odometry_poses(), j.relative_odometry_poses(),
                               atol=1e-9)


# -- the elevation-image loop closure on the revisit loop ----------------------

# tests/test_loop_closure.py's configuration, with 1024-point refine clouds
# and 4 candidates per event to keep the CPU run short
LC_KW = dict(local_map_size=5, overlap=2, min_id_distance=10, im_size=256,
             pixel_size=0.25, num_yaw_steps=45, with_icp_refinement=True,
             icp_num_points=1024, min_score=0.05, max_num_candidates=4)
N_FRAMES = 30


def _revisit_frame(world, k):
    angle = 2 * np.pi * k / (N_FRAMES - 1)
    pose = np.eye(4)
    pose[:3, 3] = [3 * np.sin(angle), 1.5 * (1 - np.cos(angle)), 0.0]
    return pose, world - pose[None, :3, 3]


def _drive(lc, world, start, stop, prev_pose):
    found = {}
    for k in range(start, stop):
        pose, local = _revisit_frame(world, k)
        rel = np.eye(4) if k == 0 else np.linalg.inv(prev_pose) @ pose
        prev_pose = pose
        d = {lc.relative_pose_key(): rel, lc.pointcloud_key(): local}
        lc.process_next_frame(d)
        found.update({key: v for key, v in d.items() if key.startswith("se3_loop_closure")})
    return found, prev_pose


def _finish(lc, found):
    if isinstance(lc, JLC):
        lc.flush_events()  # the JAX package's lc-event worker thread
    final = {}
    lc.drain_pending(final)
    found.update({key: v for key, v in final.items() if key.startswith("se3_loop_closure")})
    return found


@pytest.fixture(scope="module")
def world():
    return _structured_cloud(np.random.default_rng(4), 4000)


@pytest.fixture(scope="module")
def revisit_runs(world):
    with jax.enable_x64(False):
        jlc = JLC(JLCConfig(**LC_KW))
        jlc.init()
        ref = _finish(jlc, _drive(jlc, world, 0, N_FRAMES, None)[0])
    tlc = TLC(TLCConfig(**LC_KW), device="cpu")
    tlc.init()
    ours = _finish(tlc, _drive(tlc, world, 0, N_FRAMES, None)[0])
    return ref, ours, tlc


def test_loop_closure_revisit_matches_jax(revisit_runs):
    ref, ours, tlc = revisit_runs
    assert len(ref) > 0
    assert sorted(ours) == sorted(ref)
    for key in ref:
        t_ours, t_ref = ours[key][0], np.asarray(ref[key][0])
        np.testing.assert_allclose(t_ours[:3, 3], t_ref[:3, 3], atol=1e-3)
        np.testing.assert_allclose(t_ours[:3, :3], t_ref[:3, :3], atol=1e-3)
    # every event's refine ran on the candidates that passed the score gate
    assert sum(s["refine_trips"] for s in tlc.match_stats) > 0


def test_loop_closure_state_resume(revisit_runs, world, tmp_path):
    _, full, _ = revisit_runs
    cut = 17
    lc_a = TLC(TLCConfig(**LC_KW), device="cpu")
    lc_a.init()
    resumed, prev_pose = _drive(lc_a, world, 0, cut, None)
    mid = {}
    lc_a.drain_pending(mid)
    resumed.update(mid)
    path = str(tmp_path / "lc_state.npz")
    lc_a.save_state(path)
    lc_b = TLC(TLCConfig(**LC_KW), device="cpu")
    lc_b.init()
    lc_b.load_state(path)
    assert lc_b.current_frame_id == cut
    assert len(lc_b.saved_images) == len(lc_a.saved_images)
    for a, b in zip(lc_a.saved_images, lc_b.saved_images):
        assert torch.equal(a, b)
    np.testing.assert_allclose(lc_b.maps_absolute_poses, lc_a.maps_absolute_poses)
    more, _ = _drive(lc_b, world, cut, N_FRAMES, prev_pose)
    resumed.update(_finish(lc_b, more))
    assert sorted(resumed) == sorted(full)


# ---------------------------------------------------------------------------
# ROADMAP.md §C1: the loops the port accepted and the JAX package rejected
# ---------------------------------------------------------------------------

C1_FRAMES = 20
C1_OVERRIDES = ["dataset=synthetic", f"dataset.num_frames={C1_FRAMES}",
                "dataset.turn_rate=0.01", "slam/odometry/local_map=aggregated",
                "slam.odometry.max_num_alignments=6",
                "slam.odometry.num_points_padded=65536", "slam.odometry.batch_size=1",
                "slam/loop_closure=elevation_image", "slam.loop_closure.local_map_size=4",
                "slam.loop_closure.overlap=1", "slam.loop_closure.min_id_distance=9",
                "slam.loop_closure.max_distance=1e6", "slam/backend=graph_slam"]


def _jax_slam_events(monkeypatch, perturbation):
    """The JAX package's SLAM on the configuration of
    tests/test_slam_e2e.py's mid-sequence loop-closure test (64x1024, f32
    uploads, every earlier submap a candidate), cut to 20 frames, with each
    input cloud scaled by (1 + perturbation * N(0, 1)).  Returns (the loop
    pairs it accepts, each submap event's inputs and match results)."""
    from pylidar_slam_tpu.config import compose, dataclass_from_dict
    from pylidar_slam_tpu.dataset.synthetic import SyntheticConfig, SyntheticDatasetLoader
    from pylidar_slam_tpu.slam import loop_closure as jlc_mod
    from pylidar_slam_tpu.slam.slam import SLAM, SLAMConfig

    events, images = [], []
    match = jlc_mod.ElevationImageLoopClosure._match_candidates
    build = jlc_mod.ElevationImageLoopClosure._build_image

    def record_image(self, aggregated):
        image = build(self, aggregated)
        images.append((np.array(aggregated), np.asarray(image)))
        return image

    def record(self, candidate_ids, image, submap_cloud, frame_id):
        match(self, candidate_ids, image, submap_cloud, frame_id)
        scores, transforms, ids, _ = self._pending_matches[-1]
        pad = ids + [ids[0]] * (int(self.config.max_num_candidates) - len(ids))
        events.append({
            "n": len(ids), "image": np.asarray(image),
            "sm_cloud": np.asarray(submap_cloud[0]), "sm_mask": np.asarray(submap_cloud[1]),
            "scores": np.asarray(scores), "transforms": np.asarray(transforms),
            "cand_imgs": np.stack([np.asarray(self.saved_images[k]) for k in pad]),
            "cand_clouds": np.stack([np.asarray(self.saved_clouds[k][0]) for k in pad]),
            "cand_masks": np.stack([np.asarray(self.saved_clouds[k][1]) for k in pad])})

    monkeypatch.setattr(jlc_mod.ElevationImageLoopClosure, "_match_candidates", record)
    monkeypatch.setattr(jlc_mod.ElevationImageLoopClosure, "_build_image", record_image)
    monkeypatch.chdir(ROOT)
    cfg = compose("config", "slam", C1_OVERRIDES)
    loader = SyntheticDatasetLoader(dataclass_from_dict(SyntheticConfig, cfg["dataset"]))
    rng = np.random.default_rng(7)
    with jax.enable_x64(False):
        slam = SLAM(dataclass_from_dict(SLAMConfig, cfg["slam"]), projector=loader.projector())
        slam.init()
        ds = loader.sequences()[0][0][0]
        for i in range(C1_FRAMES):
            frame = dict(ds[i])
            pc = frame["numpy_pc"]
            frame["numpy_pc"] = (pc * (1 + perturbation * rng.standard_normal(pc.shape))
                                 ).astype(np.float32)
            slam.process_next_frame(frame)
        slam.finish()
    monkeypatch.undo()
    return ([(i, j) for i, j, *_ in slam.backend.registered_loop_constraints()],
            events, images)


def test_c1_loop_decisions_match_jax_on_identical_submaps(monkeypatch):
    """C1's cause lies in the reference: on identical submap inputs the
    port's BEV image, candidate scores, refined transforms and accept
    decisions are the JAX package's, while a 1e-7 relative change of the
    input clouds moves the JAX package's own score of the frame-3
    candidate at the frame-18 event from 0.114 to 0.085, across
    `min_score` 0.10, so its own loop set changes.  Non-overlapping
    candidates score 0.04-0.12 here; which of them pass depends on the
    last bits of the odometry, in either package."""
    loops, events, images = _jax_slam_events(monkeypatch, 0.0)
    loops_p, events_p, _ = _jax_slam_events(monkeypatch, 1e-7)
    assert loops == [(3, 18)] and loops_p == []
    assert len(events) == len(events_p) == 2
    flips = [(e["scores"][:e["n"]] >= 0.1) != (p["scores"][:p["n"]] >= 0.1)
             for e, p in zip(events, events_p)]
    assert any(f.any() for f in flips)

    cfg = TLCConfig(local_map_size=4, overlap=1, min_id_distance=9, max_distance=1e6)
    tlc = TLC(cfg, device="cpu")
    tlc.init()
    assert len(images) >= 5
    for aggregated, image in images:
        np.testing.assert_allclose(tlc._build_image(aggregated).numpy(), image,
                                   rtol=0, atol=1e-6)
    for e in events:
        n = e["n"]
        scores, transforms, _ = tlc._match_batch(
            *[torch.from_numpy(e[k]) for k in ("cand_imgs", "cand_clouds", "cand_masks",
                                               "image", "sm_cloud", "sm_mask")])
        scores = scores.numpy()[:n]
        np.testing.assert_allclose(scores, e["scores"][:n], rtol=0, atol=1e-5)
        accepted = e["scores"][:n] >= cfg.min_score
        assert np.array_equal(scores >= cfg.min_score, accepted)
        assert np.min(np.abs(e["scores"][:n] - cfg.min_score)) > 1e-4  # decisions not on a tie
        np.testing.assert_allclose(transforms.numpy()[:n][accepted],
                                   e["transforms"][:n][accepted], rtol=0, atol=1e-4)
