"""The surfel ("kdtree") map odometry against its plain reference,
``slambench/reference/kdtree_f2m.py``, on seeded scans of the benchmark's
road at 16 x 256, K = 4 frames x S = 256 map points and M = 1,024 targets,
over 10 frames at batch 1 and batch 4.

The program finds the k-NN normals' neighbours in its voxel-hash grid; the
reference takes the exact k nearest, as upstream's KD-tree does.  At this
size the map is sparse and most points have fewer than k neighbours within
the gate, where the two part (0.22 m on these scans), so here the program's
grid search is replaced by brute force: what remains differs by rounding
alone (the normal equations summed in another order; 2.7e-6 m measured).
The map sample is taken at 0.3 m, not the configuration's 0.4 m: with 16
beams a 0.4 m sample leaves points whose 10 nearest lie along one ring, a
plane fit whose two smallest eigenvalues are ~1e-5 of the largest, so the
normal is set by rounding (4 such points by frame 2 on these scans, and a
4 mm gap by frame 4).
The reference's tiled searches and grid sample are held to brute force and
to the program's own sampler.
"""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from slambench import correct, harness  # noqa: E402
from slambench.reference import kdtree_f2m  # noqa: E402
from slambench.traffic import generator  # noqa: E402

from pylidar_slam_tpu_torch.slam.odometry import surfel_map as sm  # noqa: E402

H, W, K, S, M = 16, 256, 4, 256, 1024
FRAMES = 10
CPU = torch.device("cpu")
# rounding only: 2.7e-6 m and 2.4e-6 deg measured; a pose off by one
# association would read ~1e-3 m
TRANS_M, ROT_DEG = 1e-4, 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cell():
    cfg = json.loads((REPO / "slambench/configs/hdl64-kdtree-f2m.json").read_text())
    cfg["sensor"].update(lidar_height=H, lidar_width=W)
    cfg["program"]["local_map"].update(local_map_size=K, points_per_frame=S, target_samples=M,
                                       sample_voxel_size=0.3)
    cfg["program"]["num_points_padded"] = H * W
    traffic = harness.load_traffic(REPO, "road-fullmap")
    traffic["route"]["cycle_frames"] = 64
    clouds = generator.make_scans(traffic, cfg["sensor"], 5, CPU).clouds
    ref = kdtree_f2m.run(cfg["program"], correct.sensor_of(cfg), clouds, FRAMES, CPU)
    return cfg, clouds, ref


def exact_knn(queries, points, slots, voxel, n_buckets, cap, radius, k):
    """``hash_grid_knn``'s place: the k nearest valid map points (those the
    grid holds), ascending, the lower index first on ties."""
    ids = torch.sort(slots[1].reshape(-1)[slots[1].reshape(-1) >= 0].long()).values
    d = kdtree_f2m.sq_dists(queries, points[ids])
    # k missing neighbours at +inf, index 0, as the grid reports them
    d = torch.cat([d, d.new_full((d.shape[0], k), float("inf"))], dim=1)
    ids = torch.cat([ids, ids.new_zeros(k)])
    d, j = torch.sort(d, dim=1, stable=True)
    return ids[j[:, :k]].to(torch.int32), d[:, :k]


@pytest.mark.parametrize("batch", [1, 4])
def test_program_matches_the_reference(cell, batch, monkeypatch):
    cfg, clouds, ref = cell
    monkeypatch.setattr(sm, "hash_grid_knn", exact_knn)
    program = json.loads(json.dumps(cfg["program"]))
    # a grid that holds every point, for the stand-in to read the map's from
    program["local_map"].update(hash_buckets=8, hash_capacity=K * S)
    drv = harness.OdometryDriver(program, cfg["sensor"], batch, CPU)
    for i in range(FRAMES):
        drv.process(drv.prepare(clouds[i]))
    drv.finish()
    ours = drv.outputs()["params"]
    assert ours.shape == ref.shape == (FRAMES, 6)
    assert np.abs(ref[1:, :3]).max() > 0.5  # the frames move
    gap_t, gap_r = correct.pose_gaps(ours, ref)
    assert gap_t < TRANS_M and gap_r < ROT_DEG, (gap_t, gap_r)


def test_grid_sample_keeps_the_programs_points():
    """The first point of each voxel, in the XOR-hash order, cut at the
    capacity: the program's sampler's kept points and slot order."""
    g = torch.Generator().manual_seed(3)
    pts = (torch.rand((6000, 3), generator=g) - 0.5) * torch.tensor([40.0, 40.0, 6.0])
    valid = torch.rand((6000,), generator=g) > 0.1
    for voxel, cap in ((0.4, 8192), (0.4, 700), (1.5, 300)):
        sel, idx, keep = sm._grid_sample_fixed(pts, valid, voxel, cap)
        ref = kdtree_f2m.grid_sample(pts, valid, voxel, cap)
        assert torch.equal(idx[:ref.numel()], ref)
        assert int(keep.sum()) == ref.numel() and bool(keep[:ref.numel()].all())


def test_tiled_searches_equal_brute_force(monkeypatch):
    """Tiles, blocks of rows and the k-NN's search of the whole map for the
    queries its radius cannot vouch for, against one brute-force pass."""
    g = torch.Generator().manual_seed(4)
    pts = (torch.rand((3000, 3), generator=g) - 0.5) * torch.tensor([70.0, 50.0, 4.0])
    qs = pts[:800] + 0.3 * torch.randn((800, 3), generator=g)
    pts = torch.cat([pts, pts[:1000]])  # equal distances: ties inside and across the k-th
    monkeypatch.setattr(kdtree_f2m, "PAIRS_PER_BLOCK", 5000)
    monkeypatch.setattr(kdtree_f2m, "KNN_RADIUS_M", 1.5)
    d = kdtree_f2m.sq_dists(qs, pts)
    idx, sq = kdtree_f2m.nearest(qs, pts, 1.0)
    best = torch.argmin(d, dim=1)
    near = d.min(dim=1).values < 1.0 * kdtree_f2m._ROUNDING
    assert 0 < int(near.sum()) < 800
    assert torch.equal(idx[near], best[near])
    assert torch.equal(sq[near], d.min(dim=1).values[near])
    assert bool(torch.isinf(sq[~near]).all())
    knn = kdtree_f2m.k_nearest(qs, pts, 10)
    assert torch.equal(knn, torch.sort(d, dim=1, stable=True).indices[:, :10])
    assert bool((knn >= 3000).any())  # a copy kept where the k-th place ties


def test_reference_imports_neither_package_nor_jax():
    script = (f"import sys; sys.path.insert(0, {str(REPO)!r})\n"
              "from slambench.reference import kdtree_f2m\n"
              "print(sorted({m.split('.')[0] for m in sys.modules} & {'jax', 'jaxlib', "
              "'flax', 'pylidar_slam_tpu', 'pylidar_slam_tpu_torch'}))\n")
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == "[]"
