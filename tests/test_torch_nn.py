"""Kernel B2 (exact 1-NN) and the ops beneath the surfel map: the port's
plain versions against the JAX package on numpy-seeded inputs, on the CPU,
and the wrapper's dispatch rules.  The CUDA kernel itself is compared with
its plain version on the card (chip_smoke.py, tests/test_torch_gpu.py).

Tolerances:
* ``nn_argmin_plain`` vs JAX ``brute_force_nn`` (the XLA path, direct
  subtraction in both): identical indices, squared distances within 1e-6
  relative.
* vs the Pallas kernel (interpret mode), which expands
  ||m||^2 - 2 q.m + ||q||^2: its rounding error is a few float32 ulps of
  ||q||^2 + ||m*||^2, so the distance is held within 8 eps (||q||^2 +
  ||m*||^2), and the index where the first and second neighbours are
  further apart than that.
* Hash grids, slot tables and neighbour indices: identical.
* Plane normals and eigenvectors: equal up to sign within 1e-5.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pylidar_slam_tpu.ops import geometry as jgeo
from pylidar_slam_tpu.ops import hash_nn as jhash
from pylidar_slam_tpu.ops import icp3d as jicp3d
from pylidar_slam_tpu.ops import optimization as jopt
from pylidar_slam_tpu.ops import voxel as jvox
from pylidar_slam_tpu.ops.pallas.nn_kernel import nn_argmin_pallas
from pylidar_slam_tpu.slam.odometry import surfel_map as jsm

from pylidar_slam_tpu_torch.ops import geometry as tgeo
from pylidar_slam_tpu_torch.ops import hash_nn as thash
from pylidar_slam_tpu_torch.ops import icp3d as ticp3d
from pylidar_slam_tpu_torch.ops import optimization as topt
from pylidar_slam_tpu_torch.ops import voxel as tvox
from pylidar_slam_tpu_torch.ops.kernels import nn_argmin as b2
from pylidar_slam_tpu_torch.ops.kernels import seams
from pylidar_slam_tpu_torch.slam.odometry import surfel_map as tsm
from pylidar_slam_tpu_torch.utils.build import BuildError

EPS32 = float(np.finfo(np.float32).eps)


def _cloud(rng, n, scale=20.0):
    return (rng.normal(size=(n, 3)) * scale).astype(np.float32)


def _jax_nn(q, m, valid):
    with jax.enable_x64(False):
        idx, sq = jicp3d.brute_force_nn(jnp.asarray(q), jnp.asarray(m),
                                        jnp.asarray(valid))
    return np.asarray(idx), np.asarray(sq)


def _torch_nn(q, m, valid):
    idx, sq = b2.nn_argmin_plain(torch.from_numpy(q), torch.from_numpy(m),
                                 torch.from_numpy(valid))
    assert idx.dtype == torch.int32 and sq.dtype == torch.float32
    return idx.numpy(), sq.numpy()


@pytest.mark.parametrize("m,v", [(512, 1024), (300, 2500), (1, 7)])
def test_plain_matches_jax_brute_force(m, v):
    """Random clouds, every tenth model row invalid; M and V need not be
    multiples of anything."""
    rng = np.random.default_rng(m + v)
    q, model = _cloud(rng, m), _cloud(rng, v)
    valid = np.ones(v, bool)
    valid[::10] = False
    ti, ts = _torch_nn(q, model, valid)
    ji, js = _jax_nn(q, model, valid)
    assert np.array_equal(ti, ji)
    np.testing.assert_allclose(ts, js, rtol=1e-6, atol=0)
    assert valid[ti].all()


def test_plain_ties_and_empty_map():
    """Exact duplicate rows: the lower index wins, across chunk borders too.
    An all-invalid map: +inf and index 0."""
    rng = np.random.default_rng(1)
    base = _cloud(rng, 700)
    model = np.concatenate([base, base, base])  # rows i, i + 700, i + 1400
    valid = np.ones(len(model), bool)
    valid[:50] = False  # the first copy of rows 0-49 is invalid
    q = base[::3] + np.float32(0.01)
    ti, ts = _torch_nn(q, model, valid)
    ji, js = _jax_nn(q, model, valid)
    assert np.array_equal(ti, ji)
    np.testing.assert_allclose(ts, js, rtol=1e-6)
    rows = np.arange(0, 700, 3)
    assert np.array_equal(ti, np.where(rows < 50, rows + 700, rows))

    ti, ts = _torch_nn(q, model, np.zeros(len(model), bool))
    ji, js = _jax_nn(q, model, np.zeros(len(model), bool))
    assert np.all(ti == 0) and np.all(np.isinf(ts))
    assert np.array_equal(ti, ji) and np.array_equal(ts, js)


@pytest.mark.parametrize("m,v", [(600, 3000), (513, 257), (1, 300), (100, 1000)])
def test_plain_matches_jax_on_the_kernel_seams(m, v):
    """The cases planted at the CUDA kernel's seams (ops/kernels/seams.py):
    exact ties across sub-tile, tile and split boundaries and at the last
    row, an all-invalid sub-tile and tile.  The reference and the plain
    version agree on every index (the lower one on each tie) and within
    2 ulp on every distance."""
    case = seams.nn_seam_case(m, v)
    ti, ts = _torch_nn(case.queries, case.model, case.valid)
    ji, js = _jax_nn(case.queries, case.model, case.valid)
    assert np.array_equal(ti, ji)
    assert np.array_equal(ti[case.tie_rows], case.tie_index)
    finite = np.isfinite(js)
    assert np.array_equal(np.isfinite(ts), finite)
    ulps = np.abs(ts[finite].view(np.int32).astype(np.int64)
                  - js[finite].astype(np.float32).view(np.int32).astype(np.int64))
    assert ulps.size == 0 or ulps.max() <= 2


def test_seam_case_plants_what_it_says():
    case = seams.nn_seam_case(600, 3000)
    sub, tile = seams.NN_SUB, seams.NN_TILE
    assert not case.valid[3 * sub:4 * sub].any()
    assert not case.valid[2 * tile:3 * tile].any()
    assert case.valid[:3 * sub].any() and case.valid[4 * sub:2 * tile].any()
    tied = {int(a) for a in case.tie_index}
    assert {sub - 1, tile - 1, 2 * tile - 1} <= tied  # the lower copy of each pair
    for row, index in zip(case.tie_rows, case.tie_index):
        same = np.all(case.model == case.model[index], axis=1) & case.valid
        assert same.sum() >= 1 and np.flatnonzero(same)[0] == index
        assert np.abs(case.queries[row] - case.model[index]).max() < 0.01


def test_plain_matches_pallas_kernel_interpret():
    """The Pallas body itself, interpreted on the CPU."""
    from jax.experimental.pallas import tpu as pltpu
    rng = np.random.default_rng(2)
    q, model = _cloud(rng, 512), _cloud(rng, 1024)
    valid = rng.random(1024) < 0.9
    with jax.enable_x64(False), pltpu.force_tpu_interpret_mode():
        pi, ps = nn_argmin_pallas(jnp.asarray(q), jnp.asarray(model),
                                  jnp.asarray(valid))
    pi, ps = np.asarray(pi), np.asarray(ps)
    ti, ts = _torch_nn(q, model, valid)
    tol = 8 * EPS32 * (np.sum(q * q, 1) + np.sum(model[ti] ** 2, 1))
    assert np.all(np.abs(ps - ts) <= tol)
    # the runner-up distance: indices must agree where the gap exceeds tol
    d = ((q[:, None, :].astype(np.float64) - model[None]) ** 2).sum(-1)
    d[:, ~valid] = np.inf
    second = np.sort(d, axis=1)[:, 1]
    clear = second - d[np.arange(512), ti] > tol
    assert clear.mean() > 0.95
    assert np.array_equal(pi[clear], ti[clear])


def test_icp3d_brute_force_nn_is_b2():
    rng = np.random.default_rng(3)
    q, model = _cloud(rng, 64), _cloud(rng, 200)
    before = b2.nn_argmin.launches
    i1, s1 = ticp3d.brute_force_nn(torch.from_numpy(q), torch.from_numpy(model))
    i2, s2 = b2.nn_argmin_plain(torch.from_numpy(q), torch.from_numpy(model))
    assert b2.nn_argmin.launches == before  # CPU: the plain version
    assert torch.equal(i1, i2) and torch.equal(s1, s2)


def test_cpu_tensors_run_the_plain_version():
    rng = np.random.default_rng(4)
    q, model = map(torch.from_numpy, (_cloud(rng, 100), _cloud(rng, 300)))
    valid = torch.ones(300, dtype=torch.bool)
    before = b2.nn_argmin.launches
    out = b2.nn_argmin(q, model, valid, active=torch.tensor(False))
    assert b2.nn_argmin.launches == before
    ref = b2.nn_argmin_plain(q, model, valid)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))


def test_non_cpu_tensors_never_take_the_plain_version():
    meta = (torch.empty((64, 3), device="meta"), torch.empty((128, 3), device="meta"),
            torch.empty((128,), dtype=torch.bool, device="meta"))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        b2.nn_argmin(*meta)


@pytest.fixture
def no_compiler(monkeypatch, tmp_path):
    from pylidar_slam_tpu_torch.ops.kernels import cuda_build
    from pylidar_slam_tpu_torch.utils import build
    monkeypatch.setattr(cuda_build, "nvcc_path",
                        lambda: str(tmp_path / "no-such-nvcc"))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    b2._library.cache_clear()
    yield
    b2._library.cache_clear()


def test_failed_build_raises_past_the_checks(no_compiler, monkeypatch):
    """A non-CPU tensor that passes the checks goes to the kernel library:
    with a failed build the call raises and never computes the plain
    version."""
    with pytest.raises(BuildError):
        b2.build()
    monkeypatch.setattr(b2, "_check", lambda *args: None)
    meta = (torch.empty((64, 3), device="meta"), torch.empty((128, 3), device="meta"),
            torch.empty((128,), dtype=torch.bool, device="meta"))
    before = b2.nn_argmin.launches
    with pytest.raises(BuildError):
        b2.nn_argmin(*meta)
    assert b2.nn_argmin.launches == before


# ---------------------------------------------------------------------------
# voxel.py and the surfel map's fixed-size grid sampling
# ---------------------------------------------------------------------------

def _scan_like(rng, n=6000):
    """A cloud with many points per 0.3 m voxel, some on .5 rounding
    boundaries, some masked out."""
    pts = (rng.normal(size=(n, 3)) * np.array([15.0, 15.0, 2.0])).astype(np.float32)
    pts[: n // 10] = np.round(pts[: n // 10] / 0.15) * np.float32(0.15)
    mask = rng.random(n) < 0.9
    return pts, mask


@pytest.mark.parametrize("voxel_size", [0.3, 0.4])
def test_grid_sample_mask_matches_jax(voxel_size):
    pts, mask = _scan_like(np.random.default_rng(5))
    with jax.enable_x64(False):
        jc = np.asarray(jvox.voxelise(jnp.asarray(pts), voxel_size))
        jh = np.asarray(jvox.voxel_hash(jnp.asarray(jc)))
        jm = np.asarray(jvox.grid_sample_mask(jnp.asarray(pts), voxel_size,
                                              mask=jnp.asarray(mask)))
    tc = tvox.voxelise(torch.from_numpy(pts), voxel_size)
    assert tc.dtype == torch.int32 and np.array_equal(tc.numpy(), jc)
    assert np.array_equal(tvox.voxel_hash(tc).numpy(), jh.astype(np.int64))
    tm = tvox.grid_sample_mask(torch.from_numpy(pts), voxel_size,
                               mask=torch.from_numpy(mask)).numpy()
    assert np.array_equal(tm, jm) and 0 < tm.sum() < mask.sum()


@pytest.mark.parametrize("capacity", [512, 4096])
def test_grid_sample_fixed_matches_jax(capacity):
    """The kept subset and its order; at 512 the winners overflow the
    capacity and the hash-priority order decides which survive."""
    pts, mask = _scan_like(np.random.default_rng(6))
    with jax.enable_x64(False):
        jp, ji, jv = (np.asarray(x) for x in jsm._grid_sample_fixed(
            jnp.asarray(pts), jnp.asarray(mask), 0.3, capacity))
    tp, ti, tv = tsm._grid_sample_fixed(torch.from_numpy(pts),
                                        torch.from_numpy(mask), 0.3, capacity)
    assert np.array_equal(ti.numpy(), ji) and np.array_equal(tv.numpy(), jv)
    assert np.array_equal(tp.numpy(), jp)


# ---------------------------------------------------------------------------
# hash_nn.py
# ---------------------------------------------------------------------------

RADIUS, VOXEL = 1.0, 2.0


def _grid_case(seed, n=4096, m=512, cap=32, buckets=2048):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-20, 20, size=(n, 3)).astype(np.float32)
    valid = np.ones(n, bool)
    valid[::13] = False
    q = (pts[rng.integers(0, n, size=m)]
         + rng.normal(0, 0.4, size=(m, 3))).astype(np.float32)
    return pts, valid, q, cap, buckets


@pytest.mark.parametrize("cap", [4, 32])
def test_hash_grid_build_and_pack_match_jax(cap):
    """cap 4 overflows buckets (deterministic drops), cap 32 does not."""
    pts, valid, _, _, buckets = _grid_case(7)
    with jax.enable_x64(False):
        js = jhash.build_hash_grid(jnp.asarray(pts), jnp.asarray(valid), VOXEL,
                                   buckets, cap)
        jp, jids = jhash.pack_grid(jnp.asarray(pts), js, cap)
        jb = np.asarray(jhash._bucket_of(jnp.asarray(
            np.floor(pts / VOXEL).astype(np.int32)), buckets))
    ts = thash.build_hash_grid(torch.from_numpy(pts), torch.from_numpy(valid),
                               VOXEL, buckets, cap)
    assert ts.dtype == torch.int32 and np.array_equal(ts.numpy(), np.asarray(js))
    tp, tids = thash.pack_grid(torch.from_numpy(pts), ts, cap)
    assert np.array_equal(tids.numpy(), np.asarray(jids))
    assert np.array_equal(tp.numpy(), np.asarray(jp))
    tb = thash._bucket_of(torch.from_numpy(np.floor(pts / VOXEL).astype(np.int32)),
                          buckets)
    assert np.array_equal(tb.numpy(), jb)


@pytest.mark.parametrize("packed", [False, True])
def test_hash_grid_nn_and_knn_match_jax(packed):
    pts, valid, q, cap, buckets = _grid_case(8)
    with jax.enable_x64(False):
        slots = jhash.build_hash_grid(jnp.asarray(pts), jnp.asarray(valid),
                                      VOXEL, buckets, cap)
        if packed:
            slots = jhash.pack_grid(jnp.asarray(pts), slots, cap)
        ji, jd = jhash.hash_grid_nn(jnp.asarray(q), jnp.asarray(pts), slots,
                                    VOXEL, buckets, cap, RADIUS)
        jki, jkd = jhash.hash_grid_knn(jnp.asarray(q), jnp.asarray(pts), slots,
                                       VOXEL, buckets, cap, RADIUS, 10)
    tslots = thash.build_hash_grid(torch.from_numpy(pts), torch.from_numpy(valid),
                                   VOXEL, buckets, cap)
    if packed:
        tslots = thash.pack_grid(torch.from_numpy(pts), tslots, cap)
    ti, td = thash.hash_grid_nn(torch.from_numpy(q), torch.from_numpy(pts), tslots,
                                VOXEL, buckets, cap, RADIUS)
    tki, tkd = thash.hash_grid_knn(torch.from_numpy(q), torch.from_numpy(pts),
                                   tslots, VOXEL, buckets, cap, RADIUS, 10)
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    assert np.array_equal(td.numpy(), np.asarray(jd))
    assert np.array_equal(tki.numpy(), np.asarray(jki))
    assert np.array_equal(tkd.numpy(), np.asarray(jkd))
    assert np.isfinite(tkd.numpy()).any() and np.isinf(tkd.numpy()).any()


def test_hash_knn_ties_keep_the_lower_candidate():
    """Coincident map points: the k nearest are the lower candidate slots
    first, as lax.top_k orders them."""
    pts = np.repeat(np.array([[1.0, 1.0, 1.0], [1.5, 1.0, 1.0]], np.float32),
                    8, axis=0)
    valid = np.ones(len(pts), bool)
    q = np.array([[1.1, 1.0, 1.0]], np.float32)
    with jax.enable_x64(False):
        slots = jhash.build_hash_grid(jnp.asarray(pts), jnp.asarray(valid),
                                      VOXEL, 64, 32)
        ji, jd = jhash.hash_grid_knn(jnp.asarray(q), jnp.asarray(pts), slots,
                                     VOXEL, 64, 32, RADIUS, 12)
    tslots = thash.build_hash_grid(torch.from_numpy(pts), torch.from_numpy(valid),
                                   VOXEL, 64, 32)
    ti, td = thash.hash_grid_knn(torch.from_numpy(q), torch.from_numpy(pts),
                                 tslots, VOXEL, 64, 32, RADIUS, 12)
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    assert np.array_equal(td.numpy(), np.asarray(jd))
    assert list(ti.numpy()[0]) == list(range(8)) + [8, 9, 10, 11]


# ---------------------------------------------------------------------------
# geometry.py (k-NN plane normals) and the damped GN step
# ---------------------------------------------------------------------------

def _assert_equal_up_to_sign(ours, ref, atol=1e-5):
    flip = np.sum(ours * ref, axis=-1, keepdims=True) < 0
    np.testing.assert_allclose(np.where(flip, -ours, ours), ref, rtol=0, atol=atol)


def test_smallest_eigenvector_matches_jax():
    rng = np.random.default_rng(9)
    a = rng.normal(size=(300, 3, 3))
    covs = (a @ a.transpose(0, 2, 1)).astype(np.float32)
    covs[:10] = np.eye(3, dtype=np.float32)  # isotropic: zero vector
    with jax.enable_x64(False):
        jv = np.asarray(jgeo.smallest_eigenvector_3x3(jnp.asarray(covs)))
    tv = tgeo.smallest_eigenvector_3x3(torch.from_numpy(covs)).numpy()
    _assert_equal_up_to_sign(tv, jv)
    assert np.all(tv[:10] == 0)
    _, vecs = np.linalg.eigh(covs[10:].astype(np.float64))
    assert np.abs(np.sum(tv[10:] * vecs[:, :, 0], axis=1)).min() > 0.999


def test_knn_plane_normals_match_jax():
    """Noisy tilted planes with some neighbours masked out, and queries with
    too few valid neighbours (zero normal)."""
    rng = np.random.default_rng(10)
    m, k = 256, 10
    normal = rng.normal(size=(m, 3))
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    u = np.cross(normal, rng.normal(size=(m, 3)))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    w = np.cross(normal, u)
    coef = rng.uniform(-1, 1, size=(m, k, 2))
    nb = (coef[..., :1] * u[:, None] + coef[..., 1:] * w[:, None]
          + 0.01 * rng.normal(size=(m, k, 3)) + rng.uniform(-30, 30, size=(m, 1, 3)))
    nb = nb.astype(np.float32)
    valid = rng.random((m, k)) < 0.8
    valid[:8, 2:] = False  # two valid neighbours: below min_neighbors
    with jax.enable_x64(False):
        jn = np.asarray(jgeo.knn_plane_normals(jnp.asarray(nb), jnp.asarray(valid)))
    tn = tgeo.knn_plane_normals(torch.from_numpy(nb), torch.from_numpy(valid)).numpy()
    _assert_equal_up_to_sign(tn, jn)
    assert np.all(tn[:8] == 0)
    assert np.abs(np.sum(tn[8:] * normal[8:], axis=1)).min() > 0.99


def test_damped_gauss_newton_step_matches_jax():
    rng = np.random.default_rng(11)
    res = rng.normal(size=500).astype(np.float32) * 0.1
    jac = rng.normal(size=(500, 6)).astype(np.float32)
    wts = rng.random(500).astype(np.float32)
    for damping in (0.0, 1e-3):
        with jax.enable_x64(False):
            jdx, jloss, jsing = jopt.gauss_newton_step(
                jnp.asarray(res), jnp.asarray(jac), jnp.asarray(wts), damping=damping)
        tdx, tloss, tsing = topt.gauss_newton_step(
            torch.from_numpy(res), torch.from_numpy(jac), torch.from_numpy(wts),
            damping=damping)
        np.testing.assert_allclose(tdx.numpy(), np.asarray(jdx), rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
        assert bool(tsing) == bool(jsing) is False
    undamped = topt.gauss_newton_step(torch.from_numpy(res), torch.from_numpy(jac),
                                      torch.from_numpy(wts))[0]
    assert not torch.allclose(tdx, undamped, rtol=1e-3)  # damping changed dx
    assert math.isfinite(float(tloss))
