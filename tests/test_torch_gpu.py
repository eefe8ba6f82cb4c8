"""Card-only tests of the port's CUDA kernels (marker ``gpu``).

This file imports no jax, so it runs on a machine with a card and no jax:

    python -m pytest tests/test_torch_gpu.py --noconftest -m gpu -q

Without a CUDA device every test skips (decided inside the fixture).
Tolerances: B1, each sum within 2e-5 of its Cauchy-Schwarz scale
(``assoc_gn.sum_errors``; float32 sums of 65536 terms in two tree orders),
the match count exact.  B2 forms the same float32 sums in the same order
as its plain version: identical indices, squared distances bit-identical
(0 ulp).
"""
import numpy as np
import pytest
import torch

from pylidar_slam_tpu_torch.ops.kernels import assoc_gn as b1
from pylidar_slam_tpu_torch.ops.kernels import nn_argmin as b2
from pylidar_slam_tpu_torch.ops.kernels import seams

H, W = 64, 1024


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _images(dev):
    rng = np.random.default_rng(0)
    base = np.cumsum(rng.normal(size=(H, W, 3)).astype(np.float32) * 0.1, axis=1)
    base += np.array([20.0, -5.0, 1.0], np.float32)
    timg = base + rng.normal(size=(H, W, 3)).astype(np.float32) * 0.05
    model = base + rng.normal(size=(H, W, 3)).astype(np.float32) * 0.05
    normals = rng.normal(size=(H, W, 3)).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    valid = rng.random((H, W)) < 0.9
    model[~valid] = 0.0
    normals[~valid] = 0.0
    return [torch.from_numpy(a).to(dev) for a in (timg, model, normals, valid)]


@pytest.mark.gpu
@pytest.mark.parametrize("plane_gate", [0.0, 0.05])
@pytest.mark.parametrize("scheme", sorted(b1.SCHEME_IDS))
def test_assoc_gn_kernel_matches_plain(cuda, scheme, plane_gate):
    args = (*_images(cuda), 1, 2, 0.6, scheme, 0.4, plane_gate)
    before = b1.assoc_gn.launches
    ours = b1.assoc_gn(*args)
    again = b1.assoc_gn(*args)
    assert b1.assoc_gn.launches == before + 2
    ref = b1.assoc_gn_plain(*args)
    ours, again, ref = (x.cpu().numpy().astype(np.float64) for x in (ours, again, ref))
    assert np.array_equal(ours, again)  # no float atomics: bit-repeatable
    assert ours[28] == ref[28] > 0
    assert b1.sum_errors(ours, ref)[1] <= 2e-5


@pytest.mark.gpu
@pytest.mark.parametrize("region", ["wrap columns", "border rows", "strip edges", "all"])
@pytest.mark.parametrize("h,w,wr,wc", [(64, 1024, 1, 2), (16, 1000, 1, 2),
                                       (8, 1022, 2, 3), (8, 300, 0, 0),
                                       (16, 1000, 3, 20), (128, 1024, 1, 2),
                                       (8, 1024, 2, 6)])
def test_assoc_gn_seams_match_plain(cuda, region, h, w, wr, wc):
    """Matches across the azimuth wrap, beyond the border rows and on the
    kernel's strip edges; W off the strip width and off a multiple of 16
    (the per-float staging), no window, a wide window on the 16-byte
    staging, a halo over 48 KB of shared memory, and more blocks than one
    pass of the final sum."""
    images = [torch.from_numpy(a).to(cuda) for a in seams.assoc_seam_images(h, w, region)]
    for scheme, plane in (("geman_mcclure", 0.0), ("neighborhood", 0.05)):
        args = (*images, wr, wc, 0.6, scheme, 0.4, plane)
        ours = b1.assoc_gn(*args).cpu().numpy().astype(np.float64)
        ref = b1.assoc_gn_plain(*args).cpu().numpy().astype(np.float64)
        assert ours[28] == ref[28] > 0
        assert b1.sum_errors(ours, ref)[1] <= 2e-5


@pytest.mark.gpu
def test_assoc_gn_repeats_bit_for_bit(cuda):
    """200 calls in a row give the same sums: the last-block counter is
    back at 0 after every call."""
    args = (*_images(cuda), 1, 2, 0.6, "geman_mcclure", 0.4, 0.0)
    first = b1.assoc_gn(*args)
    outs = torch.stack([b1.assoc_gn(*args) for _ in range(200)])
    assert torch.equal(outs, first.expand_as(outs))


@pytest.mark.gpu
def test_assoc_gn_rejects_bad_inputs(cuda):
    timg, model, normals, valid = _images(cuda)
    with pytest.raises(ValueError, match="contiguous"):
        b1.assoc_gn(timg.transpose(0, 1).contiguous().transpose(0, 1), model,
                    normals, valid, 1, 2, 0.6, "geman_mcclure", 0.4)
    with pytest.raises(ValueError, match="float32"):
        b1.assoc_gn(timg.double(), model, normals, valid, 1, 2, 0.6,
                    "geman_mcclure", 0.4)


@pytest.mark.gpu
def test_failed_build_raises_on_cuda_tensors(cuda, monkeypatch, tmp_path):
    """With no compiler, a CUDA call raises instead of running the plain
    version."""
    from pylidar_slam_tpu_torch.ops.kernels import cuda_build
    from pylidar_slam_tpu_torch.utils import build
    monkeypatch.setattr(cuda_build, "nvcc_path",
                        lambda: str(tmp_path / "no-such-nvcc"))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    b1._library.cache_clear()
    before = b1.assoc_gn.launches
    try:
        with pytest.raises(build.BuildError):
            b1.assoc_gn(*_images(cuda), 1, 2, 0.6, "geman_mcclure", 0.4)
    finally:
        b1._library.cache_clear()
    assert b1.assoc_gn.launches == before


def _assert_nn_matches_plain(queries, model, valid):
    before = b2.nn_argmin.launches
    idx, sq = b2.nn_argmin(queries, model, valid)
    idx2, sq2 = b2.nn_argmin(queries, model, valid)
    assert b2.nn_argmin.launches == before + 2
    ridx, rsq = b2.nn_argmin_plain(queries, model, valid)
    assert idx.dtype == torch.int32 and sq.dtype == torch.float32
    assert torch.equal(idx, idx2) and torch.equal(sq, sq2)  # bit-repeatable
    assert torch.equal(idx, ridx)
    idx, sq, rsq = idx.cpu().numpy(), sq.cpu().numpy(), rsq.cpu().numpy()
    finite = np.isfinite(rsq)
    assert np.array_equal(np.isfinite(sq), finite)
    ulps = np.abs(sq[finite].view(np.int32).astype(np.int64)
                  - rsq[finite].view(np.int32).astype(np.int64))
    assert ulps.size == 0 or ulps.max() == 0
    return idx, sq


def _nn_case(dev, m, v, seed=0, frac_valid=0.9):
    rng = np.random.default_rng(seed)
    model = (rng.normal(size=(v, 3)) * 20).astype(np.float32)
    queries = (model[rng.integers(0, v, size=m)]
               + rng.normal(size=(m, 3)).astype(np.float32) * 0.3)
    valid = rng.random(v) < frac_valid
    return [torch.from_numpy(a).to(dev) for a in (queries, model, valid)]


@pytest.mark.gpu
@pytest.mark.parametrize("m,v", [(16384, 122880), (1001, 12345), (1, 1), (300, 7)])
def test_nn_argmin_kernel_matches_plain(cuda, m, v):
    """The surfel champion's shapes, and sizes that are no multiple of the
    kernel's tiles."""
    idx, _ = _assert_nn_matches_plain(*_nn_case(cuda, m, v))
    assert idx.min() >= 0 and idx.max() < v


@pytest.mark.gpu
def test_nn_argmin_duplicates_and_empty_map(cuda):
    queries, model, valid = _nn_case(cuda, 1000, 3000)
    dup = torch.cat([model, model, model])  # row i == i + 3000 == i + 6000
    dup_valid = torch.cat([valid, torch.ones_like(valid), torch.ones_like(valid)])
    idx, _ = _assert_nn_matches_plain(model[::3] + 0.01, dup, dup_valid)
    rows = np.arange(0, 3000, 3)
    assert np.array_equal(idx, np.where(valid.cpu().numpy()[rows], rows, rows + 3000))
    idx, sq = _assert_nn_matches_plain(queries, dup, torch.zeros_like(dup_valid))
    assert np.all(idx == 0) and np.all(np.isinf(sq))


@pytest.mark.gpu
@pytest.mark.parametrize("m,v", [(16384, 122880), (16384 + 77, 122880 - 100),
                                 (1000, 12345), (513, 257), (1, 300)])
def test_nn_argmin_seams_match_plain(cuda, m, v):
    """Exact ties across sub-tile, tile and split boundaries and at the
    last row (the lower index wins), an all-invalid sub-tile and tile
    between finite ones; the champion's shapes first, then M off the
    queries per block and V off the tile."""
    case = seams.nn_seam_case(m, v)
    idx, _ = _assert_nn_matches_plain(*(torch.from_numpy(a).to(cuda) for a in
                                        (case.queries, case.model, case.valid)))
    assert np.array_equal(idx[case.tie_rows], case.tie_index)


@pytest.mark.gpu
def test_nn_argmin_active_flag(cuda):
    """False skips the pass without a host sync (index 0, +inf); True
    computes it; both launch the kernel."""
    args = _nn_case(cuda, 4096, 20000)
    before = b2.nn_argmin.launches
    idx, sq = b2.nn_argmin(*args, active=torch.zeros((), dtype=torch.bool, device=cuda))
    assert bool((idx == 0).all()) and bool(torch.isinf(sq).all())
    on = b2.nn_argmin(*args, active=torch.ones((), dtype=torch.bool, device=cuda))
    full = b2.nn_argmin(*args)
    assert torch.equal(on[0], full[0]) and torch.equal(on[1], full[1])
    assert b2.nn_argmin.launches == before + 3


@pytest.mark.gpu
def test_nn_argmin_rejects_bad_inputs(cuda):
    queries, model, valid = _nn_case(cuda, 64, 256)
    with pytest.raises(ValueError, match="contiguous"):
        b2.nn_argmin(queries.t().contiguous().t(), model, valid)
    with pytest.raises(ValueError, match="float32"):
        b2.nn_argmin(queries.double(), model, valid)
    with pytest.raises(ValueError, match="bool"):
        b2.nn_argmin(queries, model, valid.to(torch.uint8))
    with pytest.raises(ValueError, match="active"):
        b2.nn_argmin(queries, model, valid, active=torch.ones(2, dtype=torch.bool,
                                                              device=cuda))


@pytest.mark.gpu
def test_icp_refine_on_b2_matches_the_cpu(cuda):
    """The loop closure's refine on the card (B2, the device flag skipping
    frozen and gated-off candidates) against the same refine on the CPU
    (the plain version): launches counted per candidate and trip, poses
    within 1e-4."""
    from pylidar_slam_tpu_torch.ops import icp3d
    rng = np.random.default_rng(3)
    cloud = rng.uniform(-20, 20, (4096, 3)).astype(np.float32)
    cloud[:, 2] *= 0.1
    rot = np.array([[np.cos(0.05), -np.sin(0.05), 0], [np.sin(0.05), np.cos(0.05), 0],
                    [0, 0, 1]], np.float32)
    target = (cloud @ rot.T + np.array([0.3, -0.2, 0.0], np.float32))[None].repeat(3, 0)
    masks = np.ones((3, 4096), bool)
    masks[:, 4000:] = False
    active = torch.tensor([True, True, False])
    args = [torch.from_numpy(cloud), torch.from_numpy(target), torch.from_numpy(masks)]
    cpu = icp3d.icp_align(args[0], args[1], target_mask=args[2], active=active,
                          max_corr_dist=2.0)
    before = b2.nn_argmin.launches
    dev = icp3d.icp_align(*(a.to(cuda) for a in args[:2]), target_mask=args[2].to(cuda),
                          active=active.to(cuda), max_corr_dist=2.0)
    assert b2.nn_argmin.launches == before + 3 * 20
    assert torch.equal(dev.num_iters.cpu(), cpu.num_iters)
    assert int(dev.num_iters[2]) == 0
    np.testing.assert_allclose(dev.transform.cpu().numpy(), cpu.transform.numpy(), atol=1e-4)
