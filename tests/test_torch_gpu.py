"""Card-only tests of the port's CUDA kernels (marker ``gpu``).

This file imports no jax, so it runs on a machine with a card and no jax:

    python -m pytest tests/test_torch_gpu.py --noconftest -m gpu -q

Without a CUDA device every test skips (decided inside the fixture).
Tolerance: each sum within 2e-5 of its Cauchy-Schwarz scale
(``assoc_gn.sum_errors``; float32 sums of 65536 terms in two tree orders),
the match count exact.
"""
import numpy as np
import pytest
import torch

from pylidar_slam_tpu_torch.ops.kernels import assoc_gn as b1

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
