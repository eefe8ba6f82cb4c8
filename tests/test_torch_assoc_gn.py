"""Kernel B1 (fused window association + normal equations): the port's plain
version against the JAX package's XLA composite and its Pallas kernel, and
the wrapper's dispatch rules.  The CUDA kernel itself is compared with the
plain version on the card (chip_smoke.py, tests/test_torch_gpu.py).

Tolerance of the sums: float32 sums of 4096 terms taken in another order
differ by ~n_eff * eps of their Cauchy-Schwarz scale (``assoc_gn.sum_errors``):
each sum is held to 2e-5 of its scale, the match count exactly.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pylidar_slam_tpu.ops import optimization as jopt
from pylidar_slam_tpu.ops.pallas.assoc_gn_kernel import window_assoc_gn_pallas
from pylidar_slam_tpu.slam.odometry import aggregated_map as jam

from pylidar_slam_tpu_torch.ops.kernels import assoc_gn as k
from pylidar_slam_tpu_torch.ops.kernels import seams
from pylidar_slam_tpu_torch.utils.build import BuildError

H, W = 16, 256
UPPER = [(a, b) for a in range(6) for b in range(a, 6)]
SCHEMES = ["least_square", "huber", "exp", "neighborhood", "geman_mcclure",
           "square_geman_mcclure", "cauchy", "default"]
# (sigma, gate) along an anneal from (2.0, 3.0) down to the champion's
# (0.4, 0.6) over 4 iterations: iterations 0, 2 and 4
ANNEALED = [(2.0, 3.0), (2.0 * 0.2 ** 0.5, 3.0 * 0.2 ** 0.5), (0.4, 0.6)]


@functools.lru_cache(maxsize=None)
def _images(seed: int = 0):
    """Random but surface-like (H, W) target / model images, tie-free."""
    rng = np.random.default_rng(seed)
    base = np.cumsum(rng.normal(size=(H, W, 3)).astype(np.float32) * 0.1, axis=1)
    base += np.array([20.0, -5.0, 1.0], np.float32)  # lever arms of a real scan
    timg = base + rng.normal(size=(H, W, 3)).astype(np.float32) * 0.05
    model_xyz = base + rng.normal(size=(H, W, 3)).astype(np.float32) * 0.05
    normals = rng.normal(size=(H, W, 3)).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    mvalid = rng.random((H, W)) < 0.9
    model_xyz[~mvalid] = 0.0
    normals[~mvalid] = 0.0
    normals[rng.random((H, W)) < 0.05] = 0.0  # valid pixels without a normal
    timg[rng.random((H, W)) < 0.05] = 0.0  # empty target pixels
    return timg, model_xyz, normals, mvalid


@functools.partial(jax.jit, static_argnames=("scheme", "plane"))
def _jax_composite(timg, model_xyz, normals, mvalid, sigma, gate, plane_gate,
                   scheme, plane):
    """The JAX main path's iteration (aggregated_map.py:426-501) up to the
    normal equations, in the kernel's 30-sum layout."""
    state = jam.init_agg_map(timg.shape[0], timg.shape[1])._replace(
        xyz=model_xyz, normal=normals, rng=jnp.where(mvalid, 1.0, 0.0))
    ref, nrm, ok, sq_d = jam.window_associate(state, timg, 1, 2, gate)
    tp = timg.reshape(-1, 3)
    zero6 = jnp.zeros(6, jnp.float32)
    res = jopt.point_to_plane_residuals(zero6, tp, ref, nrm, ok)
    if plane:
        ok = ok & (jnp.abs(res) <= plane_gate)
        res = jnp.where(ok, res, 0.0)
    jac = jopt.point_to_plane_jacobian(zero6, tp, nrm, ok)
    wts = jopt.robust_weights(scheme, res, sigma, sq_dists=sq_d)
    wres, wjac = res * wts, jac * wts[:, None]
    h = jnp.sum(wjac[:, :, None] * wjac[:, None, :], axis=0)
    g = jnp.sum(wjac * wres[:, None], axis=0)
    upper = jnp.stack([h[a, b] for a, b in UPPER])
    tail = jnp.stack([jnp.sum(wres * wres), jnp.sum(ok).astype(jnp.float32),
                      jnp.sum(jnp.where(ok, wts * wts, 0.0))])
    return jnp.concatenate([upper, g, tail])


def _assert_sums_close(ours, ref, rtol=2e-5):
    assert ours.shape == ref.shape == (30,)
    assert ours[28] == ref[28], f"match count {ours[28]} vs {ref[28]}"
    _, scaled = k.sum_errors(ours, ref)
    assert scaled <= rtol, (scaled, ours, ref)


@pytest.mark.parametrize("plane_gate", [0.0, 0.05])
@pytest.mark.parametrize("sigma,gate", ANNEALED)
@pytest.mark.parametrize("scheme", SCHEMES)
def test_plain_matches_jax_composite(scheme, sigma, gate, plane_gate):
    timg, model_xyz, normals, mvalid = _images()
    with jax.enable_x64(False):
        ref = np.asarray(_jax_composite(
            *map(jnp.asarray, (timg, model_xyz, normals, mvalid)),
            jnp.float32(sigma), jnp.float32(gate), jnp.float32(plane_gate),
            scheme=scheme, plane=plane_gate > 0))
    ours = k.assoc_gn(*map(torch.from_numpy, (timg, model_xyz, normals, mvalid)),
                      1, 2, gate, scheme, sigma, plane_gate)
    assert ours.dtype == torch.float32
    _assert_sums_close(ours.numpy(), ref)
    if plane_gate > 0:  # the plane gate really removed matches
        full = k.assoc_gn_plain(*map(torch.from_numpy,
                                     (timg, model_xyz, normals, mvalid)),
                                1, 2, gate, scheme, sigma)
        assert float(ours[28]) < float(full[28])


@pytest.mark.parametrize("scheme,sigma", [("neighborhood", 0.2),
                                          ("geman_mcclure", 0.4)])
def test_plain_matches_pallas_kernel_interpret(scheme, sigma):
    """The Pallas kernel differs from the XLA spec only on exact distance
    ties, at the gate boundary and for Cauchy below eps -- none of which this
    data has -- so all its outputs agree here."""
    timg, model_xyz, normals, mvalid = _images()
    with jax.enable_x64(False):
        h_mat, g, loss, count, wmass = window_assoc_gn_pallas(
            *map(jnp.asarray, (timg, model_xyz, normals, mvalid)),
            wr=1, wc=2, max_nd=0.6, scheme=scheme, sigma=sigma, interpret=True)
    hp, gp, lp, cp, wp = k.unpack(k.assoc_gn_plain(
        *map(torch.from_numpy, (timg, model_xyz, normals, mvalid)),
        1, 2, 0.6, scheme, sigma))
    assert int(cp) == int(count)
    # at least as tight as tests/test_pallas_kernels.py (rtol 0.02 on H)
    for ours, ref in ((hp, h_mat), (gp, g), (lp, loss), (wp, wmass)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-4,
                                   atol=1e-4 * np.abs(ref).max())


@pytest.mark.parametrize("h,w", [(16, 256), (8, 300)])
@pytest.mark.parametrize("region", ["wrap columns", "border rows", "strip edges", "all"])
def test_plain_matches_jax_on_the_kernel_seams(region, h, w):
    """Matches across the azimuth wrap, beyond the border rows and on the
    CUDA kernel's strip edges (ops/kernels/seams.py), where only those
    pixels carry a target; W = 300 leaves a ragged strip."""
    timg, model_xyz, normals, mvalid = seams.assoc_seam_images(h, w, region)
    with jax.enable_x64(False):
        ref = np.asarray(_jax_composite(
            *map(jnp.asarray, (timg, model_xyz, normals, mvalid)),
            jnp.float32(0.4), jnp.float32(0.6), jnp.float32(0.0),
            scheme="geman_mcclure", plane=False))
    ours = k.assoc_gn_plain(*map(torch.from_numpy, (timg, model_xyz, normals, mvalid)),
                            1, 2, 0.6, "geman_mcclure", 0.4)
    assert ref[28] > 0
    _assert_sums_close(ours.numpy(), ref)


def test_window_associate_matches_jax():
    """The map's plain association (what B1 fuses) picks the same candidate
    for every pixel as the JAX package's, with the same squared distance."""
    from pylidar_slam_tpu_torch.slam.odometry import aggregated_map as tam
    timg, model_xyz, normals, mvalid = _images()
    rng = np.where(mvalid, 1.0, 0.0).astype(np.float32)
    with jax.enable_x64(False):
        jstate = jam.init_agg_map(H, W)._replace(
            xyz=jnp.asarray(model_xyz), normal=jnp.asarray(normals),
            rng=jnp.asarray(rng))
        ref = jam.window_associate(jstate, jnp.asarray(timg), 1, 2, 0.6)
    tstate = tam.init_agg_map(H, W, "cpu")._replace(
        xyz=torch.from_numpy(model_xyz), normal=torch.from_numpy(normals),
        rng=torch.from_numpy(rng))
    ours = tam.window_associate(tstate, torch.from_numpy(timg), 1, 2, 0.6)
    for a, b in zip(ours, ref):  # the same float32 operations: bit-identical
        assert np.array_equal(a.numpy(), np.asarray(b))


def test_unpack_layout():
    sums = torch.arange(30, dtype=torch.float32)
    h, g, loss, count, wmass = k.unpack(sums)
    assert torch.equal(h, h.T)
    assert h[0, 0] == 0 and h[0, 5] == 5 and h[1, 1] == 6 and h[5, 5] == 20
    assert torch.equal(g, torch.arange(21, 27, dtype=torch.float32))
    assert (float(loss), float(count), float(wmass)) == (27.0, 28.0, 29.0)


def test_cpu_tensors_run_the_plain_version():
    timg, model_xyz, normals, mvalid = map(torch.from_numpy, _images())
    before = k.assoc_gn.launches
    out = k.assoc_gn(timg, model_xyz, normals, mvalid, 1, 2, 0.6,
                     "geman_mcclure", 0.4)
    assert k.assoc_gn.launches == before  # the kernel was not launched
    assert torch.equal(out, k.assoc_gn_plain(timg, model_xyz, normals, mvalid,
                                             1, 2, 0.6, "geman_mcclure", 0.4))


def test_non_cpu_tensors_never_take_the_plain_version():
    """Off the CPU the wrapper launches the kernel or raises: a tensor on
    another device is refused, not silently computed by the plain version."""
    meta = [torch.empty((H, W, 3), device="meta") for _ in range(3)] + \
        [torch.empty((H, W), dtype=torch.bool, device="meta")]
    with pytest.raises(ValueError, match="CUDA or CPU"):
        k.assoc_gn(*meta, 1, 2, 0.6, "geman_mcclure", 0.4)


@pytest.fixture
def no_compiler(monkeypatch, tmp_path):
    """No CUDA compiler and an empty build directory: the kernel library
    cannot be built."""
    from pylidar_slam_tpu_torch.ops.kernels import cuda_build
    from pylidar_slam_tpu_torch.utils import build
    monkeypatch.setattr(cuda_build, "nvcc_path",
                        lambda: str(tmp_path / "no-such-nvcc"))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    k._library.cache_clear()
    yield
    k._library.cache_clear()


def test_failed_build_raises(no_compiler):
    with pytest.raises(BuildError):
        k.build()


def test_failed_build_raises_past_the_checks(no_compiler, monkeypatch):
    """A non-CPU tensor that passes the wrapper's checks goes to the kernel
    library: with a failed build the call raises, it never computes the
    plain version (on the card, tests/test_torch_gpu.py checks this with
    CUDA tensors)."""
    monkeypatch.setattr(k, "_check", lambda *args: None)
    meta = [torch.empty((H, W, 3), device="meta") for _ in range(3)] + \
        [torch.empty((H, W), dtype=torch.bool, device="meta")]
    before = k.assoc_gn.launches
    with pytest.raises(BuildError):
        k.assoc_gn(*meta, 1, 2, 0.6, "geman_mcclure", 0.4)
    assert k.assoc_gn.launches == before
