"""The port's upload codecs against the JAX package's, on the CPU: the host
buffers byte for byte (native encoder against native, numpy fallback
against numpy fallback), each device decoder on padded buffers, the maps'
``dequant``, the odometry's host buffer per format, and the bench's codec
rule.  The odometry under each codec is in
test_torch_codecs_odometry.py.

Tolerances: decoded points within 2e-5 m (the float32 rounding of cos/sin,
<= 1 ulp, at up to 70 m), validity equal; buffers exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as root_bench
from pylidar_slam_tpu.ops import projection as jproj
from pylidar_slam_tpu.slam.odometry import aggregated_map as jam
from pylidar_slam_tpu.slam.odometry import surfel_map as jsm
from pylidar_slam_tpu.slam.odometry import voxel_map as jvm
from pylidar_slam_tpu.slam.odometry.icp_odometry import ICPFrameToModel as JICP
from pylidar_slam_tpu.slam.odometry.icp_odometry import ICPFrameToModelConfig as JCfg
from pylidar_slam_tpu.utils import native as jnative

from test_torch_bench import TINY, clean_env  # noqa: F401
from test_torch_odometry import _one_torch_thread  # noqa: F401
from pylidar_slam_tpu_torch import bench
from pylidar_slam_tpu_torch.dataset.synthetic import (SyntheticConfig,
                                                      SyntheticDatasetLoader)
from pylidar_slam_tpu_torch.ops import projection as tproj
from pylidar_slam_tpu_torch.slam.odometry import aggregated_map as tam
from pylidar_slam_tpu_torch.slam.odometry.icp_odometry import ICPFrameToModel as TICP
from pylidar_slam_tpu_torch.slam.odometry.icp_odometry import ICPFrameToModelConfig as TCfg
from pylidar_slam_tpu_torch.utils import native as tnative

PROJ = (32, 256, 3.0, -24.0)
POINT_TOL = 2e-5
QUANT = 0.004  # 4 mm int16 steps
N_EXTRA = 40  # far points at random angles appended to each scan
# the formats with a host encoder of their own, and whether it has a native path
RANGE_IMAGES = {"rimg": dict(sub16=False, planes=False),
                "rimg16": dict(sub16=True, planes=False),
                "rimg8": dict(sub16=False, planes=True)}
# the host buffer of each odometry upload, by (format, quantization, dither)
UPLOADS = {"rimg": ("rimg", 0.0, False), "rimg16": ("rimg16", 0.0, False),
           "rimg12": ("rimg12", 0.0, False), "packed": ("packed", 0.0, False),
           "int16": ("f32", QUANT, False), "int16_dither": ("f32", QUANT, True)}


@pytest.fixture(scope="module")
def scans():
    """Three frames of jittered beams and one of pixel-centre beams, with a
    few NaN and far (beyond int16 x 4 mm, and beyond rimg12's 122.8 m)
    points."""
    out = []
    for jitter in (0.1, 0.0):
        loader = SyntheticDatasetLoader(SyntheticConfig(
            num_frames=3 if jitter else 1, beam_jitter_deg=jitter, **TINY))
        ds = loader.sequences()[0][0][0]
        out.extend(ds[i]["numpy_pc"][:, :3].astype(np.float32) for i in range(len(ds)))
    rng = np.random.default_rng(0)
    for i, pts in enumerate(out):
        extra = rng.normal(size=(N_EXTRA, 3)).astype(np.float32)
        extra *= (140.0 / np.linalg.norm(extra, axis=1))[:, None]
        extra[:10, 2] = np.abs(extra[:10, 2]) * 0.01  # in the field of view
        pts = np.concatenate([pts, extra])
        pts[rng.integers(0, len(pts), 5), 1] = np.nan
        out[i] = pts
    return out


def _projs():
    return jproj.SphericalProjection(*PROJ), tproj.SphericalProjection(*PROJ)


def _no_native(monkeypatch):
    monkeypatch.setattr(jnative, "get_lib", lambda: None)
    monkeypatch.setattr(tnative, "get_lib", lambda: None)


# ----------------------------------------------------------------------------
# Host encoders
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("fmt", ["rimg", "rimg16", "rimg8", "rimg12"])
def test_range_image_bytes_match_jax(scans, fmt, native, monkeypatch):
    if not native:
        _no_native(monkeypatch)
    elif tnative.get_lib() is None or jnative.get_lib() is None:
        pytest.fail("the native encoder does not build here")
    jp, tp = _projs()
    for pts in scans:
        if fmt == "rimg12":
            ours, ref = tproj.np_encode_rimg12(pts, tp), jproj.np_encode_rimg12(pts, jp)
        else:
            ours = tproj.np_encode_range_image(pts, tp, **RANGE_IMAGES[fmt])
            ref = jproj.np_encode_range_image(pts, jp, **RANGE_IMAGES[fmt])
        assert ours.dtype == ref.dtype == np.uint8 and ours.shape == ref.shape
        assert np.array_equal(ours, ref)
        assert np.count_nonzero(ours[:, 0]) > 1000


def test_packed_bytes_match_jax(scans):
    jp, tp = _projs()
    for pts in scans:
        finite = pts[~np.isnan(pts).any(axis=1)]
        ours, ref = tproj.np_encode_packed_upload(finite, tp), \
            jproj.np_encode_packed_upload(finite, jp)
        assert ours.dtype == ref.dtype == np.uint16 and np.array_equal(ours, ref)


def test_native_and_numpy_encoders_decode_alike(scans, monkeypatch):
    """The two rimg encoders need not agree byte for byte (float32 against
    float64 projection); they pick the same pixels but at their boundary."""
    _, tp = _projs()
    native = tproj.np_encode_range_image(scans[0], tp, planes=False)
    _no_native(monkeypatch)
    fallback = tproj.np_encode_range_image(scans[0], tp, planes=False)
    same = (native[:, :2] == fallback[:, :2]).all(axis=1).mean()
    assert same > 0.99, same


# ----------------------------------------------------------------------------
# Device decoders
# ----------------------------------------------------------------------------

def _decode_both(fmt, buf):
    jp, tp = _projs()
    with jax.enable_x64(False):
        if fmt == "rimg12":
            ref = jproj.decode_rimg12(jnp.asarray(buf), jp)
        elif fmt == "packed":
            ref = jproj.decode_packed_upload(jnp.asarray(buf), jp)
        else:
            ref = jproj.decode_range_image(jnp.asarray(buf), jp)
        ref = tuple(np.asarray(a) for a in ref)
    t = torch.from_numpy(buf)
    if fmt == "rimg12":
        ours = tproj.decode_rimg12(t, tp)
    elif fmt == "packed":
        ours = tproj.decode_packed_upload(t, tp)
    else:
        ours = tproj.decode_range_image(t, tp)
    return tuple(a.numpy() for a in ours), ref


def _encode(fmt, pts):
    _, tp = _projs()
    if fmt == "rimg12":
        return tproj.np_encode_rimg12(pts, tp)
    if fmt == "packed":
        return tproj.np_encode_packed_upload(pts[~np.isnan(pts).any(axis=1)], tp)
    return tproj.np_encode_range_image(pts, tp, **RANGE_IMAGES[fmt])


@pytest.mark.parametrize("fmt", ["rimg", "rimg16", "rimg8", "rimg12", "packed"])
def test_decoder_matches_jax(scans, fmt):
    for pts in scans:
        buf = _encode(fmt, pts)
        padded = np.zeros((buf.shape[0] + 96, buf.shape[1]), buf.dtype)
        padded[:buf.shape[0]] = buf
        (tpts, tvalid), (jpts, jvalid) = _decode_both(fmt, padded)
        assert tpts.dtype == np.float32 and tpts.shape == jpts.shape
        assert np.array_equal(tvalid, jvalid) and tvalid.sum() > 1000
        assert not tvalid[-96:].any()
        np.testing.assert_allclose(tpts, jpts, rtol=0, atol=POINT_TOL)


@pytest.mark.parametrize("fmt", ["rimg", "rimg16", "rimg8", "rimg12", "packed"])
def test_decoded_points_are_the_scan(scans, fmt):
    """Each codec's decode is the scan to its resolution: every decoded
    point lies within its bound of a point of the raw cloud.  The plane
    codecs (rimg8, rimg12) are exact only on a regular firing pattern: they
    are held on the pixel-centre frame, the others on a jittered one, each
    without the fixture's off-grid far points."""
    from scipy.spatial import cKDTree
    pts = (scans[3] if fmt in ("rimg8", "rimg12") else scans[0])[:-N_EXTRA]
    finite = pts[~np.isnan(pts).any(axis=1)]
    (dec, valid), _ = _decode_both(fmt, _encode(fmt, pts))
    dist, _ = cKDTree(finite).query(dec[valid])
    bound = {"rimg12": 0.06, "rimg": 0.2, "rimg8": 0.3}.get(fmt, 0.05)
    assert dist.max() < bound, (fmt, dist.max())


# ----------------------------------------------------------------------------
# dequant of the three maps
# ----------------------------------------------------------------------------

def _jax_dequants(jp):
    """The JAX aggregated, surfel and voxel step builders' ``dequant``
    closures (read from their steps' closure cells)."""
    from pylidar_slam_tpu.slam.odometry.aggregated_map import AggregatedLocalMapConfig
    from pylidar_slam_tpu.slam.odometry.surfel_map import SurfelRingMapConfig
    from pylidar_slam_tpu.slam.odometry.voxel_map import VoxelTableMapConfig
    common = dict(max_num_alignments=2, threshold_delta_pose=1e-4, threshold_trans=0.1,
                  threshold_rot=0.3, gn_scheme="geman_mcclure", gn_sigma=0.4,
                  upload_quantization=QUANT)
    steps = {
        "aggregated": jam.make_agg_icp_frame_step(
            proj=jp, map_cfg=AggregatedLocalMapConfig(), reassoc_every=2, **common)[0],
        "surfel": jsm.make_surfel_icp_frame_step(
            proj=jp, map_cfg=SurfelRingMapConfig(), **common)[0],
        "voxel": jvm.make_voxel_icp_frame_step(
            proj=jp, map_cfg=VoxelTableMapConfig(), **common)[0],
    }
    out = {}
    for name, step in steps.items():
        fn = getattr(step, "__wrapped__", step)
        cells = dict(zip(fn.__code__.co_freevars, fn.__closure__ or ()))
        out[name] = cells["dequant"].cell_contents
    return out


@pytest.mark.parametrize("kind", ["rimg", "rimg16", "rimg8", "rimg12", "packed", "int16",
                                  "f32"])
def test_dequant_matches_the_jax_maps(scans, kind):
    jp, tp = _projs()
    pts = scans[1]
    if kind == "int16":
        finite = pts[~np.isnan(pts).any(axis=1)]
        buf = np.zeros((len(finite) + 64, 3), np.int16)
        steps = np.round(finite / QUANT)
        steps[(np.abs(steps) > 32767).any(axis=1)] = 0.0
        buf[:len(finite)] = steps
    elif kind == "f32":
        finite = pts[~np.isnan(pts).any(axis=1)]
        buf = np.zeros((len(finite) + 64, 3), np.float32)
        buf[:len(finite)] = finite
    else:
        enc = _encode(kind, pts)
        rows = enc.shape[0] if kind == "rimg12" else enc.shape[0] + 64
        buf = np.zeros((rows, enc.shape[1]), enc.dtype)
        buf[:enc.shape[0]] = enc
    n = 4 * buf.shape[0] if kind == "rimg12" else buf.shape[0]
    mask = np.ones(n, bool)
    mask[-7:] = False
    tpts, tmask, ordered = tam.dequant_upload(torch.from_numpy(buf), torch.from_numpy(mask),
                                              tp, QUANT)
    assert ordered == kind.startswith("rimg")
    with jax.enable_x64(False):
        for name, dequant in _jax_dequants(jp).items():
            out = dequant(jnp.asarray(buf), jnp.asarray(mask))
            jpts, jmask = np.asarray(out[0]), np.asarray(out[1])
            if name == "aggregated":
                assert out[2] == ordered
            assert np.array_equal(tmask.numpy(), jmask), name
            np.testing.assert_allclose(tpts.numpy(), jpts, rtol=0, atol=POINT_TOL,
                                       err_msg=name)


# ----------------------------------------------------------------------------
# The odometry's host buffers
# ----------------------------------------------------------------------------

def _odom_pair(fmt, quant, dither, cap=8448, hw=(32, 256)):
    kw = dict(upload_format=fmt, upload_quantization=quant, upload_dither=dither,
              num_points_padded=cap, local_map={"type": "aggregated_local_map"},
              data_key="numpy_pc", batch_size=4)
    proj = (hw[0], hw[1], 3.0, -24.0)
    t = TICP(TCfg(device="cpu", **kw), projector=tproj.SphericalProjection(*proj))
    j = JICP(JCfg(**kw), projector=jproj.SphericalProjection(*proj))
    return t, j


@pytest.mark.parametrize("upload", list(UPLOADS))
def test_host_buffers_match_jax(scans, upload):
    """The odometry's host buffer per upload, frame after frame (the dither
    draws from one generator seeded 0, in frame order)."""
    fmt, quant, dither = UPLOADS[upload]
    t, j = _odom_pair(fmt, quant, dither, cap=9216 if fmt == "rimg12" else 8448)
    for pts in scans:
        ours, ref = t.encode_upload(pts), j.encode_upload(pts)
        if dither:
            # dithered frames are encoded in frame order, when processed
            assert ours is None
            ours = t._compact_host_buffer(pts)
        assert ours.dtype == ref.dtype and np.array_equal(ours, ref)
    if quant:
        assert ours.dtype == np.int16 and ours.shape[0] % 8448 == 0


def test_int16_drops_points_beyond_the_range(scans):
    t, j = _odom_pair("f32", 0.001, False)
    ours, ref = t._compact_host_buffer(scans[0]), j._compact_host_buffer(scans[0])
    assert np.array_equal(ours, ref)
    finite = scans[0][~np.isnan(scans[0]).any(axis=1)]
    far = (np.abs(np.round(finite / 0.001)) > 32767).any(axis=1)
    assert far.sum() >= 10 and not ours[:len(finite)][far].any()
    assert ours[:len(finite)][~far].any(axis=1).all()


def test_rimg12_capacity_is_asserted(scans):
    t, _ = _odom_pair("rimg12", 0.0, False, cap=8448)
    with pytest.raises(AssertionError, match="rimg12 upload needs num_points_padded == 9216"):
        t.encode_upload(scans[0])


@pytest.mark.parametrize("fmt", ["rimg", "rimg8"])
def test_range_image_capacity_is_asserted(scans, fmt):
    t, _ = _odom_pair(fmt, 0.0, False, cap=8192)
    need = 8192 + (144 if fmt == "rimg8" else 0)
    if fmt == "rimg":
        assert t.encode_upload(scans[0]).shape == (8192, 3)
    else:
        with pytest.raises(AssertionError, match=f">= {need}"):
            t.encode_upload(scans[0])


def test_packed_above_65536_pixels_goes_to_f32(scans):
    """At 64x2048 (131,072 pixels) pixel ids overflow uint16: the upload is
    the f32 cloud, as in the JAX package."""
    t, j = _odom_pair("packed", 0.0, False, cap=65536, hw=(64, 2048))
    ours, ref = t.encode_upload(scans[0]), j.encode_upload(scans[0])
    assert ours.dtype == ref.dtype == np.float32 and np.array_equal(ours, ref)
    t, j = _odom_pair("packed", 0.0, False, cap=65536, hw=(64, 1024))
    assert t.encode_upload(scans[0]).dtype == np.uint16


@pytest.mark.parametrize("upload", ["rimg12", "packed", "int16"])
def test_upload_pads_rows_by_format(scans, upload):
    """rimg12 keeps its full shape; the others are zero-padded to capacity,
    and their padding decodes invalid."""
    fmt, quant, dither = UPLOADS[upload]
    cap = 9216 if fmt == "rimg12" else 8448
    t, _ = _odom_pair(fmt, quant, dither, cap=cap)
    buf = t.encode_upload(scans[0])
    dev = t._upload(np.stack([buf, buf]))
    rows = 2304 if fmt == "rimg12" else cap
    assert dev.dtype == torch.from_numpy(buf).dtype and tuple(dev.shape) == (2, rows,
                                                                             buf.shape[1])
    assert torch.equal(dev[0, :buf.shape[0]], torch.from_numpy(buf))
    pts, mask, _ = tam.dequant_upload(dev[0], t._ones_mask(), t.projector, quant)
    assert pts.shape == (cap, 3) and mask.sum() > 1000
    if fmt != "rimg12":  # rimg12's rows past H*W/4 hold its planes
        assert not mask[buf.shape[0]:].any()


# ----------------------------------------------------------------------------
# The bench's codec rule
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("quant", ["", "0.004"])
@pytest.mark.parametrize("fmt", ["f32", "packed", "rimg", "rimg16", "rimg8", "rimg12"])
def test_bench_config_is_the_root_benchs_for_every_format(clean_env, fmt, quant):
    if quant:
        clean_env.setenv("BENCH_QUANT", quant)
    ours = bench.build_icp_config("aggregated", fmt)
    theirs = root_bench.build_icp_config("aggregated", fmt)
    for f in dataclasses.fields(ours):
        if f.name != "device":
            assert getattr(ours, f.name) == getattr(theirs, f.name), f.name
    assert ours.num_points_padded == (66560 if fmt in ("rimg8", "rimg12") else 65536)
    TICP(dataclasses.replace(ours, device="cpu"),
         projector=tproj.SphericalProjection(64, 1024, 3.0, -24.0))


def test_bench_defaults_to_rimg_on_an_irregular_loader(clean_env):
    """The root bench's codec rule: a loader that is not grid-regular (real
    sensors, jittered beams) uploads rimg; the bench runs on it."""
    loader = SyntheticDatasetLoader(SyntheticConfig(num_frames=9, beam_jitter_deg=0.1,
                                                    **TINY))
    assert not loader.grid_regular
    frames = [f["numpy_pc"] for f in bench.generate(loader.sequences()[0][0][0], 9)]
    seen = []
    init = TICP.__init__

    def spy(self, config, *args, **kwargs):
        seen.append(config.upload_format)
        init(self, config, *args, **kwargs)
    clean_env.setattr(TICP, "__init__", spy)
    clean_env.setenv("BENCH_CAP", "8192")  # the 32x256 image
    result = bench.run(bench.Settings(device="cpu", batch=4, warmup=5, repeats=1,
                                      workers=2), frames, loader, "synthetic-jittered")
    assert seen == ["rimg"]
    assert result["value"] > 0 and "probe_error" not in result["stages"], result["stages"]
    assert result["stages"]["upload_mb_per_frame"] == round(8192 * 3 / 1e6, 3)
