"""The port's voxel-table map against the JAX package's, on the CPU, with
seeded numpy inputs and the JAX side in float32 (``jax.enable_x64(False)``).

Tolerances:
- every ``voxel_table`` function: slots, ``won``, ``meta`` and ``key`` (as
  uint32) identical; gathered floats and squared distances bit for bit;
  ``table_reanchor``'s transformed points 1e-6 (the transform's rounding),
  its slots identical on points off the voxel faces;
- ``voxel_normal_distribution``: 1e-5;
- one step from the same map state: pose 2e-5 m, the same iterations,
  matches and insert flag (with and without a re-anchor);
- frames 0-6 of a jittered sequence: 1e-3 m / 1e-4 rad, as every map
  (tests/test_torch_odometry.py gives the reasons);
- vertex-map inputs: frames 0-3 at the surfel map's k-NN-normal bar
  (2.5e-3 m / 1e-3 rad), and (3, H, W) and tensor inputs equal to
  (H, W, 3) bit for bit;
- batch 1 against batch 4 in the port: identical poses;
- ``profile_configs()["voxel"]`` equal to ``bench.build_icp_config("voxel",
  "rimg8")``.
"""
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pylidar_slam_tpu.ops import projection as jproj
from pylidar_slam_tpu.ops import voxel as jvox
from pylidar_slam_tpu.ops import voxel_table as jvt
from pylidar_slam_tpu.slam.odometry import voxel_map as jvm
from pylidar_slam_tpu.slam.odometry.icp_odometry import (
    ICPFrameToModel as JICP, ICPFrameToModelConfig as JConfig)

from pylidar_slam_tpu_torch.dataset.synthetic import (
    SyntheticConfig as TCfg, SyntheticDatasetLoader as TLoader)
from pylidar_slam_tpu_torch.eval import acceptance as tacc
from pylidar_slam_tpu_torch.ops import voxel as tvox
from pylidar_slam_tpu_torch.ops import voxel_table as tvt
from pylidar_slam_tpu_torch.slam.odometry import voxel_map as tvm
from pylidar_slam_tpu_torch.slam.odometry.icp_odometry import (
    ICPFrameToModel as TICP, ICPFrameToModelConfig as TConfig)

from test_torch_odometry import (DRIFT, _assert_poses_close, _capture_diags,
                                 _one_torch_thread, _pose_errors)  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
# The map keeps one surfel per 0.4 m voxel and fits normals over the
# surfels within 0.4 m, so a 32x256 scan leaves it too few neighbours to
# track; the sequence runs at the sensor's 64x1024, as few frames.
H, W, N = 64, 1024, 7
SEQ = dict(tacc.SEQ_KW, lidar_height=H, lidar_width=W, num_frames=N,
           beam_jitter_deg=0.1)
SLOTS, TARGETS = 16384, 2048  # the table-function tests' table
VOX, GATE, K_LIVE = 0.4, 0.4, 30


def _config(**over):
    """profile_configs()["voxel"] (262,144 slots, 8,192 targets, rimg8)."""
    t = tacc.profile_configs()["voxel"]
    kw = {f.name: getattr(t, f.name) for f in dataclasses.fields(t) if f.name != "device"}
    kw.update(over)
    return TConfig(device="cpu", **kw), JConfig(**kw)


@pytest.fixture(scope="module")
def loader():
    return TLoader(TCfg(**SEQ))


@pytest.fixture(scope="module")
def frames(loader):
    ds = loader.sequences()[0][0][0]
    return [ds[i] for i in range(N)]


def _u32(x):
    return np.asarray(x).astype(np.int64) & 0xFFFFFFFF


def _jtable(table):
    return {k: np.asarray(v) for k, v in table._asdict().items()}


def _ttable(arrays):
    return tvm.voxel_state_from_numpy(
        {"table": arrays, "anchor_t_last": np.eye(4, dtype=np.float32),
         "frame": np.array(0, np.int32)}, "cpu").table


def _assert_tables_equal(t, j):
    assert np.array_equal(t.points.numpy(), j["points"])
    assert np.array_equal(t.normals.numpy(), j["normals"])
    assert np.array_equal(t.meta.numpy(), j["meta"])
    assert np.array_equal(_u32(t.key.numpy()), _u32(j["key"]))


def _cloud(rng, n, extent=30.0):
    return rng.uniform(-extent, extent, (n, 3)).astype(np.float32)


def test_hashes_match_jax():
    rng = np.random.default_rng(0)
    coords = rng.integers(-5000, 5000, (4096, 3)).astype(np.int32)
    salt = np.array(123457, np.int32)
    with jax.enable_x64(False):
        plain = _u32(jvt._voxel_hash(jnp.asarray(coords)))
        salted = _u32(jvt._voxel_hash(jnp.asarray(coords), jnp.asarray(salt)))
        mixed = _u32(jvt._mix(jnp.asarray(coords[:, 0].astype(np.uint32))))
        offs = np.asarray(jvt._probe_offsets(GATE, VOX))
    c = torch.from_numpy(coords)
    assert np.array_equal(tvt._voxel_hash(c).numpy(), plain)
    assert np.array_equal(tvt._voxel_hash(c, torch.tensor(salt)).numpy(), salted)
    assert np.array_equal(tvt._mix(torch.from_numpy(
        coords[:, 0].astype(np.uint32).astype(np.int64))).numpy(), mixed)
    assert np.array_equal(tvt._probe_offsets(GATE, VOX, torch.device("cpu")).numpy(), offs)
    assert offs.shape == (27, 3)


@pytest.mark.parametrize("n,n_out", [(65536, 8192), (5000, 1024)])
def test_scatter_select_matches_jax(n, n_out):
    """65,536 points pack 16 index bits and 14 priority bits."""
    rng = np.random.default_rng(1)
    pts = _cloud(rng, n)
    valid = rng.random(n) < 0.9
    with jax.enable_x64(False):
        jp, ji, jv = jvt.scatter_select(jnp.asarray(pts), jnp.asarray(valid), VOX, n_out,
                                        salt=jnp.asarray(7, jnp.int32))
    tp, ti, tv = tvt.scatter_select(torch.from_numpy(pts), torch.from_numpy(valid), VOX,
                                    n_out, salt=torch.tensor(7, dtype=torch.int32))
    assert np.array_equal(tv.numpy(), np.asarray(jv)) and np.asarray(jv).mean() > 0.5
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    assert np.array_equal(tp.numpy(), np.asarray(jp))


@pytest.fixture(scope="module")
def tables():
    """A JAX table after two inserts (frame 0, then frame 40: the first
    frame's residents are stale) with normals committed; the port's copy."""
    rng = np.random.default_rng(2)
    with jax.enable_x64(False):
        table = jvt.init_table(SLOTS)
        for frame in (0, 40):
            pts = _cloud(rng, 6000, 12.0)
            table, won, slot = jvt.table_insert(table, jnp.asarray(pts),
                                                jnp.asarray(rng.random(6000) < 0.95),
                                                jnp.asarray(frame, jnp.int32), K_LIVE, VOX)
            nrm = rng.normal(size=(6000, 3)).astype(np.float32)
            table = jvt.table_set_normals(table, won, slot, jnp.asarray(nrm))
        arrays = _jtable(table)
    return arrays, _ttable(arrays)


def test_table_insert_and_set_normals_match_jax(tables):
    arrays, ttable = tables
    rng = np.random.default_rng(3)
    pts = np.concatenate([_cloud(rng, 5000, 12.0), _cloud(rng, 100, 12.0)[:50].repeat(2, 0)])
    valid = rng.random(len(pts)) < 0.95
    nrm = rng.normal(size=(len(pts), 3)).astype(np.float32)
    frame = np.array(45, np.int32)
    with jax.enable_x64(False):
        jt, jwon, jslot = jvt.table_insert(jvt.VoxelTable(**{
            k: jnp.asarray(v) for k, v in arrays.items()}), jnp.asarray(pts),
            jnp.asarray(valid), jnp.asarray(frame), K_LIVE, VOX)
        jt2 = jvt.table_set_normals(jt, jwon, jslot, jnp.asarray(nrm))
    tt, twon, tslot = tvt.table_insert(ttable, torch.from_numpy(pts), torch.from_numpy(valid),
                                       torch.tensor(frame), K_LIVE, VOX)
    tt2 = tvt.table_set_normals(tt, twon, tslot, torch.from_numpy(nrm))
    assert np.array_equal(twon.numpy(), np.asarray(jwon))
    assert 0.05 < np.asarray(jwon).mean() < 0.95  # live residents kept, stale replaced
    assert np.array_equal(tslot.numpy(), np.asarray(jslot))
    _assert_tables_equal(tt, _jtable(jt))
    _assert_tables_equal(tt2, _jtable(jt2))


def test_table_nn_and_knn_match_jax(tables):
    arrays, ttable = tables
    rng = np.random.default_rng(4)
    live = arrays["meta"] == 40
    q = (arrays["points"][live][:3000] + rng.normal(0, 0.15, (3000, 3))).astype(np.float32)
    q = np.concatenate([q, _cloud(rng, 500, 12.0)])  # some misses
    frame = np.array(45, np.int32)
    with jax.enable_x64(False):
        jtab = jvt.VoxelTable(**{k: jnp.asarray(v) for k, v in arrays.items()})
        js, jd = jvt.table_nn(jtab, jnp.asarray(q), jnp.asarray(frame), K_LIVE, VOX, GATE)
        jks, jkd = jvt.table_knn(jtab, jnp.asarray(q), jnp.asarray(frame), K_LIVE, VOX, GATE, 10)
    f = torch.tensor(frame)
    ts, td = tvt.table_nn(ttable, torch.from_numpy(q), f, K_LIVE, VOX, GATE)
    tks, tkd = tvt.table_knn(ttable, torch.from_numpy(q), f, K_LIVE, VOX, GATE, 10)
    assert np.array_equal(ts.numpy(), np.asarray(js))
    assert np.array_equal(td.numpy(), np.asarray(jd))
    assert 0.3 < np.isfinite(np.asarray(jd)).mean() < 1.0
    assert np.array_equal(tks.numpy(), np.asarray(jks))
    assert np.array_equal(tkd.numpy(), np.asarray(jkd))
    assert np.isinf(np.asarray(jkd)).any() and (np.isfinite(np.asarray(jkd)).sum(1) > 1).any()


def test_table_reanchor_matches_jax():
    """A 262,144-slot table: 18 index bits, 13 priority bits."""
    rng = np.random.default_rng(5)
    n_slots = 262144
    with jax.enable_x64(False):
        table = jvt.init_table(n_slots)
        pts = _cloud(rng, 60000, 40.0)
        table, won, slot = jvt.table_insert(table, jnp.asarray(pts),
                                            jnp.ones(60000, bool), jnp.asarray(3, jnp.int32),
                                            K_LIVE, VOX)
        table = jvt.table_set_normals(table, won, slot, jnp.asarray(
            rng.normal(size=(60000, 3)).astype(np.float32)))
        arrays = _jtable(table)
        c, s = np.cos(0.3), np.sin(0.3)
        mat = np.array([[c, -s, 0, 12.5], [s, c, 0, -3.25], [0, 0, 1, 0.5], [0, 0, 0, 1]],
                       np.float32)
        # jitted, as in the step: the op-by-op JAX matmul rounds otherwise
        jout = _jtable(jax.jit(jvt.table_reanchor, static_argnums=2)(
            table, jnp.asarray(mat), VOX))
    tout = tvt.table_reanchor(_ttable(arrays), torch.from_numpy(mat), VOX)
    moved = arrays["points"] @ mat[:3, :3].T.astype(np.float64) + mat[:3, 3]
    alive = arrays["meta"] >= 0
    assert alive.sum() > 40000
    # the points off the voxel faces keep their slots
    face = np.abs(moved / VOX - np.round(moved / VOX)).min(1) < 1e-4
    t_keys, j_keys = _u32(tout.key.numpy()), _u32(jout["key"])
    assert np.array_equal(tout.meta.numpy() >= 0, jout["meta"] >= 0) or face[alive].any()
    same = (t_keys == j_keys) & (tout.meta.numpy() == jout["meta"])
    assert same.mean() > 1 - 1e-4
    np.testing.assert_allclose(tout.points.numpy()[same], jout["points"][same],
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(tout.normals.numpy()[same], jout["normals"][same],
                               rtol=0, atol=1e-6)


def test_voxel_normal_distribution_matches_jax():
    rng = np.random.default_rng(6)
    pts = rng.uniform(-2, 2, (3000, 3)).astype(np.float32)
    mask = rng.random(3000) < 0.9
    with jax.enable_x64(False):
        ref = jvox.voxel_normal_distribution(jnp.asarray(pts), 0.5, mask=jnp.asarray(mask),
                                             capacity=2048)
        ref_all = jvox.voxel_normal_distribution(jnp.asarray(pts), 0.5)
    got = tvox.voxel_normal_distribution(torch.from_numpy(pts), 0.5,
                                         mask=torch.from_numpy(mask), capacity=2048)
    got_all = tvox.voxel_normal_distribution(torch.from_numpy(pts), 0.5)
    for g, r in ((got, ref), (got_all, ref_all)):
        assert np.array_equal(g.sizes.numpy(), np.asarray(r.sizes))
        assert np.array_equal(g.point_voxel_ids.numpy(), np.asarray(r.point_voxel_ids))
        np.testing.assert_allclose(g.means.numpy(), np.asarray(r.means), rtol=0, atol=1e-5)
        np.testing.assert_allclose(g.covariances.numpy(), np.asarray(r.covariances),
                                   rtol=0, atol=1e-5)
    assert (np.asarray(ref.sizes) > 1).sum() > 50


def test_voxel_state_roundtrip():
    rng = np.random.default_rng(7)
    tab = {"points": rng.normal(size=(8, 3)).astype(np.float32),
           "normals": rng.normal(size=(8, 3)).astype(np.float32),
           "meta": rng.integers(-1, 9, 8).astype(np.int32),
           "key": rng.integers(0, 2 ** 32, 8, dtype=np.uint64).astype(np.uint32)}
    state = tvm.voxel_state_from_numpy({"table": tab, "anchor_t_last": np.eye(4, dtype=np.float32),
                                        "frame": np.array(4, np.int32)}, "cpu")
    assert np.array_equal(_u32(state.table.key.numpy()), _u32(tab["key"]))
    assert state.table.meta.dtype == torch.int32 and state.frame.item() == 4


def _upload(frame, odom):
    """A frame's rimg8 upload, padded to capacity (the buffer the odometry
    sends to the device)."""
    buf = odom.encode_upload(np.asarray(frame["numpy_pc"]))
    out = np.zeros((odom.config.num_points_padded, 2), np.uint8)
    out[:len(buf)] = buf
    return out


@pytest.mark.parametrize("reanchor_dist", [50.0, 0.5])
def test_step_from_the_same_state(frames, loader, reanchor_dist):
    """first_frame on the JAX side, then one step of both from that state
    (carried across with voxel_state_from_numpy); the ground truth's motion
    as the prior.  reanchor_dist 0.5 m re-anchors the table in the step."""
    tcfg, jcfg = _config()
    mc = dict(tcfg.local_map, reanchor_dist=reanchor_dist)
    proj = loader.projector()
    kw = dict(max_num_alignments=8, threshold_delta_pose=1e-4, threshold_trans=0.1,
              threshold_rot=0.3, gn_scheme="geman_mcclure", gn_sigma=0.4,
              reassoc_every=8, reassoc_motion_m=0.2)
    jstep, jfirst, _ = jvm.make_voxel_icp_frame_step(
        jproj.SphericalProjection(*proj), jvm.VoxelTableMapConfig(**mc), **kw)
    tstep, _, _ = tvm.make_voxel_icp_frame_step(proj, tvm.VoxelTableMapConfig(**mc), **kw)
    todom = TICP(tcfg, projector=proj)
    u0, u1 = _upload(frames[0], todom), _upload(frames[1], todom)
    ones = np.ones(len(u0), bool)
    eye = np.eye(4, dtype=np.float32)
    prior = loader.get_ground_truth("synth_00")[1].astype(np.float32)
    with jax.enable_x64(False):
        state = jfirst(jvm.init_voxel_map(jvm.VoxelTableMapConfig(**mc)), jnp.asarray(u0),
                       jnp.asarray(ones))
        tstate = tvm.voxel_state_from_numpy(
            {"table": _jtable(state.table), "anchor_t_last": np.asarray(state.anchor_t_last),
             "frame": np.asarray(state.frame)}, "cpu")
        jout = jstep(state, jnp.asarray(eye), jnp.asarray(u1), jnp.asarray(ones),
                     jnp.asarray(prior))
    tout = tstep(tstate, torch.from_numpy(eye), torch.from_numpy(u1), torch.from_numpy(ones),
                 torch.from_numpy(prior))
    np.testing.assert_allclose(tout[2].numpy(), np.asarray(jout[2]), rtol=0, atol=2e-5)
    np.testing.assert_allclose(tout[3].numpy(), np.asarray(jout[3]), rtol=0, atol=2e-5)
    loss, it, matches, inserted = tout[4]
    np.testing.assert_allclose(float(loss), float(jout[4][0]), rtol=1e-3)
    assert (it.item(), matches.item(), inserted.item()) == \
        tuple(np.asarray(x).item() for x in jout[4][1:])
    # few matches: one surfel per 0.4 m voxel leaves most first-frame fits
    # without the three neighbours a normal needs
    assert it.item() > 1 and matches.item() > 200 and inserted.item()
    js = jout[0]
    assert tout[0].frame.item() == int(js.frame) == 2
    np.testing.assert_allclose(tout[0].anchor_t_last.numpy(), np.asarray(js.anchor_t_last),
                               rtol=0, atol=2e-5)
    same = _u32(tout[0].table.key.numpy()) == _u32(js.table.key)
    assert same.mean() > 0.999
    if reanchor_dist < 1.0:  # re-anchored: the anchor is the new frame
        assert np.array_equal(np.asarray(js.anchor_t_last), eye)


def _run(odom, frames):
    last = np.eye(4, dtype=np.float32)
    for f in frames:
        d = dict(f, init_rpose=last)
        odom.process_next_frame(d)
        last = d.get("odometry_pose", last)
    odom.finish()
    return odom.get_relative_poses()


@pytest.mark.parametrize("upload_format", ["f32", "rimg8"])
def test_frames_0_6_match_jax(frames, loader, monkeypatch, upload_format):
    """ICPFrameToModel with the voxel map at batch 1 over the jittered
    frames (the EI bootstrap on frame 1).

    f32 uploads are held to frames 0-6's bar.  The rimg8 decode goes
    through XLA's and torch's cos and sin, which differ by an ulp on ~11% of
    a frame's points; the map's k-NN normals (a closed-form eigen-solve,
    ill-conditioned when two eigenvalues meet) turn that into 3.8e-3 m by
    frame 5 here, while the JAX program moves by 2.1e-3 m under a 1e-7
    change of its f32 inputs.  So rimg8 is held by DRIFT, with the same
    insert decisions."""
    over = dict(batch_size=1)
    if upload_format == "f32":
        over.update(upload_format="f32", num_points_padded=H * W)
    tcfg, jcfg = _config(**over)
    t = TICP(tcfg, projector=loader.projector())
    j = JICP(jcfg, projector=jproj.SphericalProjection(*loader.projector()))
    j.init()
    tlog = _capture_diags(t, lambda x: x.numpy(), monkeypatch)
    jlog = _capture_diags(j, np.asarray, monkeypatch)
    tp = _run(t, frames)
    with jax.enable_x64(False):
        jp = _run(j, frames)
    assert [bool(d[3]) for d in tlog] == [bool(d[3]) for d in jlog]
    assert len(tlog) == N - 1
    if upload_format == "f32":
        _assert_poses_close(tp, jp, "voxel map, f32 uploads")
    else:
        trans, rot = _pose_errors(tp, jp)
        print(f"\nvoxel map, rimg8: max per-frame gap {trans.max():.3e} m, {rot.max():.3e} rad")
        assert trans.max() < DRIFT["trans"] and rot.max() < DRIFT["rot"]


def test_vertex_map_inputs(frames, loader):
    """Frames 0-3 as (H, W, 3) vertex maps through the port and the JAX
    package, and as (3, H, W) and tensor inputs through the port."""
    from pylidar_slam_tpu_torch.ops import projection as tproj
    proj = loader.projector()

    def vmap(f):
        pc = torch.from_numpy(np.asarray(f["numpy_pc"], np.float32)[:, :3])
        return tproj.build_vertex_map(pc, proj).numpy()

    def run(odom, to_input):
        return _run(odom, [dict(f, numpy_pc=to_input(f)) for f in frames[:4]])

    tcfg, jcfg = _config(batch_size=1)
    with jax.enable_x64(False):
        j = JICP(jcfg, projector=jproj.SphericalProjection(*proj))
        j.init()
        jp = run(j, vmap)
    tp = run(TICP(tcfg, projector=proj), vmap)
    chw = run(TICP(tcfg, projector=proj), lambda f: np.transpose(vmap(f), (2, 0, 1)))
    as_tensor = run(TICP(tcfg, projector=proj), lambda f: torch.from_numpy(vmap(f)))
    assert np.array_equal(chw, tp) and np.array_equal(as_tensor, tp)
    # the k-NN normals' bar of the surfel map (tests/test_torch_surfel.py):
    # 1.04e-3 m here, while the JAX program moves 2.1e-3 m under a 1e-7
    # change of its f32 inputs (test_frames_0_6_match_jax)
    trans, rot = _pose_errors(tp, jp)
    print(f"\nvoxel map, vertex-map input: max per-frame gap {trans.max():.3e} m, "
          f"{rot.max():.3e} rad")
    assert trans.max() < 2.5e-3 and rot.max() < 1e-3
    assert np.linalg.norm(tp[1:, :3, 3], axis=1).min() > 0.5


def test_batch_1_and_4_give_the_same_poses(frames, loader):
    """At batch 1 each frame's prior is the previous pose, as the batched
    step chains it on the device."""
    tcfg, _ = _config(batch_size=1)
    one = _run(TICP(tcfg, projector=loader.projector()), frames)
    four = _run(TICP(dataclasses.replace(tcfg, batch_size=4),
                     projector=loader.projector()), frames)
    assert np.array_equal(four, one)
    assert np.linalg.norm(one[1:, :3, 3], axis=1).min() > 0.5


def test_profile_is_the_bench_config(monkeypatch):
    for var in ("BENCH_ITERS", "BENCH_REASSOC", "BENCH_REASSOC_MOTION", "BENCH_SCHEME",
                "BENCH_SIGMA", "BENCH_CAP", "BENCH_BATCH", "BENCH_QUANT",
                "BENCH_MODEL_NORMALS"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.syspath_prepend(str(ROOT))
    import bench
    t = dataclasses.asdict(tacc.profile_configs()["voxel"])
    j = dataclasses.asdict(bench.build_icp_config("voxel", "rimg8"))
    assert t.pop("device") == "cuda" and j.pop("device") == "tpu"
    assert t == j
    assert j["batch_size"] == 12 and j["num_points_padded"] == 66560
    lm = dataclasses.asdict(tvm.VoxelTableMapConfig(**t["local_map"]))
    assert lm == dataclasses.asdict(jvm.VoxelTableMapConfig(**j["local_map"]))
