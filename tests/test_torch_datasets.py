"""The port's dataset layer (``pylidar_slam_tpu_torch.dataset``) against the
JAX package's, on sequences fabricated on disk in every loader's format by
``scripts/fabricate_datasets.py`` from the seeded synthetic world.

Both packages' loaders are numpy host code reading the same files, so they
are held bit for bit: the same keys, dtypes, shapes and bytes in every item,
the same sequence names, projector and ground truth.  The port's CLI on a
KITTI micro-sequence is held to ``run.py`` by the tolerances of
``tests/test_torch_slam.py::test_cli_run_matches_jax``.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pandas as pd
import pytest

from pylidar_slam_tpu import dataset as jdataset
from pylidar_slam_tpu.dataset import configuration as jconfiguration
from pylidar_slam_tpu.dataset import kitti_360_dataset as jk360
from pylidar_slam_tpu.dataset import pcd_io as jpcd
from pylidar_slam_tpu.dataset import ply_io as jply
from pylidar_slam_tpu.dataset import rosbag_reader as jbag
from pylidar_slam_tpu.dataset import urban_loco_dataset as jul
from pylidar_slam_tpu.utils import native as jnative

from pylidar_slam_tpu_torch import dataset as tdataset
from pylidar_slam_tpu_torch.dataset import configuration as tconfiguration
from pylidar_slam_tpu_torch.dataset import kitti_360_dataset as tk360
from pylidar_slam_tpu_torch.dataset import pcd_io as tpcd
from pylidar_slam_tpu_torch.dataset import ply_io as tply
from pylidar_slam_tpu_torch.dataset import rosbag_reader as tbag
from pylidar_slam_tpu_torch.dataset import urban_loco_dataset as tul
from pylidar_slam_tpu_torch.slam.odometry_runner import SLAMRunner
from pylidar_slam_tpu_torch.utils import native as tnative

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))
import fabricate_datasets as fab  # noqa: E402

# A small world: 16 x 256 rays, ~2,000 points a scan.
SMALL = dict(lidar_height=16, lidar_width=256, num_frames=6, num_walls=12, num_pillars=6)
N = SMALL["num_frames"]
UL_SEQ = "HK-Data20190426-1"
CA_SEQ = "CABayBridge"
# The CLI runs are held as tests/test_torch_slam.py holds the synthetic
# CLI run (the odometry's rounding drifts apart over frames, ROADMAP §C5):
# poses over frames 0-6 within 1e-3 m, the ATE within 2e-3 m.
TIGHT_M = 1e-3
TIGHT_FRAMES = 7
ATE_M = 2e-3


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Every format, written once for the module from one small sequence."""
    base = tmp_path_factory.mktemp("datasets")
    scans, times, poses = fab.synthetic_frames(SMALL)
    fab.write_kitti(base / "kitti", "00", scans, poses, nan_rows=[(1, 3), (2, 0)])
    raw = base / "kitti_raw" / "2011_10_03" / "2011_10_03_drive_0027_sync" / \
        "velodyne_points" / "data"
    raw.mkdir(parents=True)
    for i, pts in enumerate(scans[:3]):
        scan = np.concatenate([pts, np.full((len(pts), 1), 0.1, np.float32)], axis=1)
        if i == 1:
            np.savetxt(raw / f"{i:010}.txt", scan)
        else:
            scan.tofile(raw / f"{i:010}.bin")
    fab.write_ct_icp(base / "ct_icp", "seq_a", scans, times, poses,
                     binary=[True, False, True, True, False, True])
    fab.write_kitti_360(base / "kitti_360", 3, scans, poses)
    fab.write_nclt(base / "nclt", "2012-01-08", scans, poses)
    fab.write_ford(base / "ford", "dataset-1", scans, poses)
    fab.write_nhcd(base / "nhcd", "01_short_experiment", scans, poses)
    bags = base / "bags"
    bags.mkdir()
    tbag.write_simple_bag(str(bags / "drive.bag"), "/velodyne_points",
                          fab.pointcloud_messages(scans, times))
    fab.compress_bag(bags / "drive.bag", bags / "drive_bz2.bag")
    ul = base / "urban_loco"
    fab.write_urban_loco(ul, tul.SEQNAME_TO_FILENAME[UL_SEQ], "/velodyne_points_0", scans,
                         times, poses)
    fab.write_urban_loco(ul, tul.SEQNAME_TO_FILENAME[CA_SEQ], "/velodyne_points", scans,
                         times, poses)
    return {"base": base, "scans": scans, "times": times, "poses": poses}


def _configs(base):
    """(dataset config, sequence to score, items to compare) per loader."""
    kitti = {"dataset": "kitti", "kitti_sequence_dir": str(base / "kitti"),
             "train_sequences": ["00"], "eval_sequences": ["00"],
             "test_sequences": ["00", "04"]}
    return {
        "kitti": (kitti, "00", N),
        "kitti_raw": (dict(kitti, kitti_raw_dir=str(base / "kitti_raw")), "00", 3),
        "ct_icp": ({"dataset": "ct_icp", "root_dir": str(base / "ct_icp")}, "seq_a", N),
        "kitti_360": ({"dataset": "kitti_360", "root_dir": str(base / "kitti_360"),
                       "train_sequences": [3], "test_sequences": [3], "eval_sequences": []},
                      "3", N),
        "nclt": ({"dataset": "nclt", "root_dir": str(base / "nclt"),
                  "train_sequences": ["2012-01-08"], "test_sequences": []}, "2012-01-08", N),
        "ford_campus": ({"dataset": "ford_campus", "root_dir": str(base / "ford"),
                         "train_sequences": ["dataset-1"], "test_sequences": ["dataset-1"]},
                        "dataset-1", N),
        "nhcd": ({"dataset": "nhcd", "root_dir": str(base / "nhcd"),
                  "test_sequences": []}, "01_short_experiment", N),
        "rosbag": ({"dataset": "rosbag", "file_path": str(base / "bags" / "drive.bag"),
                    "main_topic": "/velodyne_points"}, "drive", N),
        "rosbag_bz2_frame_size_2": ({"dataset": "rosbag", "main_topic": "/velodyne_points",
                                     "file_path": str(base / "bags" / "drive_bz2.bag"),
                                     "frame_size": 2}, "drive_bz2", N // 2),
        "urban_loco": ({"dataset": "urban_loco", "root_dir": str(base / "urban_loco"),
                        "train_sequences": [UL_SEQ, CA_SEQ]}, UL_SEQ, 3),
    }


def assert_same_item(ours: dict, ref: dict, where: str):
    """Same keys; each value of the same type, dtype, shape and bytes."""
    assert sorted(ours) == sorted(ref), where
    for key, b in ref.items():
        a = ours[key]
        assert type(a) is type(b), (where, key, type(a), type(b))
        a, b = np.asarray(a), np.asarray(b)
        assert (a.dtype, a.shape) == (b.dtype, b.shape), (where, key)
        assert a.tobytes() == b.tobytes(), (where, key)


def _load_pair(cfg):
    return tdataset.DATASET.load(dict(cfg)), jdataset.DATASET.load(dict(cfg))


@pytest.mark.parametrize("name", list(_configs(Path("/")).keys()))
def test_loader_items_match_jax(data, name):
    """Each loader's sequences, projector, items and ground truth equal the
    JAX package's on the same files, bit for bit."""
    cfg, seq_name, n = _configs(data["base"])[name]
    ours, ref = _load_pair(cfg)
    assert type(ours).__name__ == type(ref).__name__
    assert tuple(ours.projector()) == tuple(ref.projector())
    assert ours.max_num_workers() == ref.max_num_workers()
    assert ours.grid_regular == ref.grid_regular is False
    if name == "urban_loco":
        # the ground truth the loader generates from the bags' INSPVAX fixes
        written = []
        for loader in (ref, ours):
            loader.generate_ground_truth([UL_SEQ, CA_SEQ])
            written.append([(Path(cfg["root_dir"]) / f"{seq}.poses.txt").read_bytes()
                            for seq in (UL_SEQ, CA_SEQ)])
        assert written[0] == written[1]
    o_seqs, r_seqs = ours.sequences(), ref.sequences()
    for (o_sets, o_names), (r_sets, r_names) in zip(o_seqs[:3], r_seqs[:3]):
        assert list(o_names) == list(r_names)
        assert (o_sets is None) == (r_sets is None)
        if o_sets is not None:
            assert [type(s).__name__ for s in o_sets] == [type(s).__name__ for s in r_sets]
    ds, rds = o_seqs[0][0][0], r_seqs[0][0][0]
    if name.startswith(("kitti", "ct_icp", "nclt", "ford", "nhcd")):
        assert len(ds) == len(rds)
    for i in range(n):
        assert_same_item(ds[i], rds[i], f"{name}[{i}]")
    gt, rgt = ours.get_ground_truth(seq_name), ref.get_ground_truth(seq_name)
    if rgt is None:
        assert gt is None and name.startswith("rosbag")
    else:
        assert gt.dtype == rgt.dtype and gt.tobytes() == rgt.tobytes()


def test_urban_loco_gt_cli_matches_the_jax_script(data, tmp_path, monkeypatch):
    """``python -m pylidar_slam_tpu_torch.dataset.generate_urban_loco_gt``
    and ``scripts/generate_urban_loco_gt.py`` over copies of the fabricated
    bags write the same ground truth, byte for byte."""
    import runpy
    import shutil
    written = []
    for name in ("jax", "port"):
        root = tmp_path / name
        shutil.copytree(data["base"] / "urban_loco", root)
        for seq in (UL_SEQ, CA_SEQ):
            (root / f"{seq}.poses.txt").unlink(missing_ok=True)
        args = ["--root_dir", str(root), "--sequences", UL_SEQ, CA_SEQ]
        if name == "jax":
            script = ROOT / "scripts" / "generate_urban_loco_gt.py"
            monkeypatch.setattr(sys, "argv", [str(script), *args])
            runpy.run_path(str(script), run_name="__main__")
        else:
            proc = subprocess.run(
                [sys.executable, "-m", "pylidar_slam_tpu_torch.dataset.generate_urban_loco_gt",
                 *args], cwd=ROOT, capture_output=True, text=True, timeout=300,
                env=dict(os.environ, OMP_NUM_THREADS="1"))
            assert proc.returncode == 0, proc.stderr[-3000:]
        written.append([(root / f"{seq}.poses.txt").read_bytes() for seq in (UL_SEQ, CA_SEQ)])
    assert all(written[0]) and written[0] == written[1]


def test_kitti_numpy_reader_matches_jax(data, monkeypatch):
    """Without the native library both packages read KITTI scans through
    numpy's ``correct_scan``, which keeps the NaN rows: bit for bit."""
    cfg, _, _ = _configs(data["base"])["kitti"]
    monkeypatch.setattr(tnative, "load_kitti_scan", lambda *a: None)
    monkeypatch.setattr(jnative, "load_kitti_scan", lambda *a: None)
    ours, ref = _load_pair(cfg)
    ds, rds = ours.sequences()[0][0][0], ref.sequences()[0][0][0]
    for i in range(N):
        item = ds[i]
        assert_same_item(item, rds[i], f"numpy kitti[{i}]")
        assert len(item["numpy_pc"]) == len(data["scans"][i])
    assert np.isnan(ds[1]["numpy_pc"][3]).any()


def test_native_kitti_reader_matches_jax(data):
    """The port's binding of ``native/pointcloud_native.cpp::load_kitti_scan``
    gives the JAX package's bytes (same source, flags and host), drops the
    NaN rows, counts its reads, and agrees with numpy's ``correct_scan`` to
    1e-4 m (the bar of tests/test_native.py: the one pass rotates in float32
    with float32 sin and cos, numpy in float64 with a normalized axis)."""
    from pylidar_slam_tpu_torch.dataset.kitti_dataset import correct_scan
    if tnative.get_lib() is None or jnative.get_lib() is None:
        pytest.skip("no C++ compiler: the native library cannot be built")
    velodyne = data["base"] / "kitti" / "sequences" / "00" / "velodyne"
    before = tnative.load_kitti_scan.reads
    for i in range(3):
        path = str(velodyne / f"{i:06}.bin")
        (out, n), (rout, rn) = tnative.load_kitti_scan(path, 4096), jnative.load_kitti_scan(
            path, 4096)
        assert n == rn and out.tobytes() == rout.tobytes()
        raw = np.fromfile(path, np.float32).reshape(-1, 4)
        kept = ~np.isnan(raw[:, :3]).any(axis=1)
        assert n == int(kept.sum()) == len(data["scans"][i]) - (i > 0)
        np.testing.assert_allclose(out[:n], correct_scan(raw[kept]), atol=1e-4)
        assert not out[n:].any()
    assert tnative.load_kitti_scan.reads == before + 3
    assert tnative.load_kitti_scan(str(velodyne / "missing.bin"), 16) is None
    # capacity caps the rows read
    out, n = tnative.load_kitti_scan(str(velodyne / "000000.bin"), 100)
    assert n == 100 and out.shape == (100, 3)


def test_kitti_conjugates_the_camera_frame_ground_truth(data):
    """inv(Tr) @ P @ Tr brings the camera-frame poses back to the LiDAR
    trajectory the scans were raycast along: to 1e-12, the float64 rounding
    of two products with an inverse, since the fabricated ``Tr`` is exact in
    the float32 the loader parses calib.txt into."""
    cfg, _, _ = _configs(data["base"])["kitti"]
    ds = tdataset.DATASET.load(cfg).sequences()[0][0][0]
    got = np.stack([ds[i]["absolute_pose_gt"] for i in range(N)])
    np.testing.assert_allclose(got, data["poses"], atol=1e-12)


def test_ply_io_matches_jax(data, tmp_path):
    """PLY frames (binary and ASCII, with and without a timestamp, and a
    vertex + face header) read the same in both packages."""
    pts = data["scans"][0][:300]
    cases = {"binary_ts": (pts, data["times"][0][:300], True), "ascii_ts": (
        pts, data["times"][0][:300], False), "binary": (pts, None, True)}
    for name, (p, t, binary) in cases.items():
        path = tmp_path / f"{name}.ply"
        fab.write_ply(path, p, t, binary)
        fields, ref = tply.read_ply_fields(str(path)), jply.read_ply_fields(str(path))
        assert list(fields) == list(ref)
        for k in ref:
            assert fields[k].dtype == ref[k].dtype and fields[k].tobytes() == ref[k].tobytes()
        (a, ta), (b, tb) = tply.ply_to_pointcloud(fields), jply.ply_to_pointcloud(ref)
        assert a.tobytes() == b.tobytes() and np.array_equal(a, p)
        assert (ta is None) == (tb is None) == (t is None)
        if t is not None:
            assert ta.tobytes() == tb.tobytes()
    mesh = tmp_path / "mesh.ply"
    header = "\n".join(["ply", "format binary_little_endian 1.0", "comment a mesh",
                        "element vertex 300", "property float x", "property float y",
                        "property float z", "element face 2",
                        "property list uchar int vertex_indices", "end_header", ""])
    mesh.write_bytes(header.encode() + pts.tobytes() + bytes([3]) + bytes(12) * 2)
    assert tply.read_ply_fields(str(mesh))["x"].tobytes() == \
        jply.read_ply_fields(str(mesh))["x"].tobytes()
    bad = tmp_path / "bad.ply"
    bad.write_bytes(b"not a ply\n")
    for module in (tply, jply):
        with pytest.raises(ValueError, match="not a PLY"):
            module.read_ply_fields(str(bad))


def test_pcd_io_matches_jax(data, tmp_path):
    """The writers write the same bytes, and each reader reads both."""
    pts = data["scans"][1][:500]
    for binary in (True, False):
        ours, ref = tmp_path / f"t{binary}.pcd", tmp_path / f"j{binary}.pcd"
        tpcd.write_pcd(str(ours), pts, binary=binary)
        jpcd.write_pcd(str(ref), pts, binary=binary)
        assert ours.read_bytes() == ref.read_bytes()
        a, b = tpcd.read_pcd(str(ours)), jpcd.read_pcd(str(ours))
        assert a.dtype == b.dtype == np.float32 and a.tobytes() == b.tobytes()
        if binary:
            assert np.array_equal(a, pts)
    compressed = tmp_path / "c.pcd"
    compressed.write_bytes(ours.read_bytes().replace(b"DATA ascii", b"DATA binary_compressed"))
    for module in (tpcd, jpcd):
        with pytest.raises(NotImplementedError, match="binary_compressed"):
            module.read_pcd(str(compressed))


def test_rosbag_reader_matches_jax(data, tmp_path):
    """Encoder and writer bytes, and the messages and decoded clouds of an
    uncompressed and a bz2 bag, equal the JAX package's."""
    msgs = fab.pointcloud_messages(data["scans"][:3], data["times"][:3])
    assert msgs[0][1] == jbag.encode_pointcloud2(
        data["scans"][0][fab.sweep_order(data["times"][0])], stamp_s=10.0)
    ours, ref = tmp_path / "t.bag", tmp_path / "j.bag"
    tbag.write_multi_bag(str(ours), [("/a", "sensor_msgs/PointCloud2", msgs),
                                     ("/b", "std_msgs/String", [(10_050_000_000, b"xy")])])
    jbag.write_multi_bag(str(ref), [("/a", "sensor_msgs/PointCloud2", msgs),
                                    ("/b", "std_msgs/String", [(10_050_000_000, b"xy")])])
    assert ours.read_bytes() == ref.read_bytes()
    for path in (ours, fab.compress_bag(ours, tmp_path / "bz2.bag")):
        for topics in (None, ["/a"]):
            got = list(tbag.BagReader(str(path)).messages(topics))
            assert got == list(jbag.BagReader(str(path)).messages(topics))
            assert len(got) == (4 if topics is None else 3)
        for _, msg_type, _, raw in tbag.BagReader(str(path)).messages(["/a"]):
            d, rd = tbag.decode_pointcloud2(raw), jbag.decode_pointcloud2(raw)
            assert list(d) == list(rd) and all(d[k].tobytes() == rd[k].tobytes() for k in d)
    assert b"compression=bz2" in (tmp_path / "bz2.bag").read_bytes()


def test_kitti_360_timestamps_match_pandas(tmp_path):
    """numpy's datetime64[ns] parse of the ISO instants gives pandas' float64
    nanoseconds (the JAX package parses them with pandas)."""
    path = tmp_path / "timestamps.txt"
    path.write_text("2013-05-28 08:46:02.802247461\n2013-05-28 08:46:02.905819464\n"
                    "2013-05-28 23:59:59.999999999\n2013-05-29 00:00:00.000000001\n"
                    "2013-06-05 10:01:13.5\n")
    ours, ref = tk360.read_timestamps(str(path)), jk360.read_timestamps(str(path))
    assert ours.dtype == ref.dtype == np.float64 and ours.tobytes() == ref.tobytes()
    expected = pd.to_datetime(pd.Series(path.read_text().split("\n")[:-1])).astype("int64")
    assert np.array_equal(ours, expected.to_numpy(np.float64))


def test_urban_loco_helpers_match_jax():
    """Ring and packet ids, the geodesy, the GPS pose and INSPVAX decoding."""
    rng = np.random.default_rng(4)
    bins = rng.integers(0, 40, 500)
    unique = np.unique(bins)
    assert np.array_equal(tul.compute_ring_ids(bins, unique), jul.compute_ring_ids(bins, unique))
    rings = tul.compute_ring_ids(bins, unique)
    assert np.array_equal(tul.packet_ids(rings), jul.packet_ids(rings))
    origin, llu = np.array([114.2, 22.3, 4.0]), np.array([114.2004, 22.3002, 5.5])
    assert tul.llu_to_ecef(llu).tobytes() == jul.llu_to_ecef(llu).tobytes()
    assert tul.ecef_to_enu(origin, tul.llu_to_ecef(llu)).tobytes() == \
        jul.ecef_to_enu(origin, jul.llu_to_ecef(llu)).tobytes()
    for init_enu in (None, np.array([1.0, 2.0, 0.5])):
        (p, e), (rp, re) = (m.nwu_pose_from_gps(llu, np.array([33.0, 1.5, -0.5]), origin,
                                                init_enu) for m in (tul, jul))
        assert p.tobytes() == rp.tobytes() and e.tobytes() == re.tobytes()
    raw = fab.encode_inspvax(1234.25, 114.2, 22.3, 5.0, 33.0, 1.5, -0.5)
    (s, l, y), (rs, rl, ry) = tul.decode_inspvax(raw), jul.decode_inspvax(raw)
    assert s == rs and l.tobytes() == rl.tobytes() and y.tobytes() == ry.tobytes()
    assert tul.decode_inspvax(raw[:40]) is None is jul.decode_inspvax(raw[:40])


def test_window_dataset_matches_jax(data):
    cfg, _, _ = _configs(data["base"])["ct_icp"]
    ours, ref = _load_pair(cfg)
    ds, rds = ours.sequences()[0][0][0], ref.sequences()[0][0][0]
    for start, length in ((0, None), (2, 3), (N - 1, 1)):
        w = tconfiguration.WindowDataset(ds, start, length)
        rw = jconfiguration.WindowDataset(rds, start, length)
        assert len(w) == len(rw)
        for i in range(len(w)):
            assert_same_item(w[i], rw[i], f"window {start}+{i}")


class _Recorder:
    """A stand-in for the SLAM that keeps the frames the runner feeds it."""
    backend = None
    loop_closure = None

    def __init__(self):
        self.frames = []

    def host_prepare(self, data_dict):
        pass

    def process_next_frame(self, data_dict):
        self.frames.append(data_dict)

    def finish(self):
        pass

    def get_relative_poses(self):
        return np.tile(np.eye(4), (len(self.frames), 1, 1))


@pytest.mark.parametrize("name", ["rosbag", "rosbag_bz2_frame_size_2", "urban_loco"])
def test_sequential_loaders_through_the_runner(data, name, tmp_path):
    """The runner asked for 8 prefetch threads reads the sequential-access
    loaders on one (``max_num_workers() == 1``) and feeds the JAX package's
    frames in order; 8 threads on such a dataset would fail its in-order
    check."""
    cfg, _, _ = _configs(data["base"])[name]
    runner = SLAMRunner({"dataset": dict(cfg), "slam": {}, "device": "cpu", "num_workers": 8,
                         "save_results": False, "log_dir": str(tmp_path)})
    recorders = []

    def recorder():
        recorders.append(_Recorder())
        return recorders[-1]
    runner.load_slam_algorithm = recorder
    runner.run_odometry()
    ref = jdataset.DATASET.load(dict(cfg)).sequences()[0][0]
    assert len(recorders) == len(ref)
    for rec, rds in zip(recorders, ref):
        assert len(rec.frames) == len(rds) > 0
        for i, frame in enumerate(rec.frames):
            assert_same_item(frame, rds[i], f"{name} runner frame {i}")


def test_kitti_cli_matches_run_py(tmp_path, monkeypatch):
    """The KITTI micro-sequence of tests/test_kitti_micro.py through
    ``python -m pylidar_slam_tpu_torch.run dataset=kitti ... device=cpu``
    and through ``run.py``: the ground truth conjugated as that test holds
    it (1e-9: its ``Tr`` is read back through float32), the poses over the
    first frames within 1e-3 m and the ATE within 2e-3 m (TIGHT_M, ATE_M)."""
    sys.path.insert(0, str(ROOT / "tests"))
    from test_kitti_micro import N_FRAMES, _fabricate
    root = tmp_path / "kitti"
    root.mkdir()
    gt = _fabricate(root)
    monkeypatch.setenv("KITTI_ODOM_ROOT", str(root))
    argv = ["dataset=kitti", 'dataset.train_sequences=["00"]',
            "slam/odometry/local_map=aggregated", "slam.odometry.num_points_padded=32768",
            "slam.odometry.max_num_alignments=8"]
    proc = subprocess.run(
        [sys.executable, "-m", "pylidar_slam_tpu_torch.run", *argv, "device=cpu",
         f"log_dir={tmp_path / 'torch'}"], cwd=ROOT, capture_output=True, text=True,
        timeout=600, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "on cpu" in proc.stderr
    sys.path.insert(0, str(ROOT))
    import run as jrun
    with jax.enable_x64(False):
        jrun.main(argv + [f"log_dir={tmp_path / 'jax'}"])

    import yaml
    metrics = yaml.safe_load((tmp_path / "torch" / "metrics.yaml").read_text())
    ref_metrics = yaml.safe_load((tmp_path / "jax" / "metrics.yaml").read_text())
    assert sorted(metrics) == sorted(ref_metrics) == ["00", "AVG"]
    assert abs(metrics["00"]["ATE"] - ref_metrics["00"]["ATE"]) < ATE_M
    for name in ("00.poses.txt", "00_gt.poses.txt"):
        ours = pd.read_csv(tmp_path / "torch" / name, sep=",").values.reshape(-1, 3, 4)
        ref = pd.read_csv(tmp_path / "jax" / name, sep=",").values.reshape(-1, 3, 4)
        assert ours.shape == ref.shape == (N_FRAMES, 3, 4)
        np.testing.assert_allclose(ours[:TIGHT_FRAMES], ref[:TIGHT_FRAMES], atol=TIGHT_M)
    ds = tdataset.DATASET.load({"dataset": "kitti", "kitti_sequence_dir": str(root),
                                "train_sequences": ["00"]}).sequences()[0][0][0]
    got = np.stack([ds[k]["absolute_pose_gt"] for k in range(N_FRAMES)])
    np.testing.assert_allclose(np.linalg.inv(got[0]) @ got, np.linalg.inv(gt[0]) @ gt,
                               atol=1e-9)
