"""Fabricates on-disk sequences in the formats the dataset loaders read, from
the seeded synthetic world (``pylidar_slam_tpu_torch.dataset.synthetic``,
numpy), so that the loaders, the JAX package's and the port's, can be run
without a real dataset.

The computation is numpy only: the same seed writes the same bytes on any
machine whose numpy rounds ``sin``, ``cos`` and ``arctan2`` alike
(``digest`` hashes a tree to check that).

Two full sequences feed the card's ``datasets`` phase and the JAX package's
bars on the CPU (``scripts/jax_cpu_dataset_bars.py``):

- ``kitti_sequence``: ``eval/acceptance.SEQ_KW``'s 140 frames raycast at 64 x
  2,048 rays (up to 131,072 points a scan, KITTI's HDL-64E density) with
  0.05 degrees of beam jitter, written as KITTI odometry sequence ``00``:
  float32 ``.bin`` scans with the inverse of the loader's 0.205 degree
  correction applied, ``calib.txt`` with a non-trivial ``Tr``, and the
  ground truth in the camera frame (``poses/00.txt``);
- ``ct_icp_sequence``: ``ROLLING_SHUTTER_KW``'s 100 frames, with the same
  beam jitter, as binary PLY frames with a per-point ``timestamp`` (the
  column's capture time) and ``trajectory.txt``.

The ``write_*`` functions write any frames in each format; the tests use
them at small sizes.

    python scripts/fabricate_datasets.py DIR    # writes both under DIR
"""
from __future__ import annotations

import bz2
import hashlib
import os
import shutil
import struct
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from pylidar_slam_tpu_torch.dataset import kitti_360_dataset, nhcd_dataset  # noqa: E402
from pylidar_slam_tpu_torch.dataset.pcd_io import write_pcd  # noqa: E402
from pylidar_slam_tpu_torch.dataset.rosbag_reader import (  # noqa: E402
    MAGIC, OP_CHUNK, encode_pointcloud2, write_multi_bag)
from pylidar_slam_tpu_torch.dataset.synthetic import (SyntheticConfig,  # noqa: E402
                                                      SyntheticSequence)
from pylidar_slam_tpu_torch.eval import acceptance  # noqa: E402
from pylidar_slam_tpu_torch.ops import se3  # noqa: E402

# KITTI's HDL-64E density: 64 x 2,048 rays, read with the KITTI config's
# 64 x 1,024 projector.
KITTI_KW = dict(acceptance.SEQ_KW, lidar_width=2048, beam_jitter_deg=0.05)
# Beams jittered as a real sensor's are: rays fired at the exact pixel
# centers put float32 uploads on the projection's .5 rounding edge, where
# XLA, torch's CPU and CUDA round apart (ROADMAP.md §C2).
CT_ICP_KW = dict(acceptance.ROLLING_SHUTTER_KW, beam_jitter_deg=0.05)
KITTI_SEQUENCE = "00"
CT_ICP_SEQUENCE = "rolling_shutter"
# Camera-from-LiDAR extrinsic of a KITTI-like calib.txt, its entries exact
# in float32 (the loader parses calib.txt as float32), so the conjugation
# of the camera-frame poses gives the LiDAR poses back to float64 rounding.
TR = np.array([[0.0, -1.0, 0.0, 0.0625],
               [0.0, 0.0, -1.0, -0.0703125],
               [1.0, 0.0, 0.0, -0.265625],
               [0.0, 0.0, 0.0, 1.0]])
KITTI_THETA = 0.205 * np.pi / 180.0


def synthetic_frames(kw: dict, frames=None):
    """The synthetic sequence of `kw`: its scans (float32, sensor frame), the
    capture time of each point as a fraction of the sweep (its column over
    the width) and the absolute ground-truth poses (float64)."""
    seq = SyntheticSequence(SyntheticConfig(**kw), "synth_00", seed=int(kw.get("seed", 0)))
    idx = list(range(len(seq)) if frames is None else frames)
    # frames are independent (each seeds its own noise), and the raycaster's
    # numpy passes release the interpreter lock
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        scans = [d["numpy_pc"] for d in pool.map(seq.__getitem__, idx)]
    width = int(kw["lidar_width"])
    # beams fire at the column centers, theta = -(2 (c + 0.5) / W - 1) pi
    cols = [np.clip(np.floor((1.0 - np.arctan2(s[:, 1], s[:, 0]) / np.pi) * width / 2.0),
                    0, width - 1) for s in scans]
    return scans, [c / width for c in cols], seq.poses_gt[idx]


def undo_kitti_correction(points: np.ndarray) -> np.ndarray:
    """The inverse of the KITTI loader's 0.205 degree correction: each point
    rotated by -0.205 degrees about the axis p x ez, so that the loader's
    correction gives the geometry back."""
    c, s = np.cos(-KITTI_THETA), np.sin(-KITTI_THETA)
    p = points.astype(np.float64)
    x, y, z = p[:, 0], p[:, 1], p[:, 2]
    nxy = np.maximum(np.sqrt(x * x + y * y), 1e-12)
    ax, ay = y / nxy, -x / nxy
    adotp = ax * x + ay * y
    return np.stack([c * x + s * ay * z + (1 - c) * adotp * ax,
                     c * y - s * ax * z + (1 - c) * adotp * ay,
                     c * z + s * (ax * y - ay * x)], axis=1).astype(np.float32)


def _rows12(poses) -> str:
    return "".join(" ".join(repr(float(v)) for v in p[:3, :4].ravel()) + "\n" for p in poses)


def write_kitti(root, sequence: str, scans, poses, nan_rows=()) -> Path:
    """A KITTI odometry sequence under `root`: ``sequences/<seq>/velodyne``
    (float32 x, y, z, reflectance, pre-distorted by the inverse of the
    0.205 degree correction), ``calib.txt`` with ``Tr`` and
    ``poses/<seq>.txt`` in the camera frame.  `nan_rows` are (frame, row)
    pairs whose x is set to NaN, as real scans hold."""
    root = Path(root)
    velodyne = root / "sequences" / sequence / "velodyne"
    velodyne.mkdir(parents=True, exist_ok=True)
    (root / "poses").mkdir(exist_ok=True)
    for i, pts in enumerate(scans):
        scan = np.concatenate([undo_kitti_correction(pts),
                               np.full((len(pts), 1), 0.5, np.float32)], axis=1)
        for frame, row in nan_rows:
            if frame == i:
                scan[row, 0] = np.nan
        scan.tofile(velodyne / f"{i:06}.bin")
    (root / "sequences" / sequence / "calib.txt").write_text(
        "P0: " + " ".join(["1.0"] * 12) + "\nTr: "
        + " ".join(repr(float(v)) for v in TR[:3, :4].ravel()) + "\n")
    (root / "poses" / f"{sequence}.txt").write_text(
        _rows12(TR @ p @ np.linalg.inv(TR) for p in poses))
    return root


def write_ply(path, points, timestamps=None, binary=True):
    """A CT-ICP PLY frame: float x, y, z and an optional double timestamp."""
    n = len(points)
    header = ["ply", "format binary_little_endian 1.0" if binary else "format ascii 1.0",
              f"element vertex {n}", "property float x", "property float y",
              "property float z"]
    if timestamps is not None:
        header.append("property double timestamp")
    header.append("end_header")
    fields = [("xyz", "<f4", 3)] + ([("t", "<f8")] if timestamps is not None else [])
    rec = np.zeros(n, dtype=fields)
    rec["xyz"] = points
    if timestamps is not None:
        rec["t"] = timestamps
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        if binary:
            f.write(rec.tobytes())
        else:
            for r in rec:
                row = " ".join(repr(float(v)) for v in r["xyz"])
                if timestamps is not None:
                    row += " " + repr(float(r["t"]))
                f.write((row + "\n").encode())


def write_ct_icp(root, sequence: str, scans, times, poses, period_s=0.1, binary=True) -> Path:
    """A CT-ICP sequence ``<root>/<seq>/frames/frame_%05d.ply`` with each
    point's capture time in seconds (frame i spans [i, i + 1) periods) and
    ``trajectory.txt``.  `binary` may be a list, one flag per frame."""
    frames_dir = Path(root) / sequence / "frames"
    frames_dir.mkdir(parents=True, exist_ok=True)
    for i, (pts, t) in enumerate(zip(scans, times)):
        flag = binary[i] if isinstance(binary, (list, tuple)) else binary
        write_ply(frames_dir / f"frame_{i:05}.ply", pts, (i + np.asarray(t)) * period_s, flag)
    (Path(root) / sequence / "trajectory.txt").write_text(_rows12(poses))
    return Path(root)


def write_kitti_360(root, drive_id: int, scans, poses, start_ns=1369730762802247461,
                    period_ns=103_500_000) -> Path:
    """A KITTI-360 drive: ``data_3d_raw/<drive>/velodyne_points`` (float32
    x, y, z, reflectance scans and one ISO instant a line in
    ``timestamps.txt``) and ``data_poses/<drive>/poses.txt`` (frame index +
    12 values), the poses given as the camera poses whose conjugation gives
    `poses` back."""
    folder = kitti_360_dataset.drive_foldername(drive_id)
    velodyne = Path(root) / "data_3d_raw" / folder / "velodyne_points"
    (velodyne / "data").mkdir(parents=True, exist_ok=True)
    for i, pts in enumerate(scans):
        np.concatenate([pts, np.full((len(pts), 1), 0.25, np.float32)],
                       axis=1).astype(np.float32).tofile(velodyne / "data" / f"{i:010}.bin")
    instants = np.datetime64(start_ns, "ns") + np.arange(len(scans)) * np.timedelta64(period_ns,
                                                                                      "ns")
    (velodyne / "timestamps.txt").write_text(
        "".join(str(t).replace("T", " ") + "\n" for t in instants))
    calib = kitti_360_dataset.CAM0_TO_POSE @ kitti_360_dataset.VELO_TO_CAM0
    gt_dir = Path(root) / "data_poses" / folder
    gt_dir.mkdir(parents=True, exist_ok=True)
    (gt_dir / "poses.txt").write_text("".join(
        f"{i} " + " ".join(repr(float(v)) for v in (p @ np.linalg.inv(calib))[:3, :4].ravel())
        + "\n" for i, p in enumerate(poses)))
    return Path(root)


def _euler_zyx(rot: np.ndarray) -> np.ndarray:
    """(roll, pitch, heading) of R = Rz(h) Ry(p) Rx(r)."""
    return np.array([np.arctan2(rot[2, 1], rot[2, 2]), -np.arcsin(np.clip(rot[2, 0], -1, 1)),
                     np.arctan2(rot[1, 0], rot[0, 0])])


def write_nclt(root, sequence: str, scans, poses, start_us=1326030975000000,
               period_us=100_000) -> Path:
    """An NCLT session: ``velodyne_sync/<utime>.bin`` (x, y, z as int16
    steps of 5 mm from -100 m, y and z flipped, then intensity and laser
    bytes) and ``groundtruth_<seq>.csv`` (utime, x, y, z, roll, pitch,
    heading, in the frame the loader flips back), with a NaN row."""
    velodyne = Path(root) / sequence / "velodyne_sync"
    velodyne.mkdir(parents=True, exist_ok=True)
    stamps = start_us + period_us * np.arange(len(scans))
    for stamp, pts in zip(stamps, scans):
        q = np.round((pts * np.array([1.0, -1.0, -1.0]) + 100.0) / 0.005)
        raw = np.zeros((len(pts), 4), np.int16)
        raw[:, :3] = np.clip(q, -32768, 32767)
        raw[:, 3] = 7
        raw.tofile(velodyne / f"{stamp}.bin")
    flip = np.diag([1.0, -1.0, -1.0, 1.0])
    rows = [[float(stamp), *(flip @ p @ flip)[:3, 3], *_euler_zyx((flip @ p @ flip)[:3, :3])]
            for stamp, p in zip(stamps, poses)]
    rows.insert(1, [float(stamps[0]) + 1.0] + [np.nan] * 6)
    (Path(root) / sequence / f"groundtruth_{sequence}.csv").write_text(
        "".join(",".join(repr(float(v)) for v in r) + "\n" for r in rows))
    return Path(root)


def write_ford(root, sequence: str, scans, poses) -> Path:
    """A Ford Campus sequence: ``SCANS/Scan%04d.mat`` holding a ``SCAN``
    struct with ``XYZ`` (3, N) in the sensor frame and ``X_wv`` (the six
    pose parameters), and ``poses_gt.npy``."""
    from scipy.io import savemat
    scans_dir = Path(root) / sequence / "SCANS"
    scans_dir.mkdir(parents=True, exist_ok=True)
    to_sensor = np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    for i, (pts, p) in enumerate(zip(scans, poses)):
        x_wv = np.concatenate([p[:3, 3], _euler_zyx(p[:3, :3])])[:, None]
        savemat(scans_dir / f"Scan{i + 1:04}.mat",
                {"SCAN": {"XYZ": (pts.astype(np.float64) @ to_sensor.T).T, "X_wv": x_wv}})
    np.save(Path(root) / sequence / "poses_gt.npy", np.asarray(poses))
    return Path(root)


def write_nhcd(root, sequence: str, scans, poses, start_s=1583836591,
               period_ns=100_000_000) -> Path:
    """An NHCD experiment: ``raw_format/ouster_scan/cloud_<s>_<ns>.pcd``
    (binary PCD) and ``ground_truth/registered_poses.csv`` (sec, nsec, x,
    y, z, qx, qy, qz, qw), the poses at the clouds' instants."""
    base = Path(root) / sequence
    (base / "raw_format" / "ouster_scan").mkdir(parents=True, exist_ok=True)
    (base / "ground_truth").mkdir(parents=True, exist_ok=True)
    t_cl = np.eye(4)
    t_cl[:3, :3] = nhcd_dataset._quat_xyzw_to_mat(np.array([0.0, 0.0, 0.924, 0.383]))
    t_cl[:3, 3] = [-0.084, -0.025, 0.050]
    rows = []
    for i, (pts, p) in enumerate(zip(scans, poses)):
        ns = i * period_ns
        secs, nsecs = start_s + ns // 1_000_000_000, ns % 1_000_000_000
        write_pcd(str(base / "raw_format" / "ouster_scan" / f"cloud_{secs}_{nsecs:09}.pcd"), pts,
                  binary=(i % 2 == 0))
        # the loader applies the lidar-to-camera extrinsic to what it reads
        q = p @ np.linalg.inv(t_cl)
        w, x, y, z = se3.np_mat_to_quat(q[:3, :3])
        rows.append([secs, nsecs, *q[:3, 3], x, y, z, w])
    (base / "ground_truth" / "registered_poses.csv").write_text(
        "".join(",".join(repr(float(v)) for v in r) + "\n" for r in rows))
    return Path(root)


def sweep_order(times) -> np.ndarray:
    """The points' order as a spinning sensor sends them: column by column."""
    return np.argsort(np.asarray(times), kind="stable")


def pointcloud_messages(scans, times, start_s=10.0, period_s=0.1) -> list:
    """(time_ns, PointCloud2 bytes) per scan, points in sweep order."""
    return [(int(round((start_s + i * period_s) * 1e9)),
             encode_pointcloud2(pts[sweep_order(t)], stamp_s=start_s + i * period_s))
            for i, (pts, t) in enumerate(zip(scans, times))]


def encode_inspvax(stamp_s, lon, lat, alt, azimuth, pitch, roll) -> bytes:
    """A novatel_msgs/INSPVAX message (the UrbanLoco loader's layout)."""
    secs = int(stamp_s)
    nsecs = int(round((stamp_s - secs) * 1e9))
    out = struct.pack("<III", 0, secs, nsecs) + struct.pack("<I", 0)
    out += struct.pack("<I", 7) + b"INSPVAX" + struct.pack("<I", 4) + b"COM1"
    out += struct.pack("<IfI", 0, 0.0, 2000) + struct.pack("<d", 0.0)
    out += struct.pack("<III", 0, 0, 0) + struct.pack("<ii", 3, 56)
    out += struct.pack("<ddd", lat, lon, alt) + struct.pack("<f", 0.0)
    out += struct.pack("<ddd", 0.0, 0.0, 0.0) + struct.pack("<ddd", roll, pitch, azimuth)
    return out


def write_urban_loco(root, filename: str, topic: str, scans, times, poses,
                     start_s=10.0, period_s=0.1, origin=(114.2, 22.3, 4.0)) -> Path:
    """An UrbanLoco bag: the scans on `topic` and INSPVAX fixes at twice the
    scan rate along the ground-truth track (east and north of `origin`)."""
    msgs = pointcloud_messages(scans, times, start_s, period_s)
    gps = []
    lat_m = 111_320.0
    lon_m = lat_m * np.cos(np.radians(origin[1]))
    for k in range(2 * len(scans) + 2):
        t = start_s - period_s + k * period_s / 2
        i = int(np.clip(k // 2, 0, len(poses) - 1))
        east, north = poses[i][0, 3], poses[i][1, 3]
        heading = np.degrees(np.arctan2(poses[i][1, 0], poses[i][0, 0]))
        gps.append((int(round(t * 1e9)), encode_inspvax(
            t, origin[0] + east / lon_m, origin[1] + north / lat_m, origin[2], 90.0 - heading,
            0.0, 0.0)))
    Path(root).mkdir(parents=True, exist_ok=True)
    write_multi_bag(str(Path(root) / filename), [
        (topic, "sensor_msgs/PointCloud2", msgs),
        ("/novatel_data/inspvax", "novatel_msgs/INSPVAX", gps)])
    return Path(root) / filename


def compress_bag(src, dst) -> Path:
    """A copy of a bag written by ``write_multi_bag`` with its chunk
    compressed by bz2, as ``rosbag record --bz2`` writes them."""
    buf = Path(src).read_bytes()
    out, offset = bytearray(buf[:len(MAGIC)]), len(MAGIC)
    while offset < len(buf):
        (header_len,) = struct.unpack_from("<I", buf, offset)
        header = buf[offset + 4:offset + 4 + header_len]
        (data_len,) = struct.unpack_from("<I", buf, offset + 4 + header_len)
        data = buf[offset + 8 + header_len:offset + 8 + header_len + data_len]
        offset += 8 + header_len + data_len
        if b"op=" + bytes([OP_CHUNK]) in header:
            header = (struct.pack("<I", len(b"compression=bz2")) + b"compression=bz2"
                      + _without_field(header, b"compression"))
            data = bz2.compress(data)
        out += struct.pack("<I", len(header)) + header + struct.pack("<I", len(data)) + data
    Path(dst).write_bytes(bytes(out))
    return Path(dst)


def _without_field(header: bytes, name: bytes) -> bytes:
    parts, offset = [], 0
    while offset < len(header):
        (n,) = struct.unpack_from("<I", header, offset)
        field = header[offset + 4:offset + 4 + n]
        if not field.startswith(name + b"="):
            parts.append(header[offset:offset + 4 + n])
        offset += 4 + n
    return b"".join(parts)


def digest(root) -> str:
    """sha256 over every file under `root`, by relative path and bytes."""
    h = hashlib.sha256()
    for path in sorted(p for p in Path(root).rglob("*") if p.is_file()):
        h.update(str(path.relative_to(root)).encode())
        h.update(path.read_bytes())
    return h.hexdigest()


def _cached(root: Path, write) -> Path:
    """`write(tmp)` into a sibling directory renamed to `root` once it is
    complete, so a run cut short leaves no half-written sequence."""
    if (root / "DONE").exists():
        return root
    tmp = root.with_name(root.name + ".tmp")
    shutil.rmtree(tmp, ignore_errors=True)
    shutil.rmtree(root, ignore_errors=True)
    write(tmp)
    (tmp / "DONE").write_text("")
    tmp.rename(root)
    return root


def _key(kw: dict) -> str:
    """A directory name for the frames of `kw`: its seed and a hash of all
    its settings."""
    settings = hashlib.sha256(repr(sorted(kw.items())).encode()).hexdigest()[:8]
    return f"seed{kw.get('seed', 0)}_{settings}"


def kitti_sequence(base) -> Path:
    """KITTI_KW's 140 frames as KITTI sequence ``00`` under
    ``<base>/kitti_<key>`` (written once, then reused)."""
    root = Path(base) / f"kitti_{_key(KITTI_KW)}"

    def write(tmp):
        scans, _, poses = synthetic_frames(KITTI_KW)
        write_kitti(tmp, KITTI_SEQUENCE, scans, poses)
    return _cached(root, write)


def ct_icp_sequence(base) -> Path:
    """CT_ICP_KW's 100 rolling-shutter frames as CT-ICP PLY frames under
    ``<base>/ct_icp_<key>/rolling_shutter`` (written once)."""
    root = Path(base) / f"ct_icp_{_key(CT_ICP_KW)}"

    def write(tmp):
        scans, times, poses = synthetic_frames(CT_ICP_KW)
        write_ct_icp(tmp, CT_ICP_SEQUENCE, scans, times, poses)
    return _cached(root, write)


if __name__ == "__main__":
    out = Path(sys.argv[1] if len(sys.argv) > 1 else REPO / "build" / "chip_datasets")
    for name, make in (("kitti", kitti_sequence), ("ct_icp", ct_icp_sequence)):
        root = make(out)
        print(f"{name}: {root} sha256 {digest(root)}")
