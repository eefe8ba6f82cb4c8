"""Pure-Python ROS1 bag (v2.0) reader + PointCloud2 decoder (port of
``pylidar_slam_tpu.dataset.rosbag_reader``).

Reads the on-disk bag format directly (record framing, chunks with none/bz2
compression, connection records) and deserializes ``sensor_msgs/PointCloud2``
messages to numpy arrays: no ROS installation is needed, and the card's
machine has none.
"""
from __future__ import annotations

import bz2
import struct
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

MAGIC = b"#ROSBAG V2.0\n"

OP_MESSAGE_DATA = 0x02
OP_BAG_HEADER = 0x03
OP_INDEX_DATA = 0x04
OP_CHUNK = 0x05
OP_CHUNK_INFO = 0x06
OP_CONNECTION = 0x07


def _parse_header(buf: bytes) -> Dict[bytes, bytes]:
    fields = {}
    offset = 0
    while offset < len(buf):
        (field_len,) = struct.unpack_from("<I", buf, offset)
        offset += 4
        field = buf[offset:offset + field_len]
        offset += field_len
        name, _, value = field.partition(b"=")
        fields[name] = value
    return fields


def _read_record(f) -> Optional[Tuple[Dict[bytes, bytes], bytes]]:
    raw = f.read(4)
    if len(raw) < 4:
        return None
    (header_len,) = struct.unpack("<I", raw)
    header = _parse_header(f.read(header_len))
    (data_len,) = struct.unpack("<I", f.read(4))
    data = f.read(data_len)
    return header, data


def _iter_records_from_bytes(buf: bytes):
    offset = 0
    while offset < len(buf):
        (header_len,) = struct.unpack_from("<I", buf, offset)
        offset += 4
        header = _parse_header(buf[offset:offset + header_len])
        offset += header_len
        (data_len,) = struct.unpack_from("<I", buf, offset)
        offset += 4
        data = buf[offset:offset + data_len]
        offset += data_len
        yield header, data


class BagReader:
    """Streams (topic, msg_type, timestamp_ns, raw_bytes) from a .bag file."""

    def __init__(self, file_path: str):
        self.file_path = Path(file_path)
        assert self.file_path.exists(), f"Bag file {file_path} does not exist"

    def messages(self, topics: Optional[List[str]] = None
                 ) -> Iterator[Tuple[str, str, int, bytes]]:
        connections: Dict[int, Tuple[str, str]] = {}
        with open(self.file_path, "rb") as f:
            magic = f.read(len(MAGIC))
            assert magic == MAGIC, f"Not a ROSBAG v2.0 file: {self.file_path}"
            while True:
                record = _read_record(f)
                if record is None:
                    return
                header, data = record
                op = header[b"op"][0]
                if op == OP_CONNECTION:
                    conn_id = struct.unpack("<I", header[b"conn"])[0]
                    conn_fields = _parse_header(data)
                    topic = conn_fields.get(b"topic", header.get(b"topic", b"")) \
                        .decode()
                    msg_type = conn_fields.get(b"type", b"").decode()
                    connections[conn_id] = (topic, msg_type)
                elif op == OP_CHUNK:
                    compression = header.get(b"compression", b"none").decode()
                    if compression == "none":
                        chunk = data
                    elif compression == "bz2":
                        chunk = bz2.decompress(data)
                    else:
                        raise NotImplementedError(
                            f"Chunk compression '{compression}' not supported")
                    for c_header, c_data in _iter_records_from_bytes(chunk):
                        c_op = c_header[b"op"][0]
                        if c_op == OP_CONNECTION:
                            conn_id = struct.unpack("<I", c_header[b"conn"])[0]
                            conn_fields = _parse_header(c_data)
                            topic = conn_fields.get(
                                b"topic", c_header.get(b"topic", b"")).decode()
                            msg_type = conn_fields.get(b"type", b"").decode()
                            connections[conn_id] = (topic, msg_type)
                        elif c_op == OP_MESSAGE_DATA:
                            conn_id = struct.unpack("<I", c_header[b"conn"])[0]
                            (time_ns,) = struct.unpack("<Q", c_header[b"time"])
                            topic, msg_type = connections.get(conn_id, ("", ""))
                            if topics is None or topic in topics:
                                yield topic, msg_type, time_ns, c_data
                elif op == OP_MESSAGE_DATA:
                    conn_id = struct.unpack("<I", header[b"conn"])[0]
                    (time_ns,) = struct.unpack("<Q", header[b"time"])
                    topic, msg_type = connections.get(conn_id, ("", ""))
                    if topics is None or topic in topics:
                        yield topic, msg_type, time_ns, data


_PC2_DATATYPES = {1: np.int8, 2: np.uint8, 3: np.int16, 4: np.uint16,
                  5: np.int32, 6: np.uint32, 7: np.float32, 8: np.float64}


def decode_pointcloud2(raw: bytes) -> Dict[str, np.ndarray]:
    """Deserializes a sensor_msgs/PointCloud2 message.

    Returns a dict with at least 'xyz' (N, 3) float32, plus every declared
    field as its own array, and 'stamp' (float seconds).
    """
    offset = 0

    def read(fmt):
        nonlocal offset
        vals = struct.unpack_from("<" + fmt, raw, offset)
        offset += struct.calcsize("<" + fmt)
        return vals

    def read_string():
        nonlocal offset
        (n,) = read("I")
        s = raw[offset:offset + n].decode(errors="replace")
        offset += n
        return s

    _seq, secs, nsecs = read("III")
    _frame_id = read_string()
    height, width = read("II")
    (num_fields,) = read("I")
    fields = []
    for _ in range(num_fields):
        name = read_string()
        f_offset, datatype, count = read("IBI")
        fields.append((name, f_offset, datatype, count))
    (is_bigendian,) = read("B")
    (point_step,) = read("I")
    (_row_step,) = read("I")
    (data_len,) = read("I")
    data = raw[offset:offset + data_len]
    offset += data_len

    n_points = height * width
    out: Dict[str, np.ndarray] = {"stamp": np.float64(secs + nsecs * 1e-9)}
    arr = np.frombuffer(data, dtype=np.uint8).reshape(n_points, point_step)
    for name, f_offset, datatype, count in fields:
        base = _PC2_DATATYPES[datatype]
        width_bytes = np.dtype(base).itemsize * count
        col = arr[:, f_offset:f_offset + width_bytes].copy().view(base)
        out[name] = col.reshape(n_points, count) if count > 1 else col.reshape(n_points)
    if all(k in out for k in ("x", "y", "z")):
        out["xyz"] = np.stack([out["x"], out["y"], out["z"]], axis=1) \
            .astype(np.float32)
    return out


# ----------------------------------------------------------------------------
# Minimal bag writer (tests / tooling)
# ----------------------------------------------------------------------------

def _encode_header(fields: Dict[bytes, bytes]) -> bytes:
    parts = []
    for name, value in fields.items():
        field = name + b"=" + value
        parts.append(struct.pack("<I", len(field)) + field)
    return b"".join(parts)


def _record(fields: Dict[bytes, bytes], data: bytes) -> bytes:
    header = _encode_header(fields)
    return struct.pack("<I", len(header)) + header + \
        struct.pack("<I", len(data)) + data


def encode_pointcloud2(points: np.ndarray, stamp_s: float = 0.0,
                       frame_id: str = "lidar") -> bytes:
    """Serializes an (N, 3) float32 cloud as a PointCloud2 message."""
    points = np.asarray(points, np.float32)
    n = points.shape[0]
    fid = frame_id.encode()
    secs = int(stamp_s)
    nsecs = int((stamp_s - secs) * 1e9)
    buf = struct.pack("<III", 0, secs, nsecs)
    buf += struct.pack("<I", len(fid)) + fid
    buf += struct.pack("<II", 1, n)  # height=1, width=n
    buf += struct.pack("<I", 3)
    for i, name in enumerate((b"x", b"y", b"z")):
        buf += struct.pack("<I", len(name)) + name
        buf += struct.pack("<IBI", 4 * i, 7, 1)
    buf += struct.pack("<B", 0)  # little endian
    buf += struct.pack("<II", 12, 12 * n)
    data = points.tobytes()
    buf += struct.pack("<I", len(data)) + data
    buf += struct.pack("<B", 1)  # is_dense
    return buf


def write_simple_bag(file_path: str, topic: str,
                     messages: List[Tuple[int, bytes]],
                     msg_type: str = "sensor_msgs/PointCloud2"):
    """Writes an uncompressed single-connection bag (for tests)."""
    write_multi_bag(file_path, [(topic, msg_type, messages)])


def write_multi_bag(file_path: str,
                    connections: List[Tuple[str, str, List[Tuple[int, bytes]]]]):
    """Writes an uncompressed multi-connection bag (for tests).

    ``connections`` is a list of (topic, msg_type, [(time_ns, raw), ...]);
    messages are written interleaved in global time order.
    """
    with open(file_path, "wb") as f:
        f.write(MAGIC)
        f.write(_record({b"op": bytes([OP_BAG_HEADER]),
                         b"index_pos": struct.pack("<Q", 0),
                         b"conn_count": struct.pack("<I", len(connections)),
                         b"chunk_count": struct.pack("<I", 1)},
                        b"\x20" * 4096))
        chunk_records = b""
        all_messages = []
        for conn_id, (topic, msg_type, messages) in enumerate(connections):
            chunk_records += _record(
                {b"op": bytes([OP_CONNECTION]),
                 b"conn": struct.pack("<I", conn_id),
                 b"topic": topic.encode()},
                _encode_header({b"topic": topic.encode(),
                                b"type": msg_type.encode(),
                                b"md5sum": b"", b"message_definition": b""}))
            all_messages += [(time_ns, conn_id, raw)
                             for time_ns, raw in messages]
        for time_ns, conn_id, raw in sorted(all_messages,
                                            key=lambda m: (m[0], m[1])):
            chunk_records += _record(
                {b"op": bytes([OP_MESSAGE_DATA]),
                 b"conn": struct.pack("<I", conn_id),
                 b"time": struct.pack("<Q", time_ns)}, raw)
        f.write(_record({b"op": bytes([OP_CHUNK]), b"compression": b"none",
                         b"size": struct.pack("<I", len(chunk_records))},
                        chunk_records))
