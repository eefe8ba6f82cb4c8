"""General PLY property parser (port of ``pylidar_slam_tpu.dataset.ply_io``,
pure Python/numpy).

Covers the frame files of CT-ICP-published datasets (binary_little_endian
vertex elements with x/y/z + per-point timestamp properties), ASCII files and
multi-element headers (vertex + face, as mesh tools write them).
"""
from __future__ import annotations

from typing import Dict

import numpy as np

_PLY_TYPES = {
    "char": np.int8, "int8": np.int8,
    "uchar": np.uint8, "uint8": np.uint8,
    "short": np.int16, "int16": np.int16,
    "ushort": np.uint16, "uint16": np.uint16,
    "int": np.int32, "int32": np.int32,
    "uint": np.uint32, "uint32": np.uint32,
    "float": np.float32, "float32": np.float32,
    "double": np.float64, "float64": np.float64,
}


def read_ply_fields(file_path: str) -> Dict[str, np.ndarray]:
    """Reads the first vertex-like element of a PLY into {property: array}.

    Supports ascii and binary_little_endian, scalar properties only (list
    properties end parsing of that element).
    """
    with open(file_path, "rb") as f:
        magic = f.readline().strip()
        if magic != b"ply":
            raise ValueError(f"{file_path} is not a PLY file")
        fmt = None
        count = None
        props = []  # (name, dtype)
        in_element = False
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{file_path}: unexpected EOF in header")
            tokens = line.decode("ascii", "replace").strip().split()
            if not tokens:
                continue
            if tokens[0] == "format":
                fmt = tokens[1]
            elif tokens[0] == "element":
                if in_element:
                    # Only the first element is read, but the stream must
                    # still be advanced past the full header (multi-element
                    # files: vertex+face from Open3D/MeshLab) so the binary
                    # payload starts at the right offset.
                    while True:
                        line = f.readline()
                        if not line:
                            raise ValueError(
                                f"{file_path}: unexpected EOF in header")
                        if line.strip() == b"end_header":
                            break
                    break
                in_element = True
                count = int(tokens[2])
            elif tokens[0] == "property" and in_element:
                if tokens[1] == "list":
                    raise ValueError(
                        f"{file_path}: list properties unsupported")
                props.append((tokens[-1], _PLY_TYPES[tokens[1]]))
            elif tokens[0] == "end_header":
                break
        if fmt not in ("ascii", "binary_little_endian"):
            raise ValueError(f"{file_path}: unsupported format {fmt}")
        if count is None or not props:
            raise ValueError(f"{file_path}: no vertex element found")

        dtype = np.dtype([(name, np.dtype(t).newbyteorder("<"))
                          for name, t in props])
        if fmt == "binary_little_endian":
            rec = np.frombuffer(f.read(count * dtype.itemsize), dtype,
                                count=count)
        else:
            rows = [f.readline().split() for _ in range(count)]
            arr = np.asarray(rows, np.float64)
            rec = np.zeros(count, dtype)
            for i, (name, t) in enumerate(props):
                rec[name] = arr[:, i].astype(t)
        return {name: np.array(rec[name]) for name, _ in props}


def ply_to_pointcloud(fields: Dict[str, np.ndarray]):
    """Extracts (points (N, 3) float32, timestamps (N,) float64 or None)."""
    for trio in (("x", "y", "z"), ("X", "Y", "Z")):
        if all(k in fields for k in trio):
            pts = np.stack([fields[k] for k in trio], -1).astype(np.float32)
            break
    else:
        raise ValueError(f"No xyz properties in PLY (has {list(fields)})")
    ts = None
    for key in ("timestamp", "timestamps", "alpha_timestamp", "time", "t"):
        if key in fields:
            ts = fields[key].astype(np.float64)
            break
    return pts, ts
