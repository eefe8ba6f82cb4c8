"""Pure-Python PCD point-cloud file IO (port of
``pylidar_slam_tpu.dataset.pcd_io``; the NHCD loader's frame reader).

Supports ascii and binary DATA encodings (binary_compressed requires LZF and
raises a clear error).  Also provides a writer for round-trip tests.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

_PCD_TYPES = {
    ("F", 4): np.float32, ("F", 8): np.float64,
    ("I", 1): np.int8, ("I", 2): np.int16, ("I", 4): np.int32,
    ("U", 1): np.uint8, ("U", 2): np.uint16, ("U", 4): np.uint32,
}


def read_pcd(file_path: str) -> np.ndarray:
    """Reads a .pcd file -> (N, 3) float32 xyz array."""
    with open(file_path, "rb") as f:
        header: Dict[str, List[str]] = {}
        while True:
            line = f.readline().decode("ascii", errors="replace").strip()
            if line.startswith("#") or not line:
                continue
            key, *values = line.split()
            header[key.upper()] = values
            if key.upper() == "DATA":
                break
        fields = header["FIELDS"]
        sizes = [int(s) for s in header["SIZE"]]
        types = header["TYPE"]
        counts = [int(c) for c in header.get("COUNT", ["1"] * len(fields))]
        num_points = int(header["POINTS"][0])
        data_mode = header["DATA"][0]

        dtype_fields = []
        for name, size, typ, count in zip(fields, sizes, types, counts):
            base = _PCD_TYPES[(typ, size)]
            if count == 1:
                dtype_fields.append((name, base))
            else:
                dtype_fields.append((name, base, (count,)))
        dtype = np.dtype(dtype_fields)

        if data_mode == "ascii":
            raw = np.loadtxt(f, dtype=np.float64, max_rows=num_points)
            raw = raw.reshape(num_points, -1)
            col = {}
            ci = 0
            for name, count in zip(fields, counts):
                col[name] = raw[:, ci]
                ci += count
            xyz = np.stack([col["x"], col["y"], col["z"]], axis=1)
        elif data_mode == "binary":
            raw = np.frombuffer(f.read(num_points * dtype.itemsize),
                                dtype=dtype, count=num_points)
            xyz = np.stack([raw["x"], raw["y"], raw["z"]], axis=1)
        else:
            raise NotImplementedError(
                f"PCD DATA mode '{data_mode}' is not supported "
                "(ascii and binary are)")
    return xyz.astype(np.float32)


def write_pcd(file_path: str, points: np.ndarray, binary: bool = True):
    """Writes an (N, 3) array as a minimal xyz .pcd file."""
    points = np.asarray(points, dtype=np.float32)
    n = points.shape[0]
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\nFIELDS x y z\nSIZE 4 4 4\nTYPE F F F\nCOUNT 1 1 1\n"
        f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\n"
        f"DATA {'binary' if binary else 'ascii'}\n")
    with open(file_path, "wb") as f:
        f.write(header.encode("ascii"))
        if binary:
            dtype = np.dtype([("x", np.float32), ("y", np.float32),
                              ("z", np.float32)])
            rec = np.zeros(n, dtype=dtype)
            rec["x"], rec["y"], rec["z"] = points[:, 0], points[:, 1], points[:, 2]
            f.write(rec.tobytes())
        else:
            for p in points:
                f.write(f"{p[0]} {p[1]} {p[2]}\n".encode("ascii"))
