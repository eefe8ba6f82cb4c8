"""Headless 3D visualization: PLY point-cloud dumps, the registered map's
cloud and rendered trajectory views (torch port of
``pylidar_slam_tpu.viz.viz3d``).

``write_ply`` / ``read_ply`` write and read the JAX package's bytes.
``aggregate_map_cloud`` dedupes the map's voxels on a torch device (the
host sort of ``np.unique`` over a long sequence's ~17 M rows is the slow
part) and gives the numpy version's points exactly; ``render_map_views``
needs matplotlib, and without it logs one line and draws nothing.
"""
from __future__ import annotations

import importlib.util
import logging
from pathlib import Path
from typing import Optional

import numpy as np
import torch

logger = logging.getLogger(__name__)


def write_ply(file_path: str, points: np.ndarray,
              colors: Optional[np.ndarray] = None,
              binary: bool = True) -> None:
    """Writes an (N, 3) float cloud (+ optional (N, 3) uint8 colors) as PLY."""
    points = np.ascontiguousarray(np.asarray(points, np.float32))
    assert points.ndim == 2 and points.shape[1] == 3, points.shape
    n = points.shape[0]
    if colors is not None:
        colors = np.ascontiguousarray(np.asarray(colors))
        if colors.dtype != np.uint8:
            colors = np.clip(colors * 255.0, 0, 255).astype(np.uint8)
        assert colors.shape == (n, 3)

    header = ["ply",
              "format binary_little_endian 1.0" if binary else "format ascii 1.0",
              f"element vertex {n}",
              "property float x", "property float y", "property float z"]
    if colors is not None:
        header += ["property uchar red", "property uchar green", "property uchar blue"]
    header.append("end_header")

    path = Path(file_path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        if binary:
            if colors is None:
                f.write(points.tobytes())
            else:
                rec = np.zeros(n, dtype=[("xyz", np.float32, 3), ("rgb", np.uint8, 3)])
                rec["xyz"] = points
                rec["rgb"] = colors
                f.write(rec.tobytes())
        else:
            for i in range(n):
                row = f"{points[i, 0]} {points[i, 1]} {points[i, 2]}"
                if colors is not None:
                    row += f" {colors[i, 0]} {colors[i, 1]} {colors[i, 2]}"
                f.write((row + "\n").encode("ascii"))


def read_ply(file_path: str) -> np.ndarray:
    """Reads back the xyz of a PLY written by ``write_ply``."""
    with open(file_path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii").strip()
            header.append(line)
            if line == "end_header":
                break
        n = int(next(h for h in header if h.startswith("element vertex")).split()[-1])
        has_color = any("uchar red" in h for h in header)
        binary = any("binary" in h for h in header)
        if binary:
            if has_color:
                rec = np.frombuffer(f.read(), dtype=[("xyz", np.float32, 3),
                                                     ("rgb", np.uint8, 3)], count=n)
                return np.array(rec["xyz"])
            return np.frombuffer(f.read(), np.float32, count=3 * n).reshape(n, 3).copy()
        rows = [f.readline().split()[:3] for _ in range(n)]
        return np.asarray(rows, np.float32)


def chain_clouds(clouds: list, relative_poses: np.ndarray) -> np.ndarray:
    """The clouds expressed in the FIRST frame through the relative-pose
    chain, in float64 on the host (the JAX package's expression)."""
    absolute = np.eye(4)
    out = []
    for i, cloud in enumerate(clouds):
        if i > 0:
            absolute = absolute @ np.asarray(relative_poses[i], np.float64)
        pts = np.asarray(cloud, np.float64)[:, :3]
        out.append(pts @ absolute[:3, :3].T + absolute[:3, 3])
    return np.concatenate(out, axis=0)


def first_in_voxel(merged: torch.Tensor, voxel_size: float) -> torch.Tensor:
    """Indices of the first point of each occupied voxel, in increasing
    order (``np.sort`` of ``np.unique(..., return_index=True)``'s index)."""
    coords = torch.floor(merged / voxel_size).to(torch.int64)
    voxels, inverse = torch.unique(coords, dim=0, return_inverse=True)
    order = torch.arange(len(merged), device=merged.device)
    first = torch.full((len(voxels),), len(merged), dtype=torch.int64,
                       device=merged.device)
    first.scatter_reduce_(0, inverse, order, reduce="amin")
    return torch.sort(first).values


def _stride(merged, max_points: int):
    if merged.shape[0] > max_points:
        return merged[::merged.shape[0] // max_points + 1]
    return merged


def aggregate_map_cloud(clouds: list, relative_poses: np.ndarray,
                        voxel_size: float = 0.2, max_points: int = 2_000_000,
                        device=None) -> np.ndarray:
    """Chains the clouds into the first frame (``chain_clouds``),
    grid-samples the union keeping each voxel's first point in input order,
    and strides it down to `max_points`: (N, 3) float32.

    The voxel search runs on `device` (the CPU by default); its result is
    the numpy version's (``aggregate_map_cloud_numpy``) exactly: float64
    division and floor are exact on every device, and the kept rows are
    the same rows."""
    merged = chain_clouds(clouds, relative_poses)
    if voxel_size > 0 and len(merged):
        rows = torch.from_numpy(merged).to(device or "cpu")
        merged = merged[first_in_voxel(rows, voxel_size).cpu().numpy()]
    return _stride(merged, max_points).astype(np.float32)


def aggregate_map_cloud_numpy(clouds: list, relative_poses: np.ndarray,
                              voxel_size: float = 0.2,
                              max_points: int = 2_000_000) -> np.ndarray:
    """The JAX package's host version: ``np.unique`` over the voxel rows."""
    merged = chain_clouds(clouds, relative_poses)
    if voxel_size > 0:
        coords = np.floor(merged / voxel_size).astype(np.int64)
        _, first = np.unique(coords, axis=0, return_index=True)
        merged = merged[np.sort(first)]
    return _stride(merged, max_points).astype(np.float32)


def render_map_views(file_prefix: str, map_cloud: np.ndarray,
                     absolute_poses: Optional[np.ndarray] = None,
                     max_render_points: int = 200_000) -> list:
    """Renders a top-down and a 3D view of the map (+trajectory) to PNGs
    with matplotlib (headless).  Returns the written paths; without
    matplotlib, logs one line and returns []."""
    if importlib.util.find_spec("matplotlib") is None:
        logger.info("The map's PNG views need matplotlib: not drawn (%s)", file_prefix)
        return []
    from matplotlib.figure import Figure  # no pyplot state: thread-safe

    pts = map_cloud
    if pts.shape[0] > max_render_points:
        pts = pts[:: pts.shape[0] // max_render_points + 1]
    z = pts[:, 2]
    zlo, zhi = np.quantile(z, 0.02), np.quantile(z, 0.98)
    written = []

    fig = Figure(figsize=(10, 10))
    ax = fig.add_subplot()
    ax.scatter(pts[:, 0], pts[:, 1], c=np.clip(z, zlo, zhi), s=0.3,
               cmap="viridis", linewidths=0)
    if absolute_poses is not None:
        t = np.asarray(absolute_poses)[:, :3, 3]
        ax.plot(t[:, 0], t[:, 1], "r-", linewidth=1.5, label="trajectory")
        ax.legend()
    ax.set_aspect("equal")
    ax.set_title("map (top-down, colored by z)")
    top = f"{file_prefix}_map_topdown.png"
    fig.savefig(top, dpi=120, bbox_inches="tight")
    written.append(top)

    fig = Figure(figsize=(10, 8))
    ax = fig.add_subplot(projection="3d")
    ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], c=np.clip(z, zlo, zhi),
               s=0.2, cmap="viridis", linewidths=0)
    if absolute_poses is not None:
        t = np.asarray(absolute_poses)[:, :3, 3]
        ax.plot(t[:, 0], t[:, 1], t[:, 2], "r-", linewidth=1.5)
    ax.set_title("map (3D)")
    three_d = f"{file_prefix}_map_3d.png"
    fig.savefig(three_d, dpi=120, bbox_inches="tight")
    written.append(three_d)
    return written
