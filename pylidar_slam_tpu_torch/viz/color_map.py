"""Colormap / tensor-to-image utilities for the trainer's image logging
(port of part of ``pylidar_slam_tpu.viz.color_map``; the rest of the
visualization is ROADMAP.md A.19).

Host-side and matplotlib-based, imported only when an image is logged.
"""
from __future__ import annotations

from typing import Optional

import numpy as np


def scalar_gray_cmap(values: np.ndarray, cmap: str = "viridis",
                     z_min: Optional[float] = None,
                     z_max: Optional[float] = None) -> np.ndarray:
    """Maps (N,) scalars to (N, 3) RGB colors in [0, 1] via a matplotlib cmap."""
    import matplotlib
    values = np.asarray(values, dtype=np.float64)
    lo = float(values.min() if z_min is None else z_min)
    hi = float(values.max() if z_max is None else z_max)
    normalized = np.clip((values - lo) / max(hi - lo, 1e-9), 0.0, 1.0)
    return np.asarray(matplotlib.colormaps.get_cmap(cmap)(normalized))[:, :3]


def tensor_to_image(tensor: np.ndarray, cmap: str = "viridis",
                    channel: int = 2) -> np.ndarray:
    """(C, H, W) or (H, W, C) or (H, W) array -> (H, W, 3) uint8 image;
    multi-channel inputs are colored by one channel (default: z / range)."""
    arr = np.asarray(tensor)
    if arr.ndim == 3:
        if arr.shape[0] <= 4:  # (C, H, W)
            arr = arr[min(channel, arr.shape[0] - 1)]
        else:  # (H, W, C)
            arr = arr[..., min(channel, arr.shape[-1] - 1)]
    h, w = arr.shape
    colors = scalar_gray_cmap(arr.reshape(-1), cmap=cmap)
    return (colors.reshape(h, w, 3) * 255).astype(np.uint8)
