"""Image visualization (torch port of ``pylidar_slam_tpu.viz.visualizer``).

Writes each update as a PNG frame to a directory, and shows it in a cv2
window only when one is asked for, cv2 imports and a display is there.
"""
from __future__ import annotations

import importlib.util
import os
from pathlib import Path
from typing import Optional

import numpy as np

from pylidar_slam_tpu_torch.viz.color_map import save_image, tensor_to_image


def _can_open_window() -> bool:
    return importlib.util.find_spec("cv2") is not None and bool(
        os.environ.get("DISPLAY") or os.environ.get("WAYLAND_DISPLAY"))


class ImageVisualizer:
    """Shows or persists image arrays per update."""

    def __init__(self, output_dir: Optional[str] = None,
                 window_name: str = "pylidar_slam_tpu",
                 use_window: bool = False, cmap: str = "viridis"):
        self.output_dir = Path(output_dir) if output_dir else None
        if self.output_dir:
            self.output_dir.mkdir(parents=True, exist_ok=True)
        self.window_name = window_name
        self.use_window = use_window and _can_open_window()
        self.cmap = cmap
        self._counter = 0

    def update(self, tensor: np.ndarray, tag: str = "frame"):
        image = tensor_to_image(np.asarray(tensor), cmap=self.cmap)
        if self.use_window:
            import cv2
            cv2.imshow(self.window_name, image[..., ::-1])
            cv2.waitKey(1)
        if self.output_dir is not None:
            save_image(str(self.output_dir / f"{tag}_{self._counter:06}.png"), image)
        self._counter += 1

    def close(self):
        if self.use_window:
            import cv2
            cv2.destroyWindow(self.window_name)
