"""Optional-dependency availability flags (torch port of
``pylidar_slam_tpu.utils.modules``).

Every capability the reference gates behind an optional package has an
in-repo replacement; these flags only gate the optional host-side viewer
integrations.
"""
from __future__ import annotations

import importlib.util


def _has(name: str) -> bool:
    return importlib.util.find_spec(name) is not None


_with_cv2 = _has("cv2")  # optional windowed visualization only
_with_o3d = _has("open3d")  # never required (icp3d replaces its ICP)
_with_g2o = False  # the pose graph is native (ops/pose_graph.py)
_with_viz3d = _has("viz3d")
_with_ct_icp = False  # elastic capability is native (deskew flag)
_with_native = None  # resolved lazily


def with_native() -> bool:
    """True when the C++ host runtime is available (utils/native.py)."""
    global _with_native
    if _with_native is None:
        from pylidar_slam_tpu_torch.utils import native
        _with_native = native.get_lib() is not None
    return _with_native
