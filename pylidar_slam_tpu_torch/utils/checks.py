"""Runtime contract checks (``pylidar_slam_tpu.utils.checks``)."""
from __future__ import annotations

import os

_DEBUG = os.environ.get("PYLIDAR_SLAM_DEBUG", "1") != "0"


class SlamAssertionError(AssertionError):
    pass


def assert_debug(condition: bool, message: str = ""):
    """Raises a SlamAssertionError when `condition` is False (debug builds only)."""
    if _DEBUG and not condition:
        raise SlamAssertionError(message)
