"""Runtime contract checks (``pylidar_slam_tpu.utils.checks``)."""
from __future__ import annotations

import os
from typing import Sequence

_DEBUG = os.environ.get("PYLIDAR_SLAM_DEBUG", "1") != "0"


class SlamAssertionError(AssertionError):
    pass


def assert_debug(condition: bool, message: str = ""):
    """Raises a SlamAssertionError when `condition` is False (debug builds only)."""
    if _DEBUG and not condition:
        raise SlamAssertionError(message)


def check_tensor(tensor, shape: Sequence[int], tensor_type: type = None):
    """Checks an array's shape (`-1` entries match any size) and, given
    `tensor_type`, its type."""
    if not _DEBUG:
        return tensor
    if tensor_type is not None:
        assert_debug(isinstance(tensor, tensor_type),
                     f"Expected type {tensor_type}, got {type(tensor)}")
    actual = tuple(tensor.shape)
    assert_debug(len(actual) == len(shape),
                 f"Rank mismatch: expected {list(shape)}, got {list(actual)}")
    for expected_dim, actual_dim in zip(shape, actual):
        if expected_dim != -1:
            assert_debug(int(expected_dim) == int(actual_dim),
                         f"Shape mismatch: expected {list(shape)}, got {list(actual)}")
    return tensor
