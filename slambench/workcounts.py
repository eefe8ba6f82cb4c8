"""The yardstick of the kernels' roofline shares: the card's published peaks
and the least work each kernel's operation needs, from its inputs' shapes.

Copied from ``chip_smoke.py`` (``PEAK_F32_FLOPS`` / ``PEAK_BYTES_PER_S``
:273-274, ``NN_PAIR_FLOPS`` :277, ``b1_bound`` :1823-1833, ``b2_bound``
:1836-1846, ``_bound`` :1849-1853).  The counts are of the operation, not
of the kernel that implements it.
"""
from __future__ import annotations

# NVIDIA H100 SXM, data sheet, dense, at its 700 W limit
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# float32 operations per (query, valid model point) pair of the nearest-
# neighbour search: 3 subtractions, 3 products, 2 adds
NN_PAIR_FLOPS = 8
# B1's sums: 21 entries of H, 6 of g, the loss, the match count, the weight mass
B1_OUTPUTS = 30


def b1_bytes(height: int, width: int) -> int:
    """Bytes one window-association + normal-equations pass must move: the
    target image, the model's points and normals (float32 x 3 each), the
    model's validity bytes, read once, and the 30 float32 sums written once
    (4,849,784 B at 64 x 2048)."""
    return height * width * (3 * 3 * 4 + 1) + 4 * B1_OUTPUTS


def b1_flops_max(height: int, width: int, window_rows: int, window_cols: int) -> int:
    """The most float32 operations a pass can need: 8 per candidate
    distance of every target pixel and ~90 per match (residual, Jacobian,
    weight, the 30 products and sums), every pixel matched."""
    pixels = height * width
    return pixels * (2 * window_rows + 1) * (2 * window_cols + 1) * 8 + pixels * 90


def b1_bound_s(height: int, width: int, window_rows: int, window_cols: int) -> float:
    """The least time of one B1 pass: the larger of its bytes at peak
    bandwidth and its operations at peak float32 rate.  At these shapes the
    bytes bound it for any data (1.448 us against at most 0.41 us of
    operations at 64 x 2048), so the bound needs no count of the matches."""
    return max(b1_bytes(height, width) / PEAK_BYTES_PER_S,
               b1_flops_max(height, width, window_rows, window_cols) / PEAK_F32_FLOPS)


def b2_flops(queries: int, valid_model_points: int) -> int:
    """Operations one nearest-neighbour pass needs: every query against
    every valid model point.  A pass whose `active` flag is off needs none."""
    return NN_PAIR_FLOPS * queries * valid_model_points


def b2_bytes(queries: int, model_points: int) -> int:
    """Bytes one pass must move: queries and model points (float32 x 3),
    the validity bytes, and an index and a distance per query written."""
    return 12 * queries + 12 * model_points + model_points + 8 * queries


def bound_s(nbytes: float, flops: float) -> float:
    return max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS)
