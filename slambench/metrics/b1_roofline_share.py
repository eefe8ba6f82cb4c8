"""Kernel B1's share of its roofline: the least time its passes need (each
input byte read once and the sums written once, at the card's peak
bandwidth; the operations bound less at these shapes) over the device time
of B1's kernels in the traced window."""
from slambench import trace, workcounts


def read(run):
    t = run["trace"]
    if t is None:
        return None
    launches, device_s = trace.kernel_sum(t, "assoc_gn")
    if launches == 0 or device_s <= 0.0:
        return None
    s, lm = run["config"]["sensor"], trace.odometry_program(run["config"])["local_map"]
    bound = workcounts.b1_bound_s(int(s["lidar_height"]), int(s["lidar_width"]),
                                  int(lm["window_rows"]), int(lm["window_cols"]))
    return 100.0 * launches * bound / device_s
