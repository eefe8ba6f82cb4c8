"""Kernel B2's share of its roofline on the surfel map's odometry search:
the least time the traced B2 calls need over the device time of B2's
kernels in the traced window.

A call's least time is the larger of its operations at the card's peak
float32 rate (8 per valid query and valid map point, over the calls that did
work) and its bytes at peak bandwidth (``workcounts.b2_bytes``, as
``b2_roofline_share`` reckons a refine pass).  The traced calls are the
launches of B2's main kernel; the work per call is the post-trace part's
``count.surfel.nn_pairs`` over ``count.surfel.nn_calls`` (the program's
registry): the traced part and the part after it run the same step on the
same stream of scans."""
from slambench import trace, workcounts


def read(run):
    t, c = run["trace"], run["counters"]
    if t is None or not c.get("count.surfel.nn_calls") or not c.get("count.surfel.nn_pairs"):
        return None
    launches = trace.kernel_sum(t, "nn_argmin_partials")[0]
    device_s = trace.kernel_sum(t, "nn_argmin", "nn_pack_model")[1]
    if launches == 0 or device_s <= 0.0:
        return None
    lm = trace.odometry_program(run["config"])["local_map"]
    per_call = workcounts.bound_s(
        workcounts.b2_bytes(int(lm["target_samples"]),
                            int(lm["local_map_size"]) * int(lm["points_per_frame"])),
        workcounts.NN_PAIR_FLOPS * c["count.surfel.nn_pairs"] / c["count.surfel.nn_calls"])
    return 100.0 * launches * per_call / device_s
