"""Kernel B2's share of its roofline on the loop closure's refine: the least
time the passes of the submap events matched in the traced window need
(8 operations per query and valid model point of each pass that does work,
at the card's peak float32 rate; a pass whose flag is off needs none) over
the device time of B2's kernels there."""
from slambench import trace, workcounts


def read(run):
    t = run["trace"]
    if t is None or not t.get("lc_events"):
        return None
    launches, device_s = trace.kernel_sum(t, "nn_argmin", "nn_pack_model")
    if launches == 0 or device_s <= 0.0:
        return None
    need = 0.0
    for e in t["lc_events"]:
        need += e["refine_trips"] * workcounts.bound_s(
            workcounts.b2_bytes(e["queries"], e["model_rows"]),
            workcounts.b2_flops(e["queries"], e["model_valid_min"]))
    if need <= 0.0:  # no pass in the window had work to do
        return None
    return 100.0 * need / device_s
