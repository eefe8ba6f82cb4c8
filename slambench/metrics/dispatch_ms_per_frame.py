"""Host milliseconds a frame the batched odometry spends dispatching its
step, from ``ICPFrameToModel.pipe_stats["dispatch_s"]``, over the window's
frames.  The counter exists on the batched path only."""


def read(run):
    c = run["counters"]
    if not c.get("flushes"):
        return None
    return 1e3 * c["dispatch_s"] / run["window"]["frames"]
