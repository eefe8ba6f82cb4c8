"""Host milliseconds a frame in the loop closure and the backend, from the
program's own per-frame timers (``SLAM.elapsed_loop_closure`` and
``SLAM.elapsed_backend``), over the window's frames."""


def read(run):
    c = run["counters"]
    if not c.get("lc_frames"):
        return None
    return 1e3 * c["lc_s"] / c["lc_frames"]
