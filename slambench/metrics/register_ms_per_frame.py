"""Host milliseconds a frame in the odometry's registration (the program's
``odometry.register`` span: on the surfel map, the host's dispatch of its
GN trips), over the window's frames."""


def read(run):
    s = run["counters"].get("span.odometry.register.s")
    if s is None or not run["window"]["frames"]:
        return None
    return 1e3 * s / run["window"]["frames"]
