"""Nearest-neighbour searches that did work (kernel B2's passes whose
device flag held) per frame of the surfel map's odometry: the program's
``count.surfel.nn_active_calls`` over the window's frames.  A work count:
it moves when a change searches less or converges more slowly."""


def read(run):
    n = run["counters"].get("count.surfel.nn_active_calls")
    if n is None or not run["window"]["frames"]:
        return None
    return n / run["window"]["frames"]
