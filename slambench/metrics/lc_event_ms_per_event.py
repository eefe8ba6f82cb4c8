"""Host milliseconds of one submap event of the loop closure (the candidate
search, the submap's image, the match and its refine as the host dispatches
them: the program's ``lc.event`` span) per event, ``1e3 x span.lc.event.s / count.lc.events`` over the part of the
window the readers take; nothing where that part holds no event.

Unlike ``lc_backend_ms_per_frame``, which lumps the loop closure together
with the backend, it shows the event's own work, the refine among it.  The
part of the window reaches further along the run when the rate moves, and
then holds other events (PERF.md, Open questions 4)."""


def read(run):
    c = run["counters"]
    if not c.get("count.lc.events"):
        return None
    return 1e3 * c["span.lc.event.s"] / c["count.lc.events"]
