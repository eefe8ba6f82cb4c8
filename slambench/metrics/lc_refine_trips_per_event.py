"""ICP refine trips (B2 passes that do work) per submap event that matched
candidates in the window, from the loop closure's ``match_stats``: a work
count that shows whether the traffic reached the match."""


def read(run):
    events = run["counters"].get("lc_events")
    if not events:
        return None
    return sum(e["refine_trips"] for e in events) / len(events)
