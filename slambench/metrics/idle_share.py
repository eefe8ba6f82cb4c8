"""The share of the traced window in which no kernel ran on the card:
1 - (the union of kernel intervals) / (the window's wall time)."""
from slambench import trace


def read(run):
    return trace.idle_share(run)
