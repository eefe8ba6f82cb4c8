"""CUDA kernels a frame in the traced part of the window (the profiler's
filler left out)."""
from slambench import trace


def read(run):
    return trace.kernels_per_frame(run)
