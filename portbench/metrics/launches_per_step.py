"""Device kernels and copies per step in the profiler's trace."""

from portbench.harness import readers


def read(rec):
    return readers.launches_per_step(rec)
