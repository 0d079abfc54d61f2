"""Device ms per step of every kernel that is not one of the port's hand-written K1-K7 (profiler)."""

from portbench.harness import readers


def read(rec):
    return readers.glue_ms(rec)
