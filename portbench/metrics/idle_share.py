"""Share (%) of the traced window with nothing running on the card (profiler)."""

from portbench.harness import readers


def read(rec):
    return readers.idle_share(rec)
