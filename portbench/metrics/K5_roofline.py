"""Share (%) of K5's device time that its least time at the published peaks takes (roofline/K5.py)."""

from portbench.harness import readers


def read(rec):
    return readers.roofline(rec, "K5")
