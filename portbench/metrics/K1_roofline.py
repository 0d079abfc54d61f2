"""Share (%) of K1's device time that its least time at the published peaks takes (roofline/K1.py)."""

from portbench.harness import readers


def read(rec):
    return readers.roofline(rec, "K1")
