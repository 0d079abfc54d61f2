"""Share (%) of K3's device time that its least time at the published peaks takes (roofline/K3.py)."""

from portbench.harness import readers


def read(rec):
    return readers.roofline(rec, "K3")
