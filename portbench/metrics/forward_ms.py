"""Mean device time (ms) of the entry's forward call per step: CUDA events around it."""

from portbench.harness import readers


def read(rec):
    return readers.mean_ms(rec, "forward_ms")
