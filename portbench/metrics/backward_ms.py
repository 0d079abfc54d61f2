"""Mean device time (ms) of autograd.grad per step (the entry's VJP): CUDA events around it."""

from portbench.harness import readers


def read(rec):
    return readers.mean_ms(rec, "backward_ms")
