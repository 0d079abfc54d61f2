"""Mean of the SM clock read by nvidia-smi at the window's start and end."""

from portbench.harness import readers


def read(rec):
    return readers.sm_clock_mhz(rec)
