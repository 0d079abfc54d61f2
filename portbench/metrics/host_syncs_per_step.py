"""Host calls per step that wait for the card, the harness's own waits left out (profiler)."""

from portbench.harness import readers


def read(rec):
    return readers.host_syncs_per_step(rec)
