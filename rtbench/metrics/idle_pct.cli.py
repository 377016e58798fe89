"""idle_pct.cli: share of the traced window of frames in which no kernel,
copy or set runs on the card (the union of the device intervals), %."""
from rtbench.harness import readers


def read(run):
    return readers.idle_pct(run, "frame")
