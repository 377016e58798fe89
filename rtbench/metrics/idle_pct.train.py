"""idle_pct.train: share of the traced window of Adam steps in which no
kernel, copy or set runs on the card (the union of the device
intervals), %."""
from rtbench.harness import readers


def read(run):
    return readers.idle_pct(run, "step")
