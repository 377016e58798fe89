"""load_ms.cli: the program's rray.load ranges (the YAML parsed into a
scene) in the traced window, ms per frame (io + scene layer)."""
from rtbench.harness import readers


def read(run):
    return readers.program_ms(run, "frame", "load")
