"""png_ms.cli: the program's rray.png ranges (canvas.write_png: quantize,
encode, write) in the traced window, ms per frame (output layer)."""
from rtbench.harness import readers


def read(run):
    return readers.program_ms(run, "frame", "png")
