"""forward_ms.train: the span around train.render_loss, ms per step."""
from rtbench.harness import readers


def read(run):
    return readers.span_ms(run, "step", "render_loss")
