"""backward_ms.train: the step span less the forward span, ms per step:
loss.backward and the Adam update."""
from rtbench.harness import readers


def read(run):
    step = readers.span_ms(run, "step", "step")
    forward = readers.span_ms(run, "step", "render_loss")
    if step is None or forward is None:
        return None
    return step - forward
