"""train_step_ms: the window's wall time over the Adam steps completed
in it, ms (host clock; each step ended by a synchronize)."""
from rtbench.harness import window


def read(run):
    if run.unit != "step":
        return None
    return window.per_item_ms(run.starts, run.ends)
