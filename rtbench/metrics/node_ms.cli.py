"""node_ms.cli: the span around api.render (route, tables, node), ms per
frame (render layer)."""
from rtbench.harness import readers


def read(run):
    return readers.span_ms(run, "frame", "render")
