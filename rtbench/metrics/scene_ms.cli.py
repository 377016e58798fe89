"""scene_ms.cli: spans around api.load_scene_file and api.compile_scene,
ms per frame (io + scene layer)."""
from rtbench.harness import readers


def read(run):
    return readers.span_ms(run, "frame", "load_scene_file", "compile_scene")
