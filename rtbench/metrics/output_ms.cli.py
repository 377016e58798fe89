"""output_ms.cli: the frame span less the scene and node spans, ms per
frame: the copy to the host, the AA downsample, the PNG and
compile_camera (output layer)."""
from rtbench.harness import readers


def read(run):
    frame = readers.span_ms(run, "frame", "frame")
    inner = readers.span_ms(run, "frame", "load_scene_file", "compile_scene",
                            "render")
    if frame is None or inner is None:
        return None
    return frame - inner
