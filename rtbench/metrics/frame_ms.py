"""frame_ms: the window's wall time over the frames completed in it, ms
(host clock; each frame one render_scene_from_file call, PNG on disk)."""
from rtbench.harness import window


def read(run):
    if run.unit != "frame":
        return None
    return window.per_item_ms(run.starts, run.ends)
