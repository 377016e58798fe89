"""frame_p95_ms: the 95th percentile of every frame of the window, each
timed from its start to its PNG on disk, ms (host clock). Only where the
window holds 200 frames or more, so that ten lie beyond it."""
from rtbench.harness import window

MIN_FRAMES = 200


def read(run):
    if run.unit != "frame" or len(run.ends) < MIN_FRAMES:
        return None
    return 1e3 * window.percentile(
        [e - s for s, e in zip(run.starts, run.ends)], 95.0)
