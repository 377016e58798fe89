"""tables_per_frame.cli: the whitted kernel's per-scene tables packed in
the window (the program's counter whitted.table_builds), per frame
(kernels layer). A CLI frame compiles a new scene, so each packs its
own."""
from rtbench.harness import readers

COUNTERS = ("rray_tpu_torch.kernels.whitted:table_builds",)


def read(run):
    return readers.count_per_item(run, "frame", COUNTERS[0])
