"""kernel_ms.cli: device time of the port's own CUDA kernels per frame,
ms (torch.profiler kernel rows by name)."""
from rtbench.harness import readers


def read(run):
    return readers.kernel_ms(run, "frame")
