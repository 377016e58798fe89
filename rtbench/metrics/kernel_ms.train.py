"""kernel_ms.train: device time of the port's own CUDA kernels per Adam
step, ms (torch.profiler kernel rows by name)."""
from rtbench.harness import readers


def read(run):
    return readers.kernel_ms(run, "step")
