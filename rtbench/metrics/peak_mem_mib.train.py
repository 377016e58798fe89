"""peak_mem_mib.train: torch.cuda.max_memory_allocated over a step after
reset_peak_memory_stats, the largest of the window's steps, MiB."""


def read(run):
    if run.unit != "step" or not run.step_peaks:
        return None
    return max(run.step_peaks) / 2 ** 20
