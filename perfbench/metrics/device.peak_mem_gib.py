"""The most device memory allocated during the window (GiB):
``torch.cuda.max_memory_allocated`` after ``reset_peak_memory_stats`` at
its start."""


def read(run):
    return run.window_peak_bytes / 2**30 if run.window_peak_bytes else None
