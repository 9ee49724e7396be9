"""``torch.cuda.max_memory_allocated()`` over the window, the peak count
reset at its start."""


def read(run):
    return run.window_peak / 2 ** 30 if run.window_peak else None
