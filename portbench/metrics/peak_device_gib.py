"""``torch.cuda.max_memory_allocated()`` over the window (reset after
set-up, the inputs resident), in GiB."""


def read(run):
    return run.peak_bytes / 2**30 if run.peak_bytes else None
