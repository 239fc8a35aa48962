"""``torch.cuda.max_memory_allocated()`` over the run, read once the run has
served (before the reference runs), in GB (1e9 bytes)."""


def read(run):
    return run["peak_bytes"] / 1e9 if run["peak_bytes"] else None
