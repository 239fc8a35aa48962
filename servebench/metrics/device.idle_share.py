"""Share of the profiled span in which no kernel, copy or set ran on the
card (``torch.profiler``, CUDA activity): 1 - busy_s / window_s. The trace
slows the eager host loop, so this reads higher than the untraced window
would; the run logs the span's step times beside the window's."""


def read(run):
    tr = run["trace"]
    if not tr or tr["window_s"] <= 0 or tr["busy_s"] <= 0:
        return None
    return 1.0 - tr["busy_s"] / tr["window_s"]
