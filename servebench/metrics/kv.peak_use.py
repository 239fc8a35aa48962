"""The largest ``kv_used_blocks / kv_total_blocks`` of the monitor's
history in the window: how full the paged pool came, grown pool included."""


def read(run):
    use = [u / t for _, u, t in run["kv_history"] if t]
    return max(use) if use else None
