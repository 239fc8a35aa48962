"""K1's share of its roofline over the profiled span, in %: the sum of each
launch's least time (``rooflines.wna16_work`` at the M, K and N the harness
recorded around ``kernels.ops.wna16_matmul``) over the device time of the
``wna16_kernel`` launches in the trace."""
from servebench import profiling, rooflines


def read(run):
    dev = profiling.kernel_seconds(run["trace"], "wna16_kernel")
    if not run["k1_calls"] or dev <= 0:
        return None
    least = sum(rooflines.least_s(*rooflines.wna16_work(M, K, N, bits, g,
                                                        item, item))
                for M, K, N, bits, g, item in run["k1_calls"])
    return least / dev * 100.0
