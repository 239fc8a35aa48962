"""Model FLOPs of the work the window's steps did, over the window times
the card's bf16 peak, in %: every token written (prompt or decode) through
every layer at 2 FLOPs a matmul parameter it goes through plus the
attention pairs of its causal context, and the head once for each token
delivered (``rooflines.step_model_flops``, 989 TFLOP/s)."""
from servebench import rooflines


def read(run):
    flops = sum(s.flops for s in run["steps"])
    if flops <= 0:
        return None
    return flops / (run["window_s"] * rooflines.BF16_FLOP_S) * 100.0
