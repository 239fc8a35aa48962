# The port's three hand-written CUDA kernels and their routes:
#   wna16_gemm.py      — K1, fused dequant + GEMM of quantized layers
#   paged_attention.py — K2 decode block walk, K3 chunk-prefill block walk
#   ref.py             — the plain torch version of each
#   ops.py             — device-routed entry points + AttentionSpec
#   build.py           — nvcc build of csrc/*.cu, ctypes loading
# Nothing here builds or loads CUDA code at import time.
from repro_torch.kernels import ops, ref
from repro_torch.kernels.ops import AttentionSpec
