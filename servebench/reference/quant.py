"""The int4 rule the swap plan applies, worked out again (frozen copy).

Asymmetric round-to-nearest per group of ``group`` rows along K (the
contraction dim), each (group, column) with its own float32 scale and
integer zero point: ``q = clip(round(w / s) + z, 0, 15)``, ``w' = (q - z) s``
with ``s = max((hi - lo) / 15, 1e-8)`` and ``z = clip(round(-lo / s), 0,
15)``. The group halves until it divides K. A layer's matmul weights are
quantized when they hold at least ``MIN_SIZE`` elements; the MoE router
never is. This is the paper's RTN int4 (``repro_torch.quant.pack``'s rule),
copied so that the reference takes nothing the program made.
"""
from __future__ import annotations

import torch

MIN_SIZE = 1 << 14


def int4_dequant(w: torch.Tensor, group: int = 128, bits: int = 4
                 ) -> torch.Tensor:
    """The float32 values of ``w`` (K, N) after int4 quantization."""
    K, N = w.shape
    g = min(group, K)
    while K % g:
        g //= 2
    qmax = 2 ** bits - 1
    wg = w.to(torch.float32).reshape(K // g, g, N)
    lo = wg.amin(dim=1)
    hi = wg.amax(dim=1)
    scale = torch.clamp((hi - lo) / qmax, min=1e-8)
    zero = torch.round(-lo / scale).clamp(0, qmax)
    q = torch.round(wg / scale[:, None, :] + zero[:, None, :]).clamp(0, qmax)
    return ((q - zero[:, None, :]) * scale[:, None, :]).reshape(K, N)


def quantized(w: torch.Tensor) -> bool:
    """True when the swap rule quantizes this matmul weight."""
    return w.numel() >= MIN_SIZE
