"""Quantized weight container + routing matmul.

``QTensor`` stands in for a dense (K, N) weight. Every ``matmul`` in the
model code dispatches on the leaf type, so swapping a layer between
precisions is a substitution of leaves in the layer's param dict — the
mechanism behind MorphServe's LayerSwapper. A QTensor flagged
``use_kernel`` routes its matmuls through ``kernels/ops.wna16_matmul``:
the hand-written wNa16 GEMM on a CUDA tensor, its plain torch version on a
CPU tensor.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.quant import pack as packing


class QTensor:
    """Packed, group-quantized weight of logical shape (K, N), or a stack
    of E such weights (MoE experts: ``packed``/``scales``/``zeros`` with a
    leading E; ``nbytes`` and ``dequantize`` hold for either)."""

    def __init__(self, packed, scales, zeros, *, bits: int, group: int,
                 K: int, N: int, out_dtype=torch.float32, inv_act=None,
                 use_kernel: bool = False):
        self.packed = packed
        self.scales = scales
        self.zeros = zeros
        self.bits = bits
        self.group = group
        self.K = K
        self.N = N
        self.out_dtype = out_dtype
        # AWQ equalization: weights were scaled by ``act_scale`` before
        # quantization, so activations must be multiplied by ``inv_act``.
        self.inv_act = inv_act
        self.use_kernel = use_kernel

    @property
    def shape(self):
        return (self.K, self.N)

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.packed, self.scales, self.zeros))

    def with_use_kernel(self, use_kernel: bool = True) -> "QTensor":
        """Same weight, different matmul routing (tensors are shared)."""
        return QTensor(self.packed, self.scales, self.zeros, bits=self.bits,
                       group=self.group, K=self.K, N=self.N,
                       out_dtype=self.out_dtype, inv_act=self.inv_act,
                       use_kernel=use_kernel)

    def expert(self, e: int) -> "QTensor":
        """Entry ``e`` of a stacked QTensor: of (E, K, N) experts, a 2-D
        view, contiguous for a contiguous stack (``quantize_tree``, the
        bridge), in the layout the wNa16 kernel reads; of a deeper stack
        (the stacked experts of a repeated segment's layers), the stack
        one level down."""
        if self.packed.ndim < 3:
            raise ValueError("expert() needs a stacked QTensor")
        return QTensor(self.packed[e], self.scales[e], self.zeros[e],
                       bits=self.bits, group=self.group, K=self.K, N=self.N,
                       out_dtype=self.out_dtype,
                       inv_act=None if self.inv_act is None
                       else self.inv_act[e],
                       use_kernel=self.use_kernel)

    def dequantize(self, dtype=None):
        q = packing.unpack(self.packed, self.bits, self.K)
        return packing.dequantize_groupwise(
            q, self.scales, self.zeros, self.group, dtype or self.out_dtype)

    def __repr__(self):
        return (f"QTensor(int{self.bits}, K={self.K}, N={self.N}, "
                f"group={self.group}, use_kernel={self.use_kernel})")


def quantize_tensor(w: torch.Tensor, bits: int = 4, group: int = 128,
                    act_scale: Optional[torch.Tensor] = None,
                    use_kernel: bool = False) -> QTensor:
    """Quantize a dense (K, N) weight. ``act_scale`` (K,) applies an
    AWQ-style per-input-channel equalization before quantization; the
    reciprocal is stored on the QTensor and folded into activations by
    ``matmul`` (math: x @ W == (x/s) @ (s·W)). The group halves until it
    divides K, so scales and zeros are always indexed at the group they
    were built with."""
    K, N = w.shape
    dtype = w.dtype
    w = w.to(torch.float32)
    inv_act = None
    if act_scale is not None:
        w = w * act_scale[:, None]
        inv_act = (1.0 / act_scale).to(torch.float32)
    g = min(group, K)
    while K % g:
        g //= 2
    q, s, z = packing.quantize_groupwise(w, bits, g)
    return QTensor(packing.pack(q, bits), s, z, bits=bits, group=g, K=K, N=N,
                   out_dtype=dtype, inv_act=inv_act, use_kernel=use_kernel)


def is_quantized(w) -> bool:
    return isinstance(w, QTensor)


def matmul(x: torch.Tensor, w, *, bias=None, use_kernel: bool = False,
           plain: bool = False):
    """``x @ w (+ bias)`` where ``w`` is a dense (K, N) tensor or a QTensor.

    A flagged int4/int8 QTensor (or ``use_kernel=True``) goes to
    ``kernels/ops.wna16_matmul``, which folds ``inv_act``, ``bias`` and the
    output cast into the kernel's epilogue (``plain=True`` asks that route
    for its plain torch version). Otherwise the weight is dequantized to
    ``x.dtype`` and multiplied, as the JAX package does."""
    if not is_quantized(w):
        y = torch.matmul(x, w.to(x.dtype))
        return y if bias is None else y + bias
    if (use_kernel or w.use_kernel) and w.bits in (4, 8) \
            and w.packed.ndim == 2:
        from repro_torch.kernels import ops as kops
        lead = x.shape[:-1]
        out = kops.wna16_matmul(x.reshape(-1, x.shape[-1]), w, bias=bias,
                                plain=plain)
        return out.reshape(*lead, w.N)
    if w.inv_act is not None:
        x = x * w.inv_act.to(x.dtype)
    y = torch.matmul(x, w.dequantize(x.dtype))
    return y if bias is None else y + bias


def weight_nbytes(w) -> int:
    """Device bytes of a weight leaf (dense or quantized)."""
    if is_quantized(w):
        return w.nbytes
    return w.numel() * w.element_size()
