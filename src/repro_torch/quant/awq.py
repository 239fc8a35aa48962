"""AWQ-style activation-aware weight quantization (Lin et al., MLSys'24).

MorphServe uses AWQ INT4 as its quantized layer variants; the method is a
per-input-channel equalization ``s`` chosen from activation statistics,
grid-searched to minimize the output error of the quantized linear:

    W_q = quant(s ⊙ W),   y ≈ (x / s) @ dequant(W_q)
"""
from __future__ import annotations

import torch

from repro_torch.quant.qlinear import QTensor, quantize_tensor


def activation_magnitude(x_samples: torch.Tensor) -> torch.Tensor:
    """Per-input-channel mean |activation|, the AWQ salience statistic."""
    x2 = x_samples.reshape(-1, x_samples.shape[-1]).to(torch.float32)
    return torch.mean(torch.abs(x2), dim=0) + 1e-8


def _quant_error(x, w, bits, group, act_scale):
    qt = quantize_tensor(w, bits=bits, group=group, act_scale=act_scale)
    wd = qt.dequantize(torch.float32)
    xs = x if act_scale is None else x / act_scale[None, :]
    return torch.mean((x @ w - xs @ wd) ** 2)


def search_awq_scale(x_samples, w, *, bits: int = 4, group: int = 128,
                     n_grid: int = 11):
    """Grid search alpha in [0, 1]; returns (best_scale, best_alpha, errs)."""
    x = x_samples.reshape(-1, x_samples.shape[-1]).to(torch.float32)
    w = w.to(torch.float32)
    mag = activation_magnitude(x)
    best = (None, 0.0, None)
    best_err = _quant_error(x, w, bits, group, None)
    errs = [float(best_err)]
    for i in range(1, n_grid):
        alpha = i / (n_grid - 1)
        s = mag ** alpha
        s = s / torch.exp(torch.mean(torch.log(s)))       # geo-mean normalize
        s = torch.clamp(s, 1e-4, 1e4)
        err = _quant_error(x, w, bits, group, s)
        errs.append(float(err))
        if err < best_err:
            best_err = err
            best = (s, alpha, err)
    return best[0], best[1], errs


def quantize_linear_awq(x_samples, w, *, bits: int = 4, group: int = 128,
                        use_kernel: bool = False) -> QTensor:
    """AWQ-quantize a (K, N) weight given calibration activations."""
    s, _, _ = search_awq_scale(x_samples, w, bits=bits, group=group)
    return quantize_tensor(w, bits=bits, group=group, act_scale=s,
                           use_kernel=use_kernel)


def quantize_tree(params, *, bits: int = 4, group: int = 128,
                  min_size: int = 1 << 14, calib_acts=None,
                  use_kernel: bool = False, _prefix: str = ""):
    """Quantize every 2-D weight leaf of a layer's param dict (RTN
    per-group; AWQ equalization when ``calib_acts`` maps the leaf path
    'a/b/c' to activations). Norm params, biases, scalars and small tensors
    stay in full precision — only the GEMM weights of a decoder layer are
    quantized, as in the paper. Returns a new dict; leaves that stay are
    shared, not copied."""
    if isinstance(params, dict):
        return {k: quantize_tree(v, bits=bits, group=group,
                                 min_size=min_size, calib_acts=calib_acts,
                                 use_kernel=use_kernel,
                                 _prefix=f"{_prefix}{k}/")
                for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(
            quantize_tree(v, bits=bits, group=group, min_size=min_size,
                          calib_acts=calib_acts, use_kernel=use_kernel,
                          _prefix=f"{_prefix}{i}/")
            for i, v in enumerate(params))
    leaf = params
    if not isinstance(leaf, torch.Tensor) or leaf.numel() < min_size:
        return leaf
    if leaf.ndim == 2:
        acts = calib_acts.get(_prefix[:-1]) if calib_acts else None
        if acts is not None:
            return quantize_linear_awq(acts, leaf, bits=bits, group=group,
                                       use_kernel=use_kernel)
        return quantize_tensor(leaf, bits=bits, group=group,
                               use_kernel=use_kernel)
    if leaf.ndim == 3:
        # stacked expert weights (E, K, N): quantize each expert
        qts = [quantize_tensor(leaf[e], bits=bits, group=group)
               for e in range(leaf.shape[0])]
        return QTensor(torch.stack([q.packed for q in qts]),
                       torch.stack([q.scales for q in qts]),
                       torch.stack([q.zeros for q in qts]),
                       bits=bits, group=qts[0].group, K=leaf.shape[1],
                       N=leaf.shape[2], out_dtype=leaf.dtype,
                       use_kernel=use_kernel)
    return leaf
