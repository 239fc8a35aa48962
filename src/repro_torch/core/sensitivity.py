"""Offline sensitivity profiling for the layer swapping sequence (paper §3.2,
Appendix B, Algorithm 1).

Metrics (all cosine-similarity based; higher = safer to swap):
  LTS_p = cos(h_p(x), x_p)          — layer transformation sensitivity
  LRS_p = cos(h_p(x), h_p^Q(x))     — layer replacement sensitivity
  MDS_p^(Q) = cos(f^(Q)(x), f^(Q∪{p})(x)) — model degradation, state-aware
  LIS_p = α1·LTS + α2·LRS + β·MDS

Greedy Algorithm 1: repeatedly add the highest-LIS unswapped layer to Q.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm
from repro_torch.quant import quantize_tree


def mean_cosine(a, b, eps: float = 1e-8) -> float:
    """Mean cosine similarity along the feature dim, averaged over tokens."""
    a = a.reshape(-1, a.shape[-1]).to(torch.float32)
    b = b.reshape(-1, b.shape[-1]).to(torch.float32)
    num = torch.sum(a * b, dim=-1)
    den = torch.linalg.norm(a, dim=-1) * torch.linalg.norm(b, dim=-1) + eps
    return float(torch.mean(num / den))


def forward_capture(cfg: ModelConfig, params, layer_list, tokens, *,
                    frontend=None):
    """Run the unrolled stack, recording each layer's (input, output) and the
    final pre-unembed hidden state."""
    x = lm.embed_tokens(cfg, params, tokens, frontend)
    ios = []
    for i, (kind, lp) in enumerate(layer_list):
        x_in = x
        x, _ = lm.block_apply(kind, lp, cfg, x,
                              window=lm.layer_window(cfg, i), moe_cf=-1.0)
        ios.append((x_in, x))
    return x, ios


def final_hidden(cfg: ModelConfig, params, layer_list, tokens, *,
                 frontend=None):
    x = lm.embed_tokens(cfg, params, tokens, frontend)
    for i, (kind, lp) in enumerate(layer_list):
        x, _ = lm.block_apply(kind, lp, cfg, x,
                              window=lm.layer_window(cfg, i), moe_cf=-1.0)
    return x


@dataclasses.dataclass
class SwapProfile:
    order: List[int]                 # swap order (first = safest to quantize)
    lis: List[float]                 # LIS at selection time, per order entry
    lts: List[float]                 # per-layer (index = layer id)
    lrs: List[float]
    bits: int

    def to_dict(self):
        return dataclasses.asdict(self)


@torch.no_grad()
def profile_swap_sequence(cfg: ModelConfig, params, calib_tokens, *,
                          bits: int = 4, group: int = 128,
                          alpha1: float = 0.25, alpha2: float = 0.25,
                          beta: float = 0.5, frontend=None,
                          quant_bank: Optional[list] = None) -> SwapProfile:
    """Algorithm 1: greedy LIS-ordered swap sequence (runs on the params'
    device, under ``torch.no_grad``).

    ``calib_tokens``: (B, S) token ids on the params' device;
    ``frontend``: a VLM's patch embeddings for them.
    ``quant_bank``: optional precomputed per-layer quantized param trees
    (reused from the actuator's variant bank to avoid re-quantizing).
    """
    layer_list = lm.params_to_layer_list(cfg, params)
    Lct = len(layer_list)
    if quant_bank is None:
        quant_bank = [quantize_tree(lp, bits=bits, group=group)
                      for _, lp in layer_list]

    # --- input-independent local metrics (lines 1-4) -----------------------
    _, ios = forward_capture(cfg, params, layer_list, calib_tokens,
                             frontend=frontend)
    lts = [mean_cosine(x_out, x_in) for (x_in, x_out) in ios]
    lrs = []
    for i, (kind, lp) in enumerate(layer_list):
        x_in = ios[i][0]
        x_q, _ = lm.block_apply(kind, quant_bank[i], cfg, x_in,
                                window=lm.layer_window(cfg, i), moe_cf=-1.0)
        lrs.append(mean_cosine(ios[i][1], x_q))

    # --- greedy, state-aware selection (lines 5-14) -------------------------
    base_hidden = final_hidden(cfg, params, layer_list, calib_tokens,
                               frontend=frontend)
    current = list(layer_list)
    Q: List[int] = []
    lis_trace: List[float] = []
    prev_hidden = base_hidden
    for _ in range(Lct):
        best_j, best_lis, best_hidden = None, -np.inf, None
        for j in range(Lct):
            if j in Q:
                continue
            trial = list(current)
            trial[j] = (current[j][0], quant_bank[j])
            h = final_hidden(cfg, params, trial, calib_tokens,
                             frontend=frontend)
            mds = mean_cosine(prev_hidden, h)
            lis = alpha1 * lts[j] + alpha2 * lrs[j] + beta * mds
            if lis > best_lis:
                best_j, best_lis, best_hidden = j, lis, h
        Q.append(best_j)
        current[best_j] = (current[best_j][0], quant_bank[best_j])
        prev_hidden = best_hidden
        lis_trace.append(float(best_lis))
    return SwapProfile(order=Q, lis=lis_trace, lts=lts, lrs=lrs, bits=bits)


# --- baseline orderings (Appendix B.3 / Table 1) ---------------------------
def front_to_back_order(n_layers: int) -> List[int]:
    return list(range(n_layers))


def back_to_front_order(n_layers: int) -> List[int]:
    return list(range(n_layers - 1, -1, -1))


def random_order(n_layers: int, seed: int = 0) -> List[int]:
    rng = np.random.default_rng(seed)
    return list(rng.permutation(n_layers))
