"""Swap plan: precomputed quantized layer variants + per-level byte ledger.

The paper's "model preloading" (§3.3): every precision variant of every
layer is materialized at startup, on the params' device; swap level k means
"the first k layers of the profiled order run quantized". Levels are
bucketed, which bounds the set of layer lists the engine runs.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ServingConfig
from repro_torch.models import lm
from repro_torch.quant import QTensor, quantize_tree, weight_nbytes


def tree_bytes(tree) -> int:
    """Device bytes of every tensor / QTensor leaf of a param tree."""
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    if isinstance(tree, (torch.Tensor, QTensor)):
        return weight_nbytes(tree)
    return 0


@dataclasses.dataclass
class SwapPlan:
    cfg: ModelConfig
    order: List[int]                    # profiled swap order
    bits: int
    levels: Tuple[int, ...]             # admissible #quantized-layers buckets
    fp_layers: List[Tuple[str, dict]]   # full-precision (kind, params)
    q_layers: List[dict]                # quantized params, same indexing
    fp_bytes: List[int]
    q_bytes: List[int]

    # ------------------------------------------------------------------
    @property
    def n_layers(self) -> int:
        return len(self.fp_layers)

    def clamp_level(self, level: int) -> int:
        """Round a requested level down to the nearest admissible bucket."""
        ok = [l for l in self.levels if l <= level]
        return max(ok) if ok else 0

    def layer_list(self, level: int) -> List[Tuple[str, dict]]:
        """Mixed-precision layer list at swap level ``level``."""
        swapped = set(self.order[:level])
        return [(kind, self.q_layers[i] if i in swapped else lp)
                for i, (kind, lp) in enumerate(self.fp_layers)]

    def weight_bytes(self, level: int) -> int:
        swapped = set(self.order[:level])
        return sum(self.q_bytes[i] if i in swapped else self.fp_bytes[i]
                   for i in range(self.n_layers))

    def freed_bytes(self, level: int) -> int:
        """Device bytes freed vs level 0 — the budget KVResizer may claim."""
        return self.weight_bytes(0) - self.weight_bytes(level)

    def swap_transfer_bytes(self, old: int, new: int) -> int:
        """Host→device traffic for an old→new transition (quantized variants
        in; restores copy fp weights back in)."""
        old_set, new_set = set(self.order[:old]), set(self.order[:new])
        bts = 0
        for i in new_set - old_set:
            bts += self.q_bytes[i]
        for i in old_set - new_set:
            bts += self.fp_bytes[i]
        return bts


def build_sim_swap_plan(cfg: ModelConfig, order: Sequence[int], *,
                        serving: Optional[ServingConfig] = None,
                        bits: int = 4, dtype_bytes: int = 2,
                        levels: Optional[Sequence[int]] = None) -> SwapPlan:
    """Byte-accounting-only plan for paper-scale simulation (no weights are
    materialized — layer_list() must not be called on a sim plan)."""
    from repro_torch.engine.cost_model import total_params
    per_layer_params = (total_params(cfg)
                        - 2 * cfg.vocab * cfg.d_model) / max(cfg.n_layers, 1)
    fp = int(per_layer_params * dtype_bytes)
    # packed body + per-group scale/zero overhead (~ +6% at group=128/f32)
    q = int(per_layer_params * (bits / 8) * 1.06)
    n = cfg.n_layers
    if levels is None:
        levels = serving.swap_levels if serving else (0, 1, 2, 4, 8, 16)
    levels = tuple(sorted({min(l, n) for l in levels} | {0, n}))
    return SwapPlan(cfg=cfg, order=list(order), bits=bits, levels=levels,
                    fp_layers=[("dense", None)] * n, q_layers=[None] * n,
                    fp_bytes=[fp] * n, q_bytes=[q] * n)


@torch.no_grad()
def build_swap_plan(cfg: ModelConfig, params, order: Sequence[int], *,
                    serving: Optional[ServingConfig] = None,
                    bits: int = 4, group: int = 128,
                    levels: Optional[Sequence[int]] = None,
                    use_kernel: bool = False) -> SwapPlan:
    fp_layers = lm.params_to_layer_list(cfg, params)
    q_layers = [quantize_tree(lp, bits=bits, group=group,
                              use_kernel=use_kernel)
                for _, lp in fp_layers]
    fp_bytes = [tree_bytes(lp) for _, lp in fp_layers]
    q_bytes = [tree_bytes(q) for q in q_layers]
    if levels is None:
        levels = serving.swap_levels if serving else (0, 1, 2, 4, 8, 16)
    levels = tuple(sorted({min(l, len(fp_layers)) for l in levels}
                          | {0, len(fp_layers)}))
    return SwapPlan(cfg=cfg, order=list(order), bits=bits, levels=levels,
                    fp_layers=fp_layers, q_layers=q_layers,
                    fp_bytes=fp_bytes, q_bytes=q_bytes)
