"""KVResizer: elastic paged-KV pool sizing (paper §3.4).

Grows the pool when the swap level freed weight bytes (and pressure demands),
shrinks back when pressure subsides. Resizes are bucketed to multiples of
``step_frac`` of the baseline pool so the engine's recompile set stays
bounded (DESIGN.md §2 — the shape-stable analogue of CUDA VMM remapping).
Shrinking never reclaims blocks that are still referenced by live sequences.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.memory_ledger import MemoryLedger


@dataclasses.dataclass
class ResizeDecision:
    new_blocks: int
    reason: str


class KVResizer:
    def __init__(self, ledger: MemoryLedger, *, baseline_blocks: int,
                 step_frac: float = 0.125):
        self.ledger = ledger
        self.baseline = baseline_blocks
        self.step = max(int(baseline_blocks * step_frac), 1)

    def _bucket(self, blocks: int) -> int:
        """Round down to baseline + k*step (or below baseline in steps)."""
        if blocks >= self.baseline:
            k = (blocks - self.baseline) // self.step
            return self.baseline + k * self.step
        k = (self.baseline - blocks + self.step - 1) // self.step
        return max(self.baseline - k * self.step, self.step)

    def grow(self, *, weight_bytes: int,
             live_blocks: int) -> Optional[ResizeDecision]:
        """Largest bucketed pool that fits after weights shrank to
        ``weight_bytes``."""
        cap = self.ledger.max_kv_blocks(weight_bytes)
        target = self._bucket(cap)
        if target > self.ledger.kv_blocks:
            return ResizeDecision(target,
                                  f"grow to {target} (cap {cap})")
        return None

    def shrink(self, *, weight_bytes: int,
               live_blocks: int) -> Optional[ResizeDecision]:
        """Shrink toward baseline, never below what live sequences hold and
        never above what the restored weights allow."""
        cap = self.ledger.max_kv_blocks(weight_bytes)
        target = min(self._bucket(cap), max(self.baseline, 1))
        target = max(target, self._bucket(live_blocks + self.step - 1))
        target = min(target, cap)
        if target < self.ledger.kv_blocks and target >= live_blocks:
            return ResizeDecision(target, f"shrink to {target}")
        return None

    def clamp_to_tail(self, new_blocks: int, tail_blocks: int) -> int:
        """Partial-shrink support: the allocator can only drop a free tail,
        so lift ``new_blocks`` to the smallest bucketed size >= the live
        tail. A restore blocked on a full shrink-to-fit used to wedge the
        swap level at max for the rest of a trace (long decodes holding
        high block ids kept the tail busy); clamped targets let repeated
        ticks walk the pool down as the tail frees."""
        if new_blocks >= tail_blocks:
            return new_blocks
        b = self._bucket(tail_blocks)
        while b < tail_blocks:
            b += self.step
        return b

    def fits_restore(self, *, weight_bytes_restored: int) -> bool:
        """Can the current pool coexist with restored (larger) weights?"""
        return (self.ledger.max_kv_blocks(weight_bytes_restored)
                >= self.ledger.kv_blocks)
