"""Morphing Controller: pressure detection → swap-level / KV-resize commands
(paper §3.1). Threshold policy with hysteresis:

  * pressure HIGH  (kv_usage > high watermark, or queue delay > threshold):
    escalate one swap-level bucket; grant KVResizer the freed bytes.
  * pressure LOW   (kv_usage < low watermark and queue empty):
    restore one bucket (LIFO — the most recently swapped layers come back
    first, matching the paper's state-preserving restore).

``accuracy`` mode uses the paper thresholds and caps the level at half the
stack; ``performance`` mode swaps earlier (lower watermark) and deeper.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.configs.base import ServingConfig
from repro_torch.core.swap_plan import SwapPlan


@dataclasses.dataclass
class MorphCommand:
    target_level: int                 # absolute swap level to move to
    reason: str
    grow_kv: bool = False             # hint: expand pool after level applies
    shrink_kv: bool = False
    # third actuator (chunked prefill): halve / restore the engine's
    # per-step token budget so admission itself backs off under pressure
    # before (and alongside) swapping layers or resizing the pool.
    # shrink_chunk is the controller's pressure *hint* — the engine only
    # acts on it while a relief swap is in flight (a permanently shrunk
    # budget just trades TTFT away; see BENCH_serving.json), so at max
    # level sustained load intentionally runs at full budget.
    shrink_chunk: bool = False
    grow_chunk: bool = False
    # quantize-cold relief tier (between prefix eviction and live-KV
    # shrink / layer swaps): compress cold-but-live KV blocks in place.
    # quantize_kv fires under pressure while quantizable headroom remains
    # — the level does NOT move, so escalation is deferred until the
    # cheaper tier is exhausted. dequantize_kv is its restore mirror,
    # ordered after the level walks back to 0 (restore reverses the
    # ladder) and paced by the same calm-patience clock as level restores.
    quantize_kv: bool = False
    dequantize_kv: bool = False


class MorphingController:
    def __init__(self, serving: ServingConfig, plan: SwapPlan):
        self.sc = serving
        self.plan = plan
        self.level = 0
        max_lvl = serving.max_level(plan.n_layers)
        self._levels = [l for l in plan.levels if l <= max_lvl]
        if not self._levels:
            self._levels = [0]
        # last time the pressure signal read HIGH (restore hysteresis clock;
        # re-armed on every calm-driven restore so the level steps down one
        # bucket per patience window, not all at once)
        self._last_high_s = 0.0
        # escalation pacing: at most one level-up per monitor window, so a
        # single transient queue-delay blip can't ratchet 0 -> max in a few
        # consecutive 10ms steps before the EWMA even reacts
        self._last_escalate_s = float("-inf")

    # ------------------------------------------------------------------
    def _next_up(self, level: int) -> int:
        ups = [l for l in self._levels if l > level]
        return min(ups) if ups else level

    def _next_down(self, level: int) -> int:
        downs = [l for l in self._levels if l < level]
        return max(downs) if downs else level

    def high_watermark(self) -> float:
        return (self.sc.perf_kv_pressure_high
                if self.sc.mode == "performance" else self.sc.kv_pressure_high)

    def can_escalate(self) -> bool:
        """True while a deeper relief level remains — the admission
        controller treats this as headroom and defers shedding to it."""
        return self._next_up(self.level) != self.level

    def decide(self, signals: Dict[str, float]) -> Optional[MorphCommand]:
        kv = signals.get("kv_usage", 0.0)
        # class-weighted queue pressure when the engine reports it (the
        # interactive backlog escalates relief at full weight, offline
        # classes discounted); plain oldest-wait otherwise
        qd = signals.get("urgent_delay", signals.get("queue_delay", 0.0))
        now = signals.get("time_s", 0.0)
        high = kv > self.high_watermark() or qd > self.sc.queue_delay_high_s
        low = (kv < self.sc.kv_pressure_low
               and signals.get("queue_len", 0.0) < 0.5)
        if high:
            self._last_high_s = now
            # quantize-cold tier first: while cold live blocks remain
            # compressible, relief is a paced in-place quantize batch —
            # no level move, no live-KV shrink. Shares the escalation
            # pacing bucket so a pressure spike walks the ladder one
            # rung per monitor window, cheapest rung first.
            if signals.get("quant_headroom", 0.0) > 0 \
                    and now - self._last_escalate_s >= self.sc.monitor_window_s:
                self._last_escalate_s = now
                why = (f"kv_usage={kv:.2f}" if kv > self.high_watermark()
                       else f"queue_delay={qd * 1e3:.0f}ms")
                return MorphCommand(target_level=self.level, quantize_kv=True,
                                    grow_kv=True, shrink_chunk=True,
                                    reason=f"pressure high (quantize-cold, {why})")
            nxt = self._next_up(self.level)
            if nxt != self.level \
                    and now - self._last_escalate_s >= self.sc.monitor_window_s:
                self._last_escalate_s = now
                why = (f"kv_usage={kv:.2f}" if kv > self.high_watermark()
                       else f"queue_delay={qd * 1e3:.0f}ms")
                return MorphCommand(target_level=nxt, grow_kv=True,
                                    shrink_chunk=True,
                                    reason=f"pressure high ({why})")
            # at max level (or pacing the next step) — still grant KV growth
            return MorphCommand(target_level=self.level, grow_kv=True,
                                shrink_chunk=True,
                                reason="pressure high (at max level)")
        # restore on explicit LOW, or once pressure has stayed out of HIGH
        # for a full patience window ("calm"). The dead band alone used to
        # wedge the level: after a burst the grown pool parks kv_usage in
        # [low, high) indefinitely, and degradation — transient in the
        # paper — never receded. Calm restores re-arm the clock so the
        # level walks down one bucket per window and re-escalates freely
        # if the next burst hits.
        calm = (self.sc.restore_patience_s > 0
                and now - self._last_high_s >= self.sc.restore_patience_s)
        if low or calm:
            if self.level > 0:
                nxt = self._next_down(self.level)
                if not low:
                    self._last_high_s = now       # pace calm: one step/window
                return MorphCommand(target_level=nxt, shrink_kv=low,
                                    grow_chunk=True,
                                    reason=(f"pressure low (kv_usage={kv:.2f})"
                                            if low else "calm (restore)"))
            if signals.get("quant_blocks", 0.0) > 0:
                # level is back at 0: undo the quantize-cold tier next
                # (restore reverses the ladder), one paced batch per
                # calm window so a fresh burst can interrupt cheaply
                if not low:
                    self._last_high_s = now
                return MorphCommand(target_level=0, dequantize_kv=True,
                                    grow_chunk=True,
                                    reason=("pressure low (dequantize kv)"
                                            if low else "calm (dequantize kv)"))
            if low and signals.get("chunk_budget_frac", 1.0) < 1.0:
                # already at fp16 — only the admission budget is left to
                # restore (no level move, no KV command)
                return MorphCommand(target_level=0, grow_chunk=True,
                                    reason="pressure low (restore chunk budget)")
        return None

    def commit(self, level: int) -> None:
        self.level = level
