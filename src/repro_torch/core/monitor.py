"""Serving Monitor: smoothed runtime telemetry (paper §3.1).

Collects per-step metrics from the engine (KV usage, queue depth/delay,
TTFT/TPOT samples, throughput), smooths them over a short window (EWMA), and
exposes the signals the Morphing Controller thresholds on. Also keeps the
full time series for the Fig. 5 / Fig. 7 benchmarks.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional


@dataclasses.dataclass
class Telemetry:
    time_s: float
    kv_used_blocks: int
    kv_total_blocks: int
    queue_len: int
    oldest_wait_s: float
    running: int
    swap_level: int
    step_time_s: float
    preemptions: int = 0
    # token-budgeted step composition (chunked prefill observability):
    # single-token decodes executed, prompt-chunk tokens packed beside them,
    # prompt tokens still unpaged across PREFILLING + eligible queued
    # requests, and the live per-step token budget.
    decode_tokens: int = 0
    prefill_tokens: int = 0
    prefill_backlog_tokens: int = 0
    chunk_budget: int = 0
    # shared-prefix cache residency (blocks counted in kv_used_blocks that
    # are idle cached prefixes, reclaimable on demand)
    prefix_cached_blocks: int = 0
    # class-weighted queue pressure: max over arrived queued requests of
    # wait_s * SLOClass.pressure_weight — interactive backlog counts full
    # weight (escalates morph relief as before), batch/background waits are
    # discounted so offline backlog alone doesn't burn relief budget
    urgent_wait_s: float = 0.0
    # quantized-KV relief tier residency: live pool blocks currently held
    # in int8/int4 form, and the ledger bytes that quantization freed
    kv_quant_blocks: int = 0
    kv_bytes_relieved: int = 0

    @property
    def kv_usage(self) -> float:
        return (self.kv_used_blocks / self.kv_total_blocks
                if self.kv_total_blocks else 0.0)


class ServingMonitor:
    def __init__(self, *, ewma_alpha: float = 0.3):
        self.alpha = ewma_alpha
        self.kv_usage = 0.0
        self.queue_delay = 0.0
        self.urgent_delay = 0.0
        self.queue_len = 0.0
        self.tpot = 0.0
        self.history: List[Telemetry] = []
        self.ttft_samples: List[float] = []
        self.tpot_samples: List[float] = []

    def observe(self, t: Telemetry) -> None:
        a = self.alpha
        self.kv_usage = (1 - a) * self.kv_usage + a * t.kv_usage
        self.queue_delay = (1 - a) * self.queue_delay + a * t.oldest_wait_s
        self.urgent_delay = (1 - a) * self.urgent_delay + a * t.urgent_wait_s
        self.queue_len = (1 - a) * self.queue_len + a * t.queue_len
        self.history.append(t)

    def record_ttft(self, v: float) -> None:
        self.ttft_samples.append(v)

    def record_tpot(self, v: float) -> None:
        self.tpot_samples.append(v)
        a = self.alpha
        self.tpot = (1 - a) * self.tpot + a * v

    # --- signals for the controller ---------------------------------------
    def signals(self) -> Dict[str, float]:
        return {"kv_usage": self.kv_usage,
                "queue_delay": self.queue_delay,
                "urgent_delay": self.urgent_delay,
                "queue_len": self.queue_len,
                "tpot": self.tpot}
