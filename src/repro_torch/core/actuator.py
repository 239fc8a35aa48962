"""Morphing Actuator: executes swap commands on a worker (paper §3.1/§3.3).

TPU adaptation of asynchronous CUDA-stream swapping (DESIGN.md §2): a swap is
issued immediately but becomes *effective* only after the modeled host→device
transfer completes — decode steps continue on the old level in the interim,
exactly like the paper's overlapped cudaMemcpyAsync. The actuator also owns
the per-level mixed-precision layer lists (the jit cache key).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.core.swap_plan import SwapPlan

# host→device link bandwidth for the transfer-latency model. The paper cites
# PCIe Gen4 26-28 GB/s; TPU v5e host DMA is in the same class.
DEFAULT_LINK_GBPS = 26.0


@dataclasses.dataclass
class InflightSwap:
    target_level: int
    issued_at: float
    done_at: float
    bytes: int


class MorphingActuator:
    def __init__(self, plan: SwapPlan, *, link_gbps: float = DEFAULT_LINK_GBPS,
                 faults=None):
        self.plan = plan
        self.link_bps = link_gbps * 1e9
        self.level = 0
        self._inflight: Optional[InflightSwap] = None
        self._lists: Dict[int, list] = {}     # level -> mixed layer list
        self.swap_log: List[Tuple[float, int, int, float]] = []
        # optional fault injector (repro_torch.distributed.faults.ReplicaFaults):
        # adds transfer delay at issue time and can abort a completing swap
        # (level unchanged — the controller simply re-issues next window)
        self.faults = faults
        self.failed_swaps = 0
        self.failed_swap_log: List[Tuple[float, int, int]] = []

    # ------------------------------------------------------------------
    def layer_list(self, level: Optional[int] = None):
        lvl = self.level if level is None else level
        if lvl not in self._lists:
            self._lists[lvl] = self.plan.layer_list(lvl)
        return self._lists[lvl]

    def transfer_seconds(self, old: int, new: int) -> float:
        return self.plan.swap_transfer_bytes(old, new) / self.link_bps

    # ------------------------------------------------------------------
    def issue(self, target_level: int, now: float) -> InflightSwap:
        """Begin an asynchronous swap toward ``target_level``."""
        target_level = self.plan.clamp_level(target_level)
        if self._inflight is not None or target_level == self.level:
            return self._inflight
        nbytes = self.plan.swap_transfer_bytes(self.level, target_level)
        dt = nbytes / self.link_bps
        if self.faults is not None:
            dt += self.faults.swap_delay_s(now)
        self._inflight = InflightSwap(target_level, now, now + dt, nbytes)
        return self._inflight

    def poll(self, now: float) -> bool:
        """Complete the in-flight swap if its transfer window elapsed.
        Returns True when a level change took effect this call."""
        if self._inflight is None or now < self._inflight.done_at:
            return False
        if self.faults is not None and self.faults.swap_should_fail(now):
            # the transfer aborted: stay at the old level, clear the slot so
            # the control loop can retry (never wedges on a failed swap)
            self.failed_swaps += 1
            self.failed_swap_log.append(
                (now, self.level, self._inflight.target_level))
            self._inflight = None
            return False
        old = self.level
        self.level = self._inflight.target_level
        self.swap_log.append((now, old, self.level, self._inflight.bytes))
        self._inflight = None
        return True

    @property
    def busy(self) -> bool:
        return self._inflight is not None

    @property
    def inflight_target(self) -> Optional[int]:
        """Level the in-flight swap is moving to (None when idle)."""
        return None if self._inflight is None else self._inflight.target_level

    def weight_bytes(self) -> int:
        return self.plan.weight_bytes(self.level)


# device-memory bandwidth class for the in-place quantize pass (the
# compress/restore is HBM-local — read fp block, write int block + sidecar —
# not a host-link transfer like layer swaps)
DEFAULT_HBM_GBPS = 300.0


class KVQuantActuator:
    """Quantize-cold rung of the relief ladder (between prefix eviction and
    live-KV shrink): executes in-place compress / restore passes over cold
    paged-KV blocks.

    Mirrors ``MorphingActuator``'s pacing contract: each batch opens a busy
    window modeling the bandwidth-bound read+write pass over the touched
    block bytes, and the engine skips issuing while a window is open — so a
    pressure spike quantizes one paced batch per monitor window instead of
    compressing the whole pool in a single tick.
    """

    def __init__(self, *, block_bytes: int, hbm_gbps: float = DEFAULT_HBM_GBPS):
        self.block_bytes = max(int(block_bytes), 1)
        self.hbm_bps = hbm_gbps * 1e9
        self._busy_until = 0.0
        self.quantized_blocks = 0
        self.dequantized_blocks = 0
        self.quant_log: List[Tuple[float, str, int, float]] = []

    def busy(self, now: float) -> bool:
        return now < self._busy_until

    def issue(self, kind: str, n_blocks: int, now: float) -> float:
        """Record a compress ('quantize') or restore ('dequantize') batch.
        Returns the modeled pass duration (0.0 when nothing was issued)."""
        assert kind in ("quantize", "dequantize"), kind
        if n_blocks <= 0 or self.busy(now):
            return 0.0
        dt = (2.0 * n_blocks * self.block_bytes) / self.hbm_bps
        self._busy_until = now + dt
        if kind == "quantize":
            self.quantized_blocks += n_blocks
        else:
            self.dequantized_blocks += n_blocks
        self.quant_log.append((now, kind, n_blocks, dt))
        return dt
