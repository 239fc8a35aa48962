"""MorphServe core: the paper's contribution.

  sensitivity   — LTS/LRS/MDS/LIS profiling + Algorithm 1 greedy ordering
  swap_plan     — precomputed per-layer precision variants + byte ledger
  memory_ledger — the weights⇄KV device-memory budget invariant
  monitor       — Serving Monitor (smoothed telemetry)
  controller    — Morphing Controller (threshold policy, acc/perf modes)
  actuator      — Morphing Actuator (async swap with transfer-latency model)
  kv_resizer    — elastic paged-KV pool sizing
  kv_codec      — shared KV block quantize/dequantize codec (int8/int4)
"""
from repro_torch.core.sensitivity import (SwapProfile, profile_swap_sequence,
                                    mean_cosine, front_to_back_order,
                                    back_to_front_order, random_order)
from repro_torch.core.swap_plan import SwapPlan, build_swap_plan, tree_bytes
from repro_torch.core.memory_ledger import MemoryLedger
from repro_torch.core.monitor import ServingMonitor, Telemetry
from repro_torch.core.controller import MorphingController, MorphCommand
from repro_torch.core.actuator import MorphingActuator, KVQuantActuator
from repro_torch.core.kv_resizer import KVResizer, ResizeDecision
from repro_torch.core import kv_codec
from repro_torch.core.swap_plan import build_sim_swap_plan
