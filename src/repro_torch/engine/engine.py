"""MorphServe serving engine: continuous batching + paged KV + morphing loop.

One engine instance = one worker (the paper's Fig. 2 per-worker column:
Monitor → Controller → Actuator feedback loop wrapped around the step loop).

Clock: virtual, advanced by the roofline cost model per step, so paper
traces replay at paper scale whatever runs the tokens; a virtual time is a
model output, not a measurement. Compute: ``real`` (the model runs on the
engine's device through the kernel routes — tokens are real) or ``sim``
(token ids fabricated; identical control path).

This is the JAX package's engine with its host logic copied unchanged; the
device work (pool, model steps, argmax) is torch on ``device``. With the
quantized-KV relief tier on (``KVQuantConfig(enabled=True)``), the pool's
sidecar bundle rides every decode and chunk step, where the attention
kernels' KVQ lane dequantizes the quantized blocks.

Policies: ``morph`` (the paper's system), ``static_fp16`` and ``static_int4``
(the paper's two baselines, same engine, morphing disabled).
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Deque, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import VLM, ModelConfig, ServingConfig
from repro_torch.core import (KVQuantActuator, MemoryLedger, MorphingActuator,
                        MorphingController, KVResizer, ServingMonitor,
                        Telemetry, build_swap_plan, front_to_back_order)
from repro_torch.engine import model_exec
from repro_torch.engine.cost_model import CostModel, HardwareProfile, NVIDIA_L4
from repro_torch.engine.kv_cache import (PagedKVPool, PrefixCache, StatePool,
                                         kv_block_bytes)
from repro_torch.engine.metrics import ServingReport, build_report
from repro_torch.engine.request import (Request, RState, derive_token_seed,
                                  sim_token)
from repro_torch.engine.traces import (DEFAULT_SLO_CLASS, SLO_CLASSES, SLOClass,
                                 TraceRequest)
from repro_torch.core.swap_plan import tree_bytes
from repro_torch.models import lm


@dataclasses.dataclass
class RequestKVState:
    """Host-side export of one live request: its full scheduling/identity
    metadata plus the contents of its paged-KV blocks.

    This is the unit of cross-replica migration (drain handoff, partition
    fencing, straggler offload): the importer allocates its *own* block ids,
    scatters the payload, and resumes decode mid-stream — a bit-identical
    continuation, no re-prefill. ``k``/``v`` are None in simulated compute
    (the pool holds no real KV; the byte volume is still modeled from
    ``n_blocks``)."""
    cluster_id: Optional[int]
    arrival_s: float
    prompt: List[int]
    generated: List[int]
    max_new_tokens: int
    orig_prompt_len: int
    orig_max_new_tokens: int
    token_seed: int
    prefill_pos: int
    preemptions: int
    prefill_chunks: int
    first_token_s: Optional[float]
    token_times: List[float]
    token_levels: List[int]
    # swap level each full prompt block's KV was written under, plus the
    # exporter's live level — the importer preserves both so prefix-cache
    # publication and degradation accounting stay truthful after the move
    block_write_levels: List[Optional[int]]
    kv_level: int
    n_blocks: int
    k: Optional[np.ndarray] = None
    v: Optional[np.ndarray] = None
    # SLO class + first-schedule stamp ride along so the importer's
    # scheduler/preemption decisions and per-class accounting stay truthful
    slo_class: str = DEFAULT_SLO_CLASS
    sched_first_s: Optional[float] = None
    # quantized-KV metadata: positions into the block list whose payload is
    # compressed, the codec width, and (real compute) the compressed state
    # itself — a ``gather_quant_blocks`` tuple. Quantized blocks migrate
    # round-trip-free: int8 payload + sidecar params travel as-is and the
    # importer scatters them back still quantized (``k``/``v`` hold fp
    # zeros at these positions).
    quant_idx: List[int] = dataclasses.field(default_factory=list)
    quant_bits: int = 8
    quant_payload: Optional[tuple] = None


@dataclasses.dataclass
class KVQuantConfig:
    """Quantized-KV relief tier — the pressure-ladder rung between
    prefix-cache eviction and live-KV shrink.

    Under sustained HIGH pressure the morph tick compresses *cold but
    live* KV blocks in place through the affine per-block codec
    (:mod:`repro.core.kv_codec`): LRU within live requests, never a
    sequence's attention-window tail, shared prefix blocks excluded. The
    attention kernels dequantize quantized blocks on the fly inside the
    block walk (sidecar scale/zero per (layer, block)), so no live
    sequence loses context — only precision, which the ledger converts
    into extra pool capacity. Restore (calm, level 0) dequantizes paced
    batches back to fp. GQA-family archs only: MLA latent pools and SSM
    state are never quantized."""
    enabled: bool = False
    # codec width: 8 (int8, default) or 4 (int4 — stored unpacked in the
    # int8 mirror on device, nibble-packed only on the migration wire)
    bits: int = 8
    # cap on the fraction of allocated blocks held quantized at once
    max_quant_frac: float = 0.5
    # never quantize a sequence's last N full blocks (the attention-window
    # tail decode re-reads hottest)
    keep_tail_blocks: int = 1
    # blocks per paced quantize/dequantize batch (one batch per morph tick)
    batch_blocks: int = 8
    # prefix-cache cross-level hit policy: "adopt" reuses the entry as-is
    # (tolerance tag rides on the request), "requant" re-homes the entry at
    # the requesting level by requantizing its block through the codec
    cross_level_mode: str = "adopt"


@dataclasses.dataclass
class EngineConfig:
    policy: str = "morph"            # morph | static_fp16 | static_int4
    compute: str = "real"            # real | sim
    hw: HardwareProfile = NVIDIA_L4
    max_prefills_per_step: int = 2
    dtype: str = "float32"
    seed: int = 0
    # decode block tables are truncated to the power-of-two bucket of the
    # live max blocks across slots, so per-step gather cost follows the live
    # context (bounded recompile set). Disable to force full-max_nb tables.
    decode_nb_bucketing: bool = True
    # admit up to max_prefills_per_step requests into one prefill call at a
    # shared bucketed length (attention/MLA families; SSM state is
    # position-exact and keeps the per-request path).
    batch_prefill: bool = True
    # route swapped-layer matmuls through the fused wNa16 kernel path
    # (None => inherit ServingConfig.use_quant_kernel)
    use_quant_kernel: Optional[bool] = None
    # preallocate the paged KV pool to power-of-two capacity buckets so
    # within-bucket morph-tick resizes are O(1) metadata updates (no device
    # pool copy, no new pool shape). Disable to force a copy-per-resize
    # pool.
    kv_capacity_bucketing: bool = True
    # --- token-budgeted step loop (Sarathi-style chunked prefill) --------
    # each step packs up to this many tokens: every live decode token first,
    # the remainder filled with prompt chunks — so decode throughput is never
    # head-of-line blocked behind a long prompt. <= 0 disables budgeting
    # (legacy whole-prompt admission).
    max_tokens_per_step: int = 256
    # stream prompts longer than the leftover budget through the paged pool
    # in bucketed chunks (attention/MLA real compute; every family in sim).
    # False admits whole prompts only, still budget-gated.
    chunked_prefill: bool = True
    # floor for the live budget when the morph controller shrinks it under
    # pressure (third actuator beside swap level and KV blocks)
    min_chunk_tokens: int = 32
    # --- shared-prefix KV cache ------------------------------------------
    # Hash block-aligned prompt prefixes (chained per-block hashes, swap
    # level folded into every link) to refcounted pool blocks: admission
    # seeds a hit's block table with the shared blocks copy-on-write and
    # chunked prefill starts at the first uncached position; finished
    # requests publish their full prompt blocks back instead of freeing
    # them. Idle cached blocks are the engine's cheapest relief tier —
    # reclaimed LRU before live-KV shrink, preemption, or a layer swap.
    # Off by default: resident cached blocks change pool-occupancy
    # dynamics, so workloads opt in (serving bench / shared-prefix traces).
    prefix_caching: bool = False
    # --- fault tolerance --------------------------------------------------
    # consecutive *transient* (injected) KV-allocation failures a request
    # rides out — it stalls for the step and retries next step (the
    # virtual-clock analogue of retry-with-backoff) — before the engine
    # escalates to the preemption path
    alloc_retry_limit: int = 3
    # livelock cap: a request preempted more than this many times is
    # terminated as FAILED (counted as an SLO violation) instead of cycling
    # through re-prefill forever. <= 0 disables (default: single-engine
    # benches keep the seed's unbounded recompute semantics).
    max_preemptions: int = 0
    # step-loop invariant watchdog cadence in steps (<= 0 disables):
    # cross-checks ledger vs pool accounting, block-table bounds/ownership,
    # prefix-cache refcounts, and the live-request counter; violations are
    # repaired in place (graceful degradation) instead of crashing mid-trace
    watchdog_interval: int = 16
    # --- SLO-class-aware scheduling / admission control -------------------
    # admission ordering policy:
    #   "slack" — deadline-slack priority: arrived requests are ordered by
    #     least slack first (class TTFT deadline minus now minus an
    #     estimated service time), with starvation-bounded aging lifting
    #     batch/background work that has waited past its class's
    #     age_after_s until it outranks fresh interactive arrivals. For a
    #     single-class trace with equal-length prompts this degenerates to
    #     exact FIFO order.
    #   "fifo" — the seed's arrival-order admission (per-class targets and
    #     shedding still apply when admission_control is on).
    scheduler: str = "slack"
    # --- quantized-KV relief tier (see KVQuantConfig) ---------------------
    kv_quant: KVQuantConfig = dataclasses.field(default_factory=KVQuantConfig)
    # explicit overload admission control: shed a request terminally
    # (RState.SHED, counted once) at submit/queue-head when its class
    # deadline is already unmeetable, or when the CostModel's queue-delay
    # estimate blows the deadline and no morph-relief headroom (deeper swap
    # level / in-flight relief) remains. Off by default: shedding changes
    # workload outcomes, so benches/serving opt in explicitly.
    admission_control: bool = False


class MorphServeEngine:
    def __init__(self, cfg: ModelConfig, params, serving: ServingConfig,
                 ecfg: EngineConfig, *, swap_order: Optional[Sequence[int]] = None,
                 fault_injector=None, device="cuda", plan=None):
        # ``plan``: a prebuilt SwapPlan to book instead of building one (a
        # sim engine given a real model's per-layer bytes)
        # resolves "cuda" to the current card (and raises without one)
        self.device = torch.empty(0, device=device).device
        if ecfg.compute == "real" and cfg.family == VLM:
            # the JAX engine fails later, at its first whole-prompt
            # prefill ("vlm needs patch embeddings")
            raise ValueError(f"{cfg.name}: the engine takes no image input, "
                             f"so a VLM serves only with compute='sim'")
        if ecfg.compute == "real":
            devs = {t.device for t in _tensors(params)}
            if devs != {self.device}:
                raise ValueError(f"params live on {sorted(map(str, devs))}, "
                                 f"the engine runs on {self.device}")
        self.cfg = cfg
        self.sc = serving
        self.ec = ecfg
        self.now = 0.0
        self.rng = np.random.default_rng(ecfg.seed)
        self.kinds = tuple(lm.layer_kinds(cfg))
        # deterministic chaos hooks (repro.distributed.faults.ReplicaFaults):
        # queried at the allocation / swap / step-time seams; None = no faults
        self.faults = fault_injector

        # --- morphing substrate -------------------------------------------
        order = list(swap_order) if swap_order is not None \
            else front_to_back_order(cfg.n_layers)
        self.use_quant_kernel = (serving.use_quant_kernel
                                 if ecfg.use_quant_kernel is None
                                 else ecfg.use_quant_kernel)
        if plan is not None:
            self.plan = plan
        elif ecfg.compute == "sim":
            from repro_torch.core.swap_plan import build_sim_swap_plan
            self.plan = build_sim_swap_plan(cfg, order, serving=serving,
                                            bits=serving.swap_bits)
        else:
            self.plan = build_swap_plan(cfg, params, order, serving=serving,
                                        bits=serving.swap_bits,
                                        use_kernel=self.use_quant_kernel)
        self.actuator = MorphingActuator(self.plan, faults=self.faults)
        self.controller = MorphingController(serving, self.plan)
        self.monitor = ServingMonitor()

        # --- static policies pin the level --------------------------------
        if ecfg.policy == "static_int4":
            self._pinned_level = self.plan.n_layers
        elif ecfg.policy == "static_fp16":
            self._pinned_level = 0
        else:
            self._pinned_level = None
        if self._pinned_level is not None:
            self.actuator.level = self._pinned_level
            self.controller.commit(self._pinned_level)

        # --- memory ledger + paged pool ------------------------------------
        bs = serving.kv_block_size
        blk_bytes = max(kv_block_bytes(
            cfg, bs, dtype_bytes=lm.torch_dtype(ecfg.dtype).itemsize), 1)
        w0 = self.plan.weight_bytes(self.actuator.level)
        # non-swappable weights (embeddings/head/norms) live in the reserve
        if ecfg.compute == "sim":
            embed_bytes = 2 * cfg.vocab * cfg.d_model * 2
        else:
            embed_bytes = tree_bytes(
                {k: v for k, v in params.items() if k != "segments"})
        act_reserve = int(0.05 * serving.hbm_budget_bytes) + embed_bytes
        self.ledger = MemoryLedger(serving.hbm_budget_bytes, act_reserve,
                                   w0, blk_bytes)
        baseline_blocks = max(self.ledger.max_kv_blocks(
            self.plan.weight_bytes(0)), 1)
        start_blocks = max(self.ledger.max_kv_blocks(w0), 1) \
            if ecfg.policy == "static_int4" else baseline_blocks
        start_blocks = max(min(start_blocks,
                               self.ledger.max_kv_blocks(w0)), 1)
        try:
            self.ledger.resize_kv(start_blocks)
        except ValueError:
            start_blocks = 1              # SSM archs / degenerate budgets
            self.ledger.kv_blocks = start_blocks
        self.resizer = KVResizer(self.ledger, baseline_blocks=baseline_blocks,
                                 step_frac=serving.kv_resize_step_frac)
        self.pool = PagedKVPool(cfg, start_blocks + 1, bs,
                                dtype=lm.torch_dtype(ecfg.dtype),  # +1 scratch
                                bucket_capacity=ecfg.kv_capacity_bucketing,
                                device=self.device)

        # --- quantized-KV relief tier ---------------------------------------
        # GQA-family archs only: MLA latent pools and SSM recurrent state
        # never quantize (the candidate picker returns nothing for them)
        qc = ecfg.kv_quant
        self._kv_quant_on = bool(
            qc.enabled and cfg.mla is None
            and cfg.family not in ("ssm", "hybrid"))
        # a quantized block's ledger bytes: payload at bits/16 of fp16-rate
        # plus the per-(layer, block) sidecar (k/v scale+zero, 4 f32 each
        # layer); clamped below the fp rate so relief is never negative
        qblk = min(max(blk_bytes * qc.bits // 16 + cfg.n_layers * 16, 1),
                   blk_bytes)
        # set unconditionally: an import can deliver quantized blocks even
        # to an engine whose own quantize tier is off
        self.ledger.kv_quant_block_bytes = qblk
        self.quant_actuator = KVQuantActuator(block_bytes=blk_bytes)

        # --- decode slots + SSM state pools ---------------------------------
        self.slots = serving.max_batch_slots
        self.max_nb = serving.max_blocks_per_seq or \
            -(-serving.max_seq_len // bs)
        self._slot_req: List[Optional[Request]] = [None] * self.slots
        # per-slot SSM state, float32, beside the ledger (as in the JAX
        # engine, which does not book it)
        self.state_pool = None
        self.ssm_conv = self.ssm_ssm = torch.zeros((0,), device=self.device)
        if ecfg.compute == "real" and \
                any(k in ("mamba", "hybrid") for k in self.kinds):
            self.state_pool = StatePool(cfg, self.slots, device=self.device)
            self.ssm_conv = self.state_pool.conv
            self.ssm_ssm = self.state_pool.ssm

        # --- execution + cost ------------------------------------------------
        if ecfg.compute == "real":
            self.exec = model_exec.ModelExec(cfg, params, self.kinds,
                                             kv_quant=self._kv_quant_on)
        else:
            self.exec = None
        self.cost = CostModel(cfg, ecfg.hw, block_size=bs)

        # --- request state ----------------------------------------------------
        self.queue: Deque[Request] = collections.deque()
        self.all_requests: List[Request] = []
        self._next_rid = 0
        self._n_live = 0          # requests in QUEUED/PREFILLING/RUNNING/PREEMPTED
        self.rejected = 0
        self.failed = 0           # terminal FAILED (unservable; incl. rejects)
        # --- overload admission control -----------------------------------
        self.shed = 0             # terminal SHED outcomes (counted once each)
        self.shed_at_submit = 0   # refused at the front door
        self.shed_at_queue = 0    # refused at queue-head / deadline sweep
        # scheduler liveness invariant (CI-gated zero): an *aged*
        # batch/background request passed over while a later candidate was
        # admitted in the same scheduling round — by construction the
        # admission loop never skips a live candidate, so any increment is
        # a starvation bug
        self.starvation_bypasses = 0
        self.resize_log: List = []
        # --- shared-prefix KV cache (attention/MLA archs only: SSM has no
        # paged KV to share, and whole-prompt-only paths can't start a
        # prefill at a nonzero offset) -----------------------------------
        self.prefix_cache = (PrefixCache(bs)
                             if ecfg.prefix_caching
                             and cfg.family not in ("ssm",)
                             and self._can_chunk() else None)
        self.prefix_hit_requests = 0  # distinct requests with >= 1 hit
        self._prefix_hit_rids: set = set()
        self.prefill_tokens_saved = 0
        self.prefix_evicted_for_pressure = 0
        self.compaction_moves = 0     # blocks migrated out of doomed tails
        # quantize-cold tier log: (time_s, "quantize"|"dequantize", blocks)
        self.kv_quant_events: List = []
        # live per-step token budget (morph controller's third actuator:
        # shrunk toward min_chunk_tokens under pressure, restored on drain)
        self.chunk_budget = ecfg.max_tokens_per_step
        self.chunk_log: List = []
        # liveness invariant counters (gated by CI's serving smoke): steps
        # where a request that was decoding at step start neither produced
        # a token nor was preempted while prefill work ran beside it, and
        # steps that packed decode + prompt chunks into one iteration
        self.decode_stall_steps = 0
        self.mixed_steps = 0
        # --- fault tolerance ------------------------------------------------
        self._alloc_fault = False     # last _alloc_blocks miss was injected
        self.alloc_fault_stalls = 0   # request-steps stalled on a transient
        self.livelock_failures = 0    # requests FAILED by the preemption cap
        self._step_idx = 0
        self.watchdog_trips: List = []   # (time_s, kind, detail)
        self.watchdog_repairs = 0

    # ------------------------------------------------------------------
    # request admission / lifecycle
    # ------------------------------------------------------------------
    def submit(self, tr: TraceRequest) -> Request:
        if tr.prompt_tokens is not None:
            prompt = list(tr.prompt_tokens)
        else:
            prompt = list(self.rng.integers(0, self.cfg.vocab,
                                            size=tr.prompt_len))
        r = Request(self._next_rid, tr.arrival_s, prompt, tr.max_new_tokens,
                    token_seed=(tr.token_seed if tr.token_seed is not None
                                else derive_token_seed(prompt)),
                    orig_prompt_len=(-1 if tr.orig_prompt_len is None
                                     else tr.orig_prompt_len),
                    orig_max_new_tokens=(-1 if tr.orig_max_new_tokens is None
                                         else tr.orig_max_new_tokens),
                    slo_class=tr.slo_class)
        self._next_rid += 1
        self.all_requests.append(r)
        # reject requests that can never fit (block table or max-grown pool)
        theoretical_max = self.ledger.max_kv_blocks(
            self.plan.weight_bytes(self.plan.n_layers))
        if self.pool.blocks_for(len(prompt) + tr.max_new_tokens + 1) \
                > min(self.max_nb, theoretical_max):
            r.state = RState.FAILED       # terminal reject; always a violation
            self.rejected += 1
            self.failed += 1
            return r
        # front-door admission control: only for requests submitted *live*
        # (arrival not in the future — trace replay pre-submits the whole
        # trace, where the queue ahead will have drained by arrival time;
        # those are checked at queue-head instead)
        if (self.ec.admission_control and tr.arrival_s <= self.now
                and self._should_shed(r)):
            r.state = RState.SHED
            self.shed += 1
            self.shed_at_submit += 1
            return r
        self._enqueue(r)
        self._n_live += 1
        return r

    def _sim_token(self, r: Request) -> int:
        """Simulated-compute next token: a pure function of the request's
        token seed and absolute context position, NOT of engine rng state —
        so preemption, re-dispatch, and mid-decode migration all regenerate
        the exact stream the uninterrupted run would have produced."""
        return sim_token(r.token_seed, r.context_len, self.cfg.vocab)

    # ------------------------------------------------------------------
    # SLO-class-aware scheduling / admission control
    # ------------------------------------------------------------------
    def _slo(self, r: Request) -> SLOClass:
        return SLO_CLASSES.get(r.slo_class, SLO_CLASSES[DEFAULT_SLO_CLASS])

    def _enqueue(self, r: Request, *, front: bool = False) -> None:
        """THE queue-insert point: the wait queue is kept sorted by
        (arrival_s, rid) at all times, so FIFO admission's future-arrival
        skip and ``release_queued``'s hand-off order stay well-defined even
        after redispatch/migration deliver out-of-order arrivals.

        ``front=True`` is the one sanctioned exception — a preempted
        request already delivered tokens, so resuming it first bounds its
        mid-stream stall (the seed's ``appendleft`` semantics)."""
        q = self.queue
        if front or not q:
            q.appendleft(r) if front else q.append(r)
            return
        key = (r.arrival_s, r.rid)
        if (q[-1].arrival_s, q[-1].rid) <= key:
            q.append(r)
            return
        i = len(q)
        while i > 0 and (q[i - 1].arrival_s, q[i - 1].rid) > key:
            i -= 1
        q.insert(i, r)

    def _slack(self, r: Request) -> float:
        """Deadline slack in seconds: time to the class's first-token target
        minus an estimated service time — least slack schedules first.
        Starvation-bounded aging: once an ageing-class request has waited
        past ``age_after_s``, its slack shrinks ``aging_rate``x faster than
        real time, so it monotonically overtakes fresh interactive work."""
        slo = self._slo(r)
        est = self.cost.prefill_time(max(r.prefill_remaining, 1))
        slack = (r.arrival_s + slo.ttft_slo_s) - self.now - est
        if slo.age_after_s > 0:
            over = (self.now - r.arrival_s) - slo.age_after_s
            if over > 0:
                r.aged = True
                slack -= over * slo.aging_rate
        return slack

    def _class_key(self, r: Request):
        """Preemption-victim ordering: background first (largest TTFT
        target), interactive last; within a class, latest arrival (highest
        rid) first — for single-class traffic this is exactly the seed's
        highest-rid victim selection."""
        return (self._slo(r).ttft_slo_s, r.rid)

    def _relief_headroom(self) -> bool:
        """True while morphing can still relieve pressure (a deeper swap
        level remains, or a relief swap is in flight) — the admission
        controller defers shedding to the morph ladder until it's spent."""
        if self._pinned_level is not None:
            return False
        return self.actuator.busy or self.controller.can_escalate()

    def _est_queue_delay(self, r: Optional[Request] = None) -> float:
        """CostModel estimate of seconds until the prefill backlog *ahead of*
        ``r`` clears at the live chunk budget, with the running decodes
        sharing every step. "Ahead" follows the admission policy: everything
        already-arrived that outranks ``r`` (earlier arrival under FIFO,
        smaller slack under the deadline scheduler) plus in-flight chunked
        prefills — an interactive request does not wait behind background
        work the scheduler would serve after it. ``r=None`` estimates the
        whole arrived backlog."""
        backlog = sum(q.prefill_remaining for q in self.running
                      if q.state == RState.PREFILLING)
        arrived = [q for q in self.queue
                   if q.arrival_s <= self.now and q is not r]
        if r is None:
            ahead = arrived
        elif self.ec.scheduler == "fifo":
            ahead = [q for q in arrived
                     if (q.arrival_s, q.rid) < (r.arrival_s, r.rid)]
        else:
            sr = self._slack(r)
            ahead = [q for q in arrived
                     if (self._slack(q), q.rid) < (sr, r.rid)]
        backlog += sum(q.prefill_remaining for q in ahead)
        dec = self.decoding
        return self.cost.queue_delay_estimate(
            backlog, self.chunk_budget, len(dec),
            sum(q.context_len for q in dec),
            self.plan.weight_bytes(self.actuator.level))

    def _should_shed(self, r: Request) -> bool:
        """Terminal-shed decision for a never-scheduled request: its class
        deadline is factually unmeetable (even starting now, service alone
        blows it), or the estimated delay behind higher-priority work blows
        it with no morph-relief headroom left to falsify the estimate."""
        slo = self._slo(r)
        deadline = r.arrival_s + slo.deadline_s
        service = self.cost.prefill_time(max(r.prefill_remaining, 1))
        if self.now + service > deadline:
            return True                       # already blown — don't pretend
        if self._relief_headroom():
            return False
        return self.now + self._est_queue_delay(r) + service > deadline

    def _shed(self, r: Request, *, at_submit: bool = False) -> None:
        """Count one terminal SHED outcome. Only never-scheduled QUEUED
        requests are sheddable — a request that already holds delivered
        tokens is past the front door and runs to completion or failure."""
        if r in self.queue:
            self.queue.remove(r)
        r.state = RState.SHED
        self._n_live -= 1
        self.shed += 1
        if at_submit:
            self.shed_at_submit += 1
        else:
            self.shed_at_queue += 1

    def _sweep_blown_deadlines(self) -> None:
        """Shed every arrived, never-scheduled request whose class deadline
        can no longer be met — timely SHED records instead of silent
        timeouts deep in the queue."""
        for r in [q for q in self.queue
                  if q.arrival_s <= self.now and q.state == RState.QUEUED
                  and q.sched_first_s is None]:
            if self._should_shed(r):
                self._shed(r)

    def _admission_order(self) -> List[Request]:
        """This step's admission candidates: arrived requests only (a
        future-dated entry — possible after redispatch/migration interleave
        arrivals — must never stall the prefill budget behind it), in
        arrival order for the FIFO policy or least-slack-first for the
        deadline scheduler."""
        arrived = [r for r in self.queue if r.arrival_s <= self.now]
        if self.ec.scheduler == "fifo" or len(arrived) <= 1:
            return arrived
        return sorted(arrived, key=lambda r: (self._slack(r), r.rid))

    def _free_slot(self) -> Optional[int]:
        for i, r in enumerate(self._slot_req):
            if r is None:
                return i
        return None

    # ------------------------------------------------------------------
    # cross-replica state transfer (drain handoff / failover migration)
    # ------------------------------------------------------------------
    def release_queued(self) -> List[Request]:
        """Evict every queued (not-yet-slot-holding) request and hand it to
        the caller for re-dispatch elsewhere — the drain-handoff entry point.
        The live-counter invariant the watchdog audits stays maintained
        *inside* the engine (this replaces the cluster's private-field
        surgery on ``queue`` / ``all_requests`` / ``_n_live``).

        The hand-off is *normalized* to (arrival_s, rid) order regardless of
        internal queue state (preempted requests ride at the front; past
        redispatch bugs interleaved arrivals), so the receiving dispatcher
        re-dispatches deterministically and a future-dated arrival can
        never end up queued ahead of due work on the destination."""
        out: List[Request] = []
        while self.queue:
            q = self.queue.popleft()
            if q in self.all_requests:
                self.all_requests.remove(q)
            self._n_live -= 1
            out.append(q)
        return sorted(out, key=lambda q: (q.arrival_s, q.rid))

    def export_request_state(self, r: Request) -> Optional[RequestKVState]:
        """Gather a live slot-holder's state to host: scheduling/identity
        metadata plus its paged-KV block contents. Returns None when the
        request holds no exportable device state (not a slot holder, or a
        recurrent-state family whose state lives outside the paged pool) —
        the caller falls back to recompute re-dispatch."""
        if r.slot < 0 or r.state not in (RState.RUNNING, RState.PREFILLING):
            return None
        if self.ec.compute == "real" and self.cfg.family in ("ssm", "hybrid"):
            return None            # per-slot recurrent state is not paged KV
        k = v = None
        if self.ec.compute == "real" and r.block_ids:
            k, v = self.pool.gather_blocks(r.block_ids)
        # quantized blocks travel compressed (no decompress/recompress
        # round trip): positions + codec width + the sidecar payload
        qidx = [i for i, b in enumerate(r.block_ids)
                if b in self.pool.qbits]
        qbits = max((self.pool.qbits[r.block_ids[i]] for i in qidx),
                    default=8)
        qpay = None
        if self.ec.compute == "real" and qidx:
            qpay = self.pool.gather_quant_blocks(
                [r.block_ids[i] for i in qidx])
        return RequestKVState(
            quant_idx=qidx, quant_bits=qbits, quant_payload=qpay,
            cluster_id=r.cluster_id, arrival_s=r.arrival_s,
            prompt=list(r.prompt), generated=list(r.generated),
            max_new_tokens=r.max_new_tokens,
            orig_prompt_len=r.orig_prompt_len,
            orig_max_new_tokens=r.orig_max_new_tokens,
            token_seed=r.token_seed, prefill_pos=r.prefill_pos,
            preemptions=r.preemptions, prefill_chunks=r.prefill_chunks,
            slo_class=r.slo_class, sched_first_s=r.sched_first_s,
            first_token_s=r.first_token_s,
            token_times=list(r.token_times),
            token_levels=list(r.token_levels),
            block_write_levels=list(r.block_write_levels),
            kv_level=self.actuator.level, n_blocks=len(r.block_ids),
            k=k, v=v)

    def import_request_state(self, st: RequestKVState) -> Optional[Request]:
        """Adopt a migrated request: allocate local blocks, scatter the KV
        payload, and resume exactly where the exporter stopped — mid-decode
        (RUNNING) or mid-chunked-prefill (PREFILLING) — with identity,
        timestamps, and TTFT preserved. Returns None when this engine cannot
        take it right now (no free slot, or allocation failed under
        pressure/injected faults); the import is all-or-nothing, so a None
        leaves the engine untouched."""
        slot = self._free_slot()
        if slot is None:
            return None
        ids = self._alloc_blocks(st.n_blocks) if st.n_blocks else []
        if ids is None:
            return None
        r = Request(self._next_rid, st.arrival_s, list(st.prompt),
                    st.max_new_tokens, cluster_id=st.cluster_id,
                    token_seed=st.token_seed,
                    orig_prompt_len=st.orig_prompt_len,
                    orig_max_new_tokens=st.orig_max_new_tokens,
                    slo_class=st.slo_class)
        self._next_rid += 1
        r.sched_first_s = st.sched_first_s
        r.generated = list(st.generated)
        r.prefill_pos = st.prefill_pos
        r.preemptions = st.preemptions
        r.prefill_chunks = st.prefill_chunks
        r.first_token_s = st.first_token_s
        r.token_times = list(st.token_times)
        r.token_levels = list(st.token_levels)
        r.block_write_levels = list(st.block_write_levels)
        r.block_ids = ids
        r.shared_blocks = 0            # migrated blocks are private copies
        r.slot = slot
        r.state = (RState.RUNNING if st.prefill_pos >= len(st.prompt)
                   else RState.PREFILLING)
        if self.ec.compute == "real" and st.k is not None and ids:
            self.pool.scatter_blocks(ids, st.k, st.v)
        if st.quant_idx and ids:
            # blocks arrive (and stay) compressed: scatter the sidecar
            # payload directly, mark, and count at the quantized byte rate
            qids = [ids[i] for i in st.quant_idx]
            if self.ec.compute == "real" and st.quant_payload is not None:
                self.pool.scatter_quant_blocks(qids, st.quant_payload,
                                               bits=st.quant_bits)
            else:
                self.pool.mark_quantized(qids, bits=st.quant_bits)
            self.ledger.quantize_kv(len(qids))
        self._slot_req[slot] = r
        self.all_requests.append(r)
        self._n_live += 1
        return r

    def detach_request(self, r: Request) -> None:
        """Remove a live slot-holder whose state has been migrated out: free
        its blocks locally (the contents were already copied to the
        destination), open the slot, and drop it from this engine's books —
        the importer owns the single live record from here on."""
        self._release_blocks(r, publish=False)
        if r.slot >= 0:
            self._slot_req[r.slot] = None
            r.slot = -1
        if r in self.all_requests:
            self.all_requests.remove(r)
            self._n_live -= 1

    def export_prefix_payload(self, entries):
        """Host copy of cached prefix blocks (replica-crossing prefix-cache
        lookups). Returns ``(k, v, quant_idx, quant_bits, quant)``: blocks
        the quantize-cold tier compressed ride as their codec payload
        (their fp slots hold zeros), so they cross the wire without a
        decompress/recompress round trip. k/v/quant are None in simulated
        compute; ``quant_idx`` still reports which entries are quantized."""
        qidx = [i for i, e in enumerate(entries)
                if e.block_id in self.pool.qbits]
        qbits = max((self.pool.qbits[entries[i].block_id] for i in qidx),
                    default=8)
        if self.ec.compute != "real" or not entries:
            return None, None, qidx, qbits, None
        k, v = self.pool.gather_blocks([e.block_id for e in entries])
        qpay = (self.pool.gather_quant_blocks(
            [entries[i].block_id for i in qidx]) if qidx else None)
        return k, v, qidx, qbits, qpay

    def import_prefix_chain(self, tokens, level, n_blocks: int,
                            k=None, v=None, *, quant_idx=(),
                            quant_bits: int = 8, quant=None,
                            tols=None) -> int:
        """Adopt a peer replica's cached prefix for ``tokens``: allocate
        local blocks, scatter the migrated contents, and extend this
        engine's radix chain so the next admission of this prompt hits
        locally instead of recomputing. ``level`` records the writer's
        swap level on each entry — an int, or a per-block sequence when
        the migrated chain mixes levels (keys are level-independent, so
        mixed-level chains are legal). Quantized blocks land directly via
        their codec payload and stay quantized. Returns the number of
        blocks adopted (0 on pressure/no-op)."""
        cache = self.prefix_cache
        if cache is None or n_blocks <= 0:
            return 0
        levels = (list(level) if isinstance(level, (list, tuple))
                  else [level] * n_blocks)
        keys = cache.chain_keys(tokens, n_blocks)
        start = 0                       # skip blocks already cached here
        while start < n_blocks and keys[start] in cache.entries:
            start += 1
        if start >= n_blocks:
            return 0
        ids = self._alloc_blocks(n_blocks - start)
        if ids is None:
            return 0
        qpos = sorted(i for i in quant_idx if i >= start)
        if self.ec.compute == "real" and k is not None:
            self.pool.scatter_blocks(ids, k[:, start:],
                                     v[:, start:] if v is not None else None)
            if qpos and quant is not None:
                # slice the codec payload down to the adopted suffix
                sel = [j for j, i in enumerate(quant_idx) if i >= start]
                sub = tuple(None if a is None else a[:, sel] for a in quant)
                self.pool.scatter_quant_blocks(
                    [ids[i - start] for i in qpos], sub, bits=quant_bits)
        elif qpos:
            self.pool.mark_quantized([ids[i - start] for i in qpos],
                                     bits=quant_bits)
        if qpos:
            self.ledger.quantize_kv(len(qpos))
        prev_key = keys[start - 1] if start else None
        adopted = 0
        for j, i in enumerate(range(start, n_blocks)):
            if not cache.insert(keys[i], prev_key, ids[j], levels[i],
                                self.now, tol=tols[i] if tols else None):
                self._free_blocks(ids[j:])          # chain broke: stop clean
                break
            adopted += 1
            prev_key = keys[i]
        return adopted

    @property
    def running(self) -> List[Request]:
        """Slot occupants: decoding (RUNNING) + chunk-prefilling requests."""
        return [r for r in self._slot_req if r is not None]

    @property
    def decoding(self) -> List[Request]:
        return [r for r in self._slot_req
                if r is not None and r.state == RState.RUNNING]

    # ------------------------------------------------------------------
    # token-budgeted scheduling (chunked prefill)
    # ------------------------------------------------------------------
    def _can_chunk(self) -> bool:
        if not self.ec.chunked_prefill or self.ec.max_tokens_per_step <= 0:
            return False
        # SSM/hybrid recurrent state is position-exact; real compute keeps
        # the whole-prompt path there (sim has no state to carry).
        return self.ec.compute == "sim" or \
            self.cfg.family not in ("ssm", "hybrid")

    def _prefill_token_budget(self) -> float:
        """Step budget left for prompt tokens after reserving one token for
        every live decode — decode never stalls behind prefill."""
        if self.ec.max_tokens_per_step <= 0:
            return float("inf")
        return max(self.chunk_budget - len(self.decoding), 0)

    def _free_blocks(self, ids: Sequence[int]) -> None:
        """THE engine-side block free: quantized sidecar state is cleared
        before an id returns to the allocator — a realloc must read pure fp
        semantics from the kernels' dequant FMA, never a stale scale/zero.
        The ledger's quantized-block restatement is deferred to the next
        morph tick (``_reconcile_quant_ledger``), which shrinks capacity
        first when the fp restatement would no longer fit the budget."""
        if ids:
            self.pool.clear_quant(ids)
            self.pool.alloc.release(list(ids))

    def _alloc_blocks(self, n: int) -> Optional[List[int]]:
        """Allocator alloc with prefix-cache relief: idle cached prefix
        blocks are reclaimed LRU first (tier 0 — cheaper than preempting a
        live sequence, shrinking live KV, or swapping a layer).

        ``self._alloc_fault`` distinguishes an *injected transient* failure
        (retryable: the allocator still has blocks) from genuine exhaustion,
        so callers can stall-and-retry instead of escalating to preemption."""
        self._alloc_fault = False
        if self.faults is not None and self.faults.alloc_should_fail(self.now):
            self._alloc_fault = True
            return None
        got = self.pool.alloc.alloc(n)
        if got is not None or self.prefix_cache is None:
            return got
        freed = self.prefix_cache.evict_lru(n - self.pool.alloc.n_free)
        if not freed:
            return None
        self._free_blocks(freed)
        return self.pool.alloc.alloc(n)

    def _grow_blocks(self, r: Request, need: int) -> bool:
        """Extend ``r``'s block table to ``need`` blocks, preempting only
        lower-priority slot occupants under memory pressure — lower SLO
        class first (background before batch before interactive), newest
        rid first within a class; for uniform-class traffic this is exactly
        the seed's later-arrived (higher-rid) victim order. Returns False
        when ``r`` must stall this step instead. Transient (injected)
        allocation failures are ridden out with a bounded stall-and-retry
        before they escalate to preemption."""
        while need > len(r.block_ids):
            got = self._alloc_blocks(1)
            if got is None:
                if self._alloc_fault \
                        and r.alloc_retries < self.ec.alloc_retry_limit:
                    r.alloc_retries += 1
                    self.alloc_fault_stalls += 1
                    return False          # stall; retried next step
                cands = [q for q in self.running
                         if self._class_key(q) > self._class_key(r)]
                if not cands:
                    return False
                self._preempt(max(cands, key=self._class_key))
                continue
            r.alloc_retries = 0
            r.block_ids.extend(got)
        return True

    def _schedule_prefill(self):
        """Pick this step's prefill work under the live token budget.

        Chunk continuations (class priority, then oldest rid) come before
        new admissions so started prompts reach their first token early;
        admissions are taken in ``_admission_order`` — arrival order (FIFO
        policy) or least-deadline-slack with starvation-bounded aging — and
        take the whole prompt when it fits the leftover budget, starting a
        chunked prefill otherwise. Under admission control, requests whose
        class deadline is unmeetable are shed terminally before admission
        instead of timing out silently. Returns ``(whole, chunks)`` —
        whole-prompt admissions and ``(request, pos0, chunk_len)`` items."""
        budget = self._prefill_token_budget()
        whole: List[Request] = []
        chunks: List = []
        for r in sorted(self.running, key=self._class_key):
            if budget <= 0:
                break
            if r.state != RState.PREFILLING:
                continue
            clen = int(min(budget, r.prefill_remaining))
            target = r.prefill_pos + clen
            # the completing chunk pre-books the first decode token's block,
            # matching whole-prompt admission (blocks_for(prompt + 1))
            need = self.pool.blocks_for(
                target + 1 if target == r.prompt_len else target)
            if not self._grow_blocks(r, need):
                continue                       # stalled on memory this step
            chunks.append((r, r.prefill_pos, clen))
            budget -= clen
        if self.ec.admission_control:
            self._sweep_blown_deadlines()
        n_admit = 0
        skipped_aged = 0
        for r in self._admission_order():
            if budget <= 0 or n_admit >= self.ec.max_prefills_per_step:
                break
            # a prompt whose decode-time block table can never fit is
            # unservable — fail it terminally instead of parking it at the
            # queue head forever and starving every later arrival (the
            # oversized-prompt head-of-line wedge)
            if self.pool.blocks_for(r.prompt_len + 1) > self.max_nb:
                self.queue.remove(r)
                r.state = RState.FAILED
                self._n_live -= 1
                self.failed += 1
                continue
            slot = self._free_slot()
            if slot is None:
                break
            bs = self.pool.block_size
            cached: List = []
            if self.prefix_cache is not None and r.prompt_len > bs:
                cached = self.prefix_cache.match(
                    r.prompt, self.actuator.level,
                    (r.prompt_len - 1) // bs, self.now)
            if cached:
                # seed the block table with the shared prefix copy-on-write
                # (full blocks, read-only) and start the chunked prefill at
                # the first uncached position
                pos0 = len(cached) * bs
                clen = int(min(budget, r.prompt_len - pos0))
                target = pos0 + clen
                need = self.pool.blocks_for(
                    target + 1 if target == r.prompt_len else target)
                extra = self._alloc_blocks(need - len(cached))
                if extra is None:
                    for e in cached:
                        self.prefix_cache.release(e.block_id, self.now)
                    break                               # memory pressure
                self.queue.remove(r)
                r.slot = slot
                r.block_ids = [e.block_id for e in cached] + extra
                r.shared_blocks = len(cached)
                r.state = RState.PREFILLING
                r.prefill_pos = pos0
                # cross-level hits: chain keys are level-independent, so the
                # matched entries may have been written under another swap
                # level. "adopt" reuses them as-is (the entry's own level and
                # tolerance tag ride on the request); "requant" re-homes a
                # foreign-level entry at the current level by compressing
                # its block through the KV codec (tolerance tag int{bits}).
                lvl_now = self.actuator.level
                qc = self.ec.kv_quant
                if qc.cross_level_mode == "requant" and self._kv_quant_on:
                    newq = [e.block_id for e in cached
                            if e.level != lvl_now
                            and e.block_id not in self.pool.qbits]
                    if newq:
                        if self.ec.compute == "real":
                            self.pool.quantize_blocks(newq, bits=qc.bits)
                        else:
                            self.pool.mark_quantized(newq, bits=qc.bits)
                        self.ledger.quantize_kv(len(newq))
                    for e in cached:
                        if e.level != lvl_now:
                            self.prefix_cache.requantize_entry(
                                e, lvl_now, qc.bits)
                tags = [e.tol for e in cached if e.tol]
                if tags and r.tol is None:
                    r.tol = tags[0]
                # record each shared block under the level its KV was
                # actually computed at, so republication stays truthful
                for j, e in enumerate(cached):
                    r.note_prefill_levels(j * bs, (j + 1) * bs, e.level, bs)
                self._slot_req[slot] = r
                chunks.append((r, pos0, clen))
                budget -= clen
                # hit rate counts distinct requests (a preempted request
                # re-admitted on a hit is still one request); tokens saved
                # accrue per admission — every re-admission hit skips real
                # prefill work again
                if r.rid not in self._prefix_hit_rids:
                    self._prefix_hit_rids.add(r.rid)
                    self.prefix_hit_requests += 1
                self.prefill_tokens_saved += pos0
            elif r.prompt_len <= budget or not self._can_chunk():
                nb = self.pool.blocks_for(r.prompt_len + 1)
                ids = self._alloc_blocks(nb)
                if ids is None:
                    break                               # memory pressure
                self.queue.remove(r)
                r.slot, r.block_ids, r.state = slot, ids, RState.RUNNING
                r.prefill_pos = r.prompt_len
                self._slot_req[slot] = r
                whole.append(r)
                budget -= r.prompt_len
            else:
                clen = int(budget)
                ids = self._alloc_blocks(self.pool.blocks_for(clen))
                if ids is None:
                    break
                self.queue.remove(r)
                r.slot, r.block_ids, r.state = slot, ids, RState.PREFILLING
                r.prefill_pos = 0
                self._slot_req[slot] = r
                chunks.append((r, 0, clen))
                budget -= clen
            # starvation audit: admitting past a live aged candidate would
            # be a bypass. The loop admits strictly in priority order and
            # *breaks* (never skips) on slot/memory shortage, so this stays
            # zero by construction — CI gates that it does.
            self.starvation_bypasses += skipped_aged
            if r.sched_first_s is None:
                r.sched_first_s = self.now
            n_admit += 1
        return whole, chunks

    def _exec_prefill(self, whole: List[Request], chunks) -> List[Request]:
        """Run the scheduled prefill work. First tokens are appended here
        (so the same-step decode consumes them, seed semantics); timestamps
        are assigned by ``step()`` once the unified step time is known.
        Returns the requests that produced their first token."""
        emitted: List[Request] = []
        lvl = self.actuator.level
        bs = self.pool.block_size
        if whole:
            if self.ec.compute == "real":
                firsts = self._prefill_real_many(whole)
            else:
                firsts = [self._sim_token(r) for r in whole]
            for r, first in zip(whole, firsts):
                r.generated.append(first)
                r.note_prefill_levels(0, r.prompt_len, lvl, bs)
                emitted.append(r)
        for r, pos0, clen in chunks:
            if r.state != RState.PREFILLING:
                continue                        # preempted after scheduling
            first = None
            if self.ec.compute == "real":
                first = self._prefill_chunk_real(r, clen)
            r.prefill_pos += clen
            r.prefill_chunks += 1
            r.note_prefill_levels(pos0, pos0 + clen, lvl, bs)
            if r.prefill_pos == r.prompt_len:
                if first is None:               # sim compute
                    first = self._sim_token(r)
                r.state = RState.RUNNING
                r.generated.append(first)
                emitted.append(r)
        return emitted

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        """A host int32 array as a tensor on the engine's device."""
        return torch.from_numpy(a).to(self.device)

    def _prefill_chunk_real(self, r: Request, clen: int) -> Optional[int]:
        """One chunk call: causal attention of prompt[pos0:pos0+clen]
        against the already-paged context, KV appended in the same call.
        Chunk length and table width are power-of-two bucketed (bounded
        recompile set). Returns the first generated token when the chunk
        completes the prompt, else None."""
        bs = self.pool.block_size
        pos0 = r.prefill_pos
        Cp = model_exec.pad_bucket(clen, bs)
        nb_t = model_exec.pad_bucket(self.pool.blocks_for(pos0 + Cp), 1)
        toks = np.zeros((1, Cp), np.int32)
        toks[0, :clen] = r.prompt[pos0:pos0 + clen]
        table = np.zeros((nb_t,), np.int32)
        ids = r.block_ids[:nb_t]
        table[:len(ids)] = ids
        logits = self.exec.prefill_chunk(
            self.actuator.layer_list(), self._dev(toks), pos0,
            self.pool.k, self.pool.v, self._dev(table),
            self.pool.kv_quant_bundle())
        if pos0 + clen == r.prompt_len:
            return int(torch.argmax(logits[clen - 1]))
        return None

    def _prefill_real_many(self, admitted: List[Request]) -> List[int]:
        """Prefill admitted requests: one batched call at a shared
        bucketed length for attention/MLA families; SSM/hybrid state is
        position-exact, so those fall back to the per-request path."""
        if (not self.ec.batch_prefill or len(admitted) == 1
                or self.cfg.family in ("ssm", "hybrid")):
            return [self._prefill_real(r) for r in admitted]
        bs = self.pool.block_size
        P = self.ec.max_prefills_per_step      # fixed batch dim (one trace)
        Sp = model_exec.pad_bucket(max(r.prompt_len for r in admitted), bs)
        nb_p = Sp // bs
        toks = np.zeros((P, Sp), np.int32)
        tables = np.zeros((P, nb_p), np.int32)
        lens = np.ones((P,), np.int32)
        for i, r in enumerate(admitted):
            toks[i, :r.prompt_len] = r.prompt
            ids = r.block_ids[:nb_p]
            tables[i, :len(ids)] = ids
            lens[i] = r.prompt_len
        last = self.exec.prefill_batch(
            self.actuator.layer_list(), self._dev(toks),
            self.pool.k, self.pool.v, self._dev(tables), self._dev(lens))
        toks_out = torch.argmax(last, dim=-1).cpu().numpy()
        return [int(toks_out[i]) for i in range(len(admitted))]

    def _prefill_real(self, r: Request) -> int:
        bs = self.pool.block_size
        nb_alloc = len(r.block_ids)
        # SSM/hybrid state is position-exact: end-padding would pollute the
        # recurrent state, so those families prefill at exact length (the
        # KV payload is padded to block alignment inside paged_prefill).
        if self.cfg.family in ("ssm", "hybrid"):
            Sp = r.prompt_len
        else:
            Sp = max(nb_alloc * bs, r.prompt_len)
        toks = np.zeros((1, Sp), np.int32)
        toks[0, :r.prompt_len] = r.prompt
        ids = self._dev(np.asarray(r.block_ids, np.int32))
        logits = self.exec.prefill(self.actuator.layer_list(),
                                   self._dev(toks), self.pool.k, self.pool.v,
                                   ids, self.ssm_conv, self.ssm_ssm, r.slot)
        return int(torch.argmax(logits[r.prompt_len - 1]))

    # ------------------------------------------------------------------
    def _ensure_decode_blocks(self) -> List[Request]:
        """Allocate the next block for sequences crossing a block boundary;
        preempt (recompute policy) when the pool is exhausted. A *transient*
        (injected) allocation failure instead stalls the request for this
        step — it skips decode (no KV slot for the next token), keeps its
        state, and retries next step; only after ``alloc_retry_limit``
        consecutive misses does it escalate to the preemption path. Returns
        the stalled requests."""
        stalled: List[Request] = []
        # class priority order: interactive sequences secure their next
        # block first, so under exhaustion the victim pool still contains
        # every lower class (uniform-class: exact seed rid order)
        for r in sorted(self.running, key=self._class_key):
            if r.state != RState.RUNNING:
                continue          # preempted by an earlier victim selection
            need = self.pool.blocks_for(r.context_len + 1)
            while need > len(r.block_ids):
                got = self._alloc_blocks(1)
                if got is None:
                    if self._alloc_fault \
                            and r.alloc_retries < self.ec.alloc_retry_limit:
                        r.alloc_retries += 1
                        self.alloc_fault_stalls += 1
                        stalled.append(r)
                        break
                    # evict the lowest-priority slot holder: background
                    # before batch before interactive, newest rid within a
                    # class — interactive is preempted only by interactive
                    victim = max(self.running, key=self._class_key)
                    self._preempt(victim)
                    if victim is r:
                        break
                    continue
                r.alloc_retries = 0
                r.block_ids.extend(got)
        return stalled

    def _release_blocks(self, r: Request, *, publish: bool) -> None:
        """Return ``r``'s blocks. Shared prefix blocks drop a cache
        reference (they stay resident); with ``publish``, the request's own
        full prompt blocks are handed to the prefix cache instead of being
        freed — extending the radix chain of the shared prefix — and only
        the remainder (partial/decode blocks, duplicates, mixed-level
        blocks) goes back to the allocator."""
        ids, r.block_ids = r.block_ids, []
        n_shared, r.shared_blocks = r.shared_blocks, 0
        cache = self.prefix_cache
        if cache is None:
            self._free_blocks(ids)
            return
        free: List[int] = []
        for b in ids[:n_shared]:
            if not cache.release(b, self.now):
                free.append(b)               # defensive: not actually cached
        published: set = set()
        if publish:
            bs = self.pool.block_size
            levels = r.block_write_levels
            n_full = min(r.prompt_len // bs, len(ids), len(levels))
            prev_key = None
            for i in range(n_full):
                # chain keys are level-independent, so a chain survives a
                # morph transition mid-prompt — each entry records its own
                # write level (and tolerance tag) for the hit-side policy.
                # Only a mixed/unwritten block ends the publishable chain.
                lv = levels[i]
                if lv is None or lv < 0:
                    break
                key = cache.chain_key(prev_key, r.prompt[i * bs:(i + 1) * bs])
                # a block held quantized at publish time carries its codec
                # width as the entry's tolerance tag; a request that itself
                # adopted approximate KV propagates its tag
                tol = (f"int{self.pool.qbits[ids[i]]}"
                       if ids[i] in self.pool.qbits else r.tol)
                # shared blocks are already cached and just anchor the
                # chain; private full prompt blocks extend it (a failed
                # insert means a concurrent duplicate won — free ours)
                if i >= n_shared and cache.insert(key, prev_key, ids[i],
                                                  lv, self.now, tol=tol):
                    published.add(i)
                prev_key = key
        free.extend(b for i, b in enumerate(ids)
                    if i >= n_shared and i not in published)
        self._free_blocks(free)

    def _preempt(self, r: Request) -> None:
        # no publish under pressure: retaining blocks is the opposite of
        # relief, and a partial prefill may hold half-written blocks
        self._release_blocks(r, publish=False)
        self._slot_req[r.slot] = None
        r.slot = -1
        r.preemptions += 1
        # recompute policy: generated tokens are folded into the prompt and
        # a partial chunked prefill restarts from scratch (blocks are gone)
        r.prompt = r.prompt + r.generated
        r.max_new_tokens -= len(r.generated)
        r.generated = []
        r.prefill_pos = 0
        r.block_write_levels = []
        # livelock cap: a request that keeps getting evicted and re-prefilled
        # is burning pool + compute for everyone — past the cap it terminates
        # as FAILED (an SLO violation) instead of cycling forever
        if 0 < self.ec.max_preemptions < r.preemptions:
            r.state = RState.FAILED
            self._n_live -= 1
            self.failed += 1
            self.livelock_failures += 1
            return
        r.state = RState.PREEMPTED
        self._enqueue(r, front=True)

    def _decode_real(self, run: List[Request]) -> None:
        bs = self.pool.block_size
        # truncate block tables to the power-of-two bucket of the live max:
        # gather cost tracks the live context, recompiles stay bounded
        # (log2(max_nb) table widths).
        nb_t = self.max_nb
        if self.ec.decode_nb_bucketing:
            live_nb = max((len(r.block_ids) for r in run), default=1)
            nb_t = min(model_exec.pad_bucket(max(live_nb, 1), 1), self.max_nb)
        tokens = np.zeros((self.slots, 1), np.int32)
        pos = np.zeros((self.slots,), np.int32)
        tables = np.zeros((self.slots, nb_t), np.int32)
        for r in run:
            tokens[r.slot, 0] = r.generated[-1]
            # generated[-1] is already counted in context_len, so its
            # absolute index (RoPE position + KV append slot) is one less.
            pos[r.slot] = r.context_len - 1
            ids = r.block_ids[:nb_t]
            tables[r.slot, :len(ids)] = ids
        logits = self.exec.decode(self.actuator.layer_list(),
                                  self._dev(tokens), self._dev(pos),
                                  self.pool.k, self.pool.v, self._dev(tables),
                                  self.ssm_conv, self.ssm_ssm,
                                  self.pool.kv_quant_bundle())
        toks = torch.argmax(logits, dim=-1).cpu().numpy()
        for r in run:
            r.generated.append(int(toks[r.slot]))

    def _finish(self, r: Request, t: float) -> None:
        r.state = RState.FINISHED
        self._n_live -= 1
        r.finish_s = t
        # full prompt blocks are published to the prefix cache (resident,
        # refcounted, LRU-evictable) instead of freed
        self._release_blocks(r, publish=True)
        self._slot_req[r.slot] = None
        r.slot = -1

    # ------------------------------------------------------------------
    # morphing control
    # ------------------------------------------------------------------
    def _live_kv_blocks(self) -> int:
        """Blocks held by live sequences — idle cached prefix blocks are
        reclaimable on demand, so the resizer must not treat them as live."""
        n = self.pool.alloc.n_used
        if self.prefix_cache is not None:
            n -= self.prefix_cache.evictable_blocks
        return n

    def _compact_tail(self, limit: int) -> bool:
        """Migrate every allocated block with id >= ``limit`` into a free id
        below it, rewriting live block tables and the prefix-cache index
        (one device gather/scatter for the moved blocks in real compute).

        Without this, an elastic shrink needs the pool tail to drain
        naturally — but decodes admitted at the pressure peak hold high ids
        until they finish, which wedged the restore path (and with it the
        swap level) at max for the rest of a trace."""
        alloc = self.pool.alloc
        holders = [r for r in self._slot_req if r is not None]
        cache = self.prefix_cache
        doomed = set()
        for r in holders:
            doomed.update(b for b in r.block_ids if b >= limit)
        if cache is not None:
            doomed.update(b for b in cache.by_block if b >= limit)
        if not doomed:
            return True
        free_low = alloc.lowest_free(limit, len(doomed))
        if len(free_low) < len(doomed):
            return False                     # not enough room below the cut
        src = sorted(doomed)
        mapping = dict(zip(src, free_low))
        for r in holders:
            r.block_ids = [mapping.get(b, b) for b in r.block_ids]
        if cache is not None:
            moved = [e for e in cache.by_block.values()
                     if e.block_id in mapping]
            for e in moved:
                del cache.by_block[e.block_id]
                e.block_id = mapping[e.block_id]
                cache.by_block[e.block_id] = e
        alloc.exchange(free_low, src)
        if self.ec.compute == "real":
            # one in-place device gather/scatter for the moved blocks; the
            # quantized payload and sidecar ride the move and the vacated
            # rows' scale/zero are zeroed
            self.pool.move_blocks(src, [mapping[b] for b in src])
        for s in src:
            if s in self.pool.qbits:
                self.pool.qbits[mapping[s]] = self.pool.qbits.pop(s)
        self.compaction_moves += len(src)
        return True

    def _shrink_pool(self, new_blocks: int) -> Optional[int]:
        """Pool shrink with tier ordering: idle cached prefixes squatting on
        the doomed tail are evicted first, live blocks up there are
        compacted below the cut (or, failing that, clamp the target to a
        *partial* shrink) instead of wedging the shrink entirely. Returns
        the logical block count actually applied, or None when no shrink
        was possible this tick."""
        if self.prefix_cache is not None:
            freed = self.prefix_cache.evict_block_ids_at_or_above(
                new_blocks + 1)
            if freed:
                self._free_blocks(freed)
        if self.pool.alloc.shrinkable_to() > new_blocks + 1:
            self._compact_tail(new_blocks + 1)
        new_blocks = self.resizer.clamp_to_tail(
            new_blocks, self.pool.alloc.shrinkable_to() - 1)
        if new_blocks >= self.ledger.kv_blocks:
            return None
        if not self.pool.resize(new_blocks + 1):
            return None
        return new_blocks

    # --- quantize-cold tier (tier 1: between prefix eviction and live
    # shrink) ----------------------------------------------------------
    def _quant_candidates(self, limit: Optional[int] = None) -> List[int]:
        """Cold-but-live blocks eligible for in-place compression: private
        (non-shared) *full* blocks of slot holders, stalest request first,
        never a sequence's last ``keep_tail_blocks`` full blocks (decode
        re-reads the tail hottest, and the partially-written head block is
        still being appended to). Capped by ``max_quant_frac`` of the
        allocated pool and by ``limit``."""
        qc = self.ec.kv_quant
        if not self._kv_quant_on:
            return []
        budget = int(qc.max_quant_frac * self.pool.alloc.n_used) \
            - len(self.pool.qbits)
        if limit is not None:
            budget = min(budget, limit)
        if budget <= 0:
            return []
        bs = self.pool.block_size

        def staleness(r):
            return r.token_times[-1] if r.token_times else r.arrival_s

        out: List[int] = []
        for r in sorted(self.running, key=staleness):
            written = (r.prefill_pos if r.state == RState.PREFILLING
                       else r.context_len)
            n_full = min(written // bs, len(r.block_ids))
            hi = n_full - max(qc.keep_tail_blocks, 0)
            for b in r.block_ids[r.shared_blocks:hi]:
                if b in self.pool.qbits:
                    continue
                out.append(b)
                if len(out) >= budget:
                    return out
        return out

    def _quant_headroom(self) -> int:
        """How many more blocks the quantize-cold tier could compress right
        now — the controller escalates past this tier only once it reads 0."""
        return len(self._quant_candidates())

    def _dequant_account(self, n: int) -> None:
        """Restate ``n`` quantized blocks at fp bytes in the ledger. When
        the restatement no longer fits the budget (the pool grew into the
        quantization relief), capacity is shrunk to fit first; a partial
        shrink leaves the ledger transiently over budget for the watchdog's
        existing shrink-to-fit repair."""
        if n <= 0:
            return
        self.ledger.kv_quant_blocks -= n
        if self.ledger.ok():
            return
        fit = max(self.ledger.max_kv_blocks(),
                  self.ledger.kv_quant_blocks, 1)
        if fit < self.ledger.kv_blocks:
            applied = self._shrink_pool(fit)
            if applied is not None:
                self.ledger.kv_blocks = applied
                self.resize_log.append((self.now, applied))

    def _reconcile_quant_ledger(self) -> None:
        """Deferred accounting for quantized blocks freed since the last
        tick (``_free_blocks`` clears data-plane state immediately but
        leaves the bytes restatement to this choke point)."""
        drift = self.ledger.kv_quant_blocks - len(self.pool.qbits)
        if drift > 0:
            self._dequant_account(drift)
        elif drift < 0:                  # impossible by construction
            self.ledger.kv_quant_blocks = len(self.pool.qbits)

    def _quantize_cold(self) -> int:
        """Execute one paced quantize batch: compress the coldest eligible
        blocks through the codec (sim marks accounting only), restate their
        ledger bytes at the quantized rate, and charge the actuator's
        modeled copy time. Returns blocks compressed."""
        qc = self.ec.kv_quant
        if self.quant_actuator.busy(self.now):
            return 0
        cand = self._quant_candidates(limit=max(qc.batch_blocks, 1))
        if not cand:
            return 0
        if self.ec.compute == "real":
            done = self.pool.quantize_blocks(cand, bits=qc.bits)
        else:
            done = self.pool.mark_quantized(cand, bits=qc.bits)
        if done:
            self.ledger.quantize_kv(len(done))
            self.quant_actuator.issue("quantize", len(done), self.now)
            self.kv_quant_events.append((self.now, "quantize", len(done)))
        return len(done)

    def _dequantize_restore(self) -> int:
        """Execute one paced dequantize batch (calm, level 0): shrink
        capacity out of the relief first when the fp restatement wouldn't
        fit, then restore the blocks to fp in place. Returns blocks
        restored (0 when the shrink couldn't fund the batch this tick)."""
        qc = self.ec.kv_quant
        if self.quant_actuator.busy(self.now):
            return 0
        batch = sorted(self.pool.qbits)[:max(qc.batch_blocks, 1)]
        if not batch:
            return 0
        n = len(batch)
        self.ledger.kv_quant_blocks -= n     # probe the fp restatement
        fits = self.ledger.ok()
        fit = max(self.ledger.max_kv_blocks(), 1) if not fits else 0
        self.ledger.kv_quant_blocks += n
        if not fits:
            fit = max(fit, self.ledger.kv_quant_blocks)
            applied = self._shrink_pool(fit) \
                if fit < self.ledger.kv_blocks else None
            if applied is not None:
                self.ledger.resize_kv(applied)
                self.resize_log.append((self.now, applied))
            self.ledger.kv_quant_blocks -= n
            fits = self.ledger.ok()
            self.ledger.kv_quant_blocks += n
            if not fits:
                return 0                     # retry next tick as tail drains
        if self.ec.compute == "real":
            self.pool.dequantize_blocks(batch)
        else:
            self.pool.mark_dequantized(batch)
        self.ledger.dequantize_kv(n)
        self.quant_actuator.issue("dequantize", n, self.now)
        self.kv_quant_events.append((self.now, "dequantize", n))
        return n

    def _morph_tick(self) -> None:
        # deferred quant accounting runs even for pinned-level policies —
        # freed quantized blocks (imports, requant-on-hit) must restate
        self._reconcile_quant_ledger()
        if self._pinned_level is not None:
            return
        level_changed = self.actuator.poll(self.now)
        if level_changed:
            self.controller.commit(self.actuator.level)
            self.ledger.set_weights(self.actuator.weight_bytes())
        sig = self.monitor.signals()
        sig["time_s"] = self.now
        if self.ec.max_tokens_per_step > 0:
            sig["chunk_budget_frac"] = (self.chunk_budget
                                        / self.ec.max_tokens_per_step)
        # tier 0 relief: under KV pressure, evict idle cached prefixes LRU
        # down to the low watermark BEFORE the controller considers
        # shrinking live KV or issuing a relief swap — reclaiming a cached
        # block costs one future prefill at most, never a live sequence.
        cap = max(self.pool.num_blocks - 1, 1)
        if (self.prefix_cache is not None
                and sig["kv_usage"] > self.controller.high_watermark()):
            excess = (self.pool.alloc.n_used
                      - int(cap * self.sc.kv_pressure_low))
            if excess > 0:
                freed = self.prefix_cache.evict_lru(excess)
                if freed:
                    # through the one engine-side free, which clears a
                    # quantized block's sidecar state before the allocator
                    # can hand it out again (the JAX engine releases these
                    # directly, so a re-allocated quantized block keeps its
                    # scale/zero and the kernels' FMA adds the stale payload
                    # to the new owner's KV)
                    self._free_blocks(freed)
                    self.prefix_evicted_for_pressure += len(freed)
                    # reflect the relief immediately (the EWMA lags): only
                    # residual pressure should escalate to tiers 2/3
                    sig["kv_usage"] = min(sig["kv_usage"],
                                          self.pool.alloc.n_used / cap)
        # tier 1 signals: the controller defers level escalation while the
        # quantize-cold tier still has eligible blocks, and orders the fp
        # restore (calm, level 0) while any block is still compressed
        sig["quant_blocks"] = float(len(self.pool.qbits))
        sig["quant_headroom"] = float(self._quant_headroom())
        cmd = self.controller.decide(sig)
        # third actuator: the admission token budget reacts instantly (no
        # transfer latency). It backs off prefill pressure only while a
        # relief swap is still in flight and restores as soon as the swap
        # lands or pressure drains — sustained load is served at full
        # budget (a permanently shrunk budget just trades TTFT away, see
        # BENCH_serving.json).
        if self.ec.max_tokens_per_step > 0:
            nb = self.chunk_budget
            if cmd is not None and cmd.shrink_chunk and self.actuator.busy:
                nb = max(self.ec.min_chunk_tokens, self.chunk_budget // 2)
            elif (cmd is not None and cmd.grow_chunk) \
                    or not self.actuator.busy:
                nb = min(self.ec.max_tokens_per_step, self.chunk_budget * 2)
            if nb != self.chunk_budget:
                self.chunk_budget = nb
                self.chunk_log.append((self.now, nb))
        if cmd is None:
            return
        # tier 1 execution: compress a paced batch of cold blocks (the
        # grow_kv below converts the ledger relief into pool capacity the
        # same tick), or restore a paced batch to fp on the calm path
        if cmd.quantize_kv:
            self._quantize_cold()
        if cmd.dequantize_kv and self.actuator.level == 0:
            self._dequantize_restore()
        if cmd.target_level > self.actuator.level and not self.actuator.busy:
            self.actuator.issue(cmd.target_level, self.now)
        if cmd.grow_kv:
            # grow only against *committed* (already-freed) weight bytes —
            # and never into the space an in-flight restore (a swap toward
            # heavier weights) is about to take back
            wb_grow = self.ledger.weight_bytes
            tgt = self.actuator.inflight_target
            if tgt is not None:
                wb_grow = max(wb_grow, self.plan.weight_bytes(tgt))
            dec = self.resizer.grow(weight_bytes=wb_grow,
                                    live_blocks=self._live_kv_blocks())
            if dec is not None:
                self.ledger.resize_kv(dec.new_blocks)
                self.pool.resize(dec.new_blocks + 1)
                self.resize_log.append((self.now, dec.new_blocks))
        if cmd.target_level < self.actuator.level and not self.actuator.busy:
            # shrink pool first if the restored weights wouldn't fit; a
            # busy tail yields a partial shrink and the restore retries
            # next tick as the tail frees (never wedges at max level)
            wb_restored = self.plan.weight_bytes(cmd.target_level)
            if not self.resizer.fits_restore(
                    weight_bytes_restored=wb_restored):
                dec = self.resizer.shrink(
                    weight_bytes=wb_restored,
                    live_blocks=self._live_kv_blocks())
                if dec is not None:
                    applied = self._shrink_pool(dec.new_blocks)
                    if applied is not None:
                        self.ledger.resize_kv(applied)
                        self.resize_log.append((self.now, applied))
            if self.resizer.fits_restore(weight_bytes_restored=wb_restored):
                self.actuator.issue(cmd.target_level, self.now)
        elif cmd.shrink_kv and self.actuator.level == 0:
            dec = self.resizer.shrink(weight_bytes=self.ledger.weight_bytes,
                                      live_blocks=self._live_kv_blocks())
            if dec is not None:
                applied = self._shrink_pool(dec.new_blocks)
                if applied is not None:
                    self.ledger.resize_kv(applied)
                    self.resize_log.append((self.now, applied))

    # ------------------------------------------------------------------
    # step-loop invariant watchdog (graceful degradation, not crashes)
    # ------------------------------------------------------------------
    def _watchdog_trip(self, kind: str, detail: str) -> None:
        self.watchdog_trips.append((self.now, kind, detail))

    def _quarantine(self, r: Request, safe_ids: List[int]) -> None:
        """Terminally fail a request whose block table is corrupt: release
        only the provably-private, vetted blocks and leak the dubious ones
        (a bounded leak degrades gracefully; a double-free corrupts another
        sequence), then free the slot."""
        if safe_ids:
            self._free_blocks(safe_ids)
        r.block_ids = []
        r.shared_blocks = 0
        if r.slot >= 0:
            self._slot_req[r.slot] = None
            r.slot = -1
        r.state = RState.FAILED
        self._n_live -= 1
        self.failed += 1

    def _rebuild_prefix_cache(self) -> None:
        """Reconstruct the prefix cache from ground truth: drop entries on
        free or dangling blocks, then recompute refcounts from live shared
        regions and children counts from parent links. Dropped blocks no
        live request reads go back to the allocator."""
        cache = self.prefix_cache
        free = self.pool.alloc.free_ids()
        dropped: set = set()
        changed = True
        while changed:
            changed = False
            for e in list(cache.entries.values()):
                if e.block_id in free or (
                        e.parent_key is not None
                        and e.parent_key not in cache.entries):
                    del cache.entries[e.key]
                    if e.block_id not in free:
                        dropped.add(e.block_id)
                    changed = True
        cache.by_block = {e.block_id: e for e in cache.entries.values()}
        refs: Dict[int, int] = {}
        for r in self.running:
            for b in r.block_ids[:r.shared_blocks]:
                refs[b] = refs.get(b, 0) + 1
        kids: Dict[int, int] = {}
        for e in cache.entries.values():
            e.ref = refs.get(e.block_id, 0)
            if e.parent_key is not None:
                kids[e.parent_key] = kids.get(e.parent_key, 0) + 1
        for e in cache.entries.values():
            e.children = kids.get(e.key, 0)
        # a dropped block still read by a live holder must stay resident;
        # everything else is reclaimable
        self._free_blocks([b for b in dropped if not refs.get(b)])

    def _check_invariants(self) -> None:
        """Cross-check the accounting the step loop depends on and repair
        violations in place — a corrupt request fails terminally, desynced
        counters resync — so an injected fault (or a latent bug) degrades
        the trace instead of crashing it."""
        # 0. quantized-block accounting: a pending fp restatement is
        # routine deferred work (frees since the last morph tick), but an
        # under-count — ledger says fewer quantized blocks than the pool
        # holds — is real corruption and resyncs to the pool's ground truth
        if self.ledger.kv_quant_blocks != len(self.pool.qbits):
            drift = self.ledger.kv_quant_blocks - len(self.pool.qbits)
            if drift > 0:
                self._dequant_account(drift)
            else:
                self._watchdog_trip(
                    "quant_ledger",
                    f"ledger={self.ledger.kv_quant_blocks} "
                    f"pool={len(self.pool.qbits)}")
                self.ledger.kv_quant_blocks = len(self.pool.qbits)
                self.watchdog_repairs += 1
        # 1. ledger <-> pool accounting must agree and fit the budget
        if (self.ledger.kv_blocks != self.pool.num_blocks - 1
                or not self.ledger.ok()):
            self._watchdog_trip(
                "ledger_pool_mismatch",
                f"ledger={self.ledger.kv_blocks} "
                f"pool={self.pool.num_blocks - 1}")
            self.ledger.kv_blocks = self.pool.num_blocks - 1
            if not self.ledger.ok():
                fit = max(self.ledger.max_kv_blocks(), 1)
                applied = self._shrink_pool(fit)
                self.ledger.kv_blocks = (applied if applied is not None
                                         else self.pool.num_blocks - 1)
            self.watchdog_repairs += 1
        # 2. block tables: bounds, free-list overlap, private ownership
        free = self.pool.alloc.free_ids()
        owners: set = set()
        for r in list(self.running):
            bad = None
            safe: List[int] = []
            for j, b in enumerate(r.block_ids):
                if not (0 < b < self.pool.num_blocks):
                    bad = f"block {b} out of bounds"
                elif b in free:
                    bad = f"block {b} on free list"
                elif j >= r.shared_blocks:
                    if b in owners:
                        bad = f"block {b} double-owned"
                    else:
                        owners.add(b)
                        if (self.prefix_cache is None
                                or b not in self.prefix_cache.by_block):
                            safe.append(b)
                if bad is not None:
                    break
            if bad is not None:
                self._watchdog_trip("block_table", f"rid={r.rid}: {bad}")
                for b in r.block_ids[:r.shared_blocks]:
                    if self.prefix_cache is not None:
                        self.prefix_cache.release(b, self.now)
                self._quarantine(r, safe)
                self.watchdog_repairs += 1
        # 3. prefix-cache refcounts / chain topology
        if self.prefix_cache is not None:
            try:
                self.prefix_cache.check(self.pool.alloc)
            except AssertionError as e:
                self._watchdog_trip("prefix_cache", str(e))
                self._rebuild_prefix_cache()
                self.watchdog_repairs += 1
        # 4. live-request counter (run_trace's O(1) liveness check)
        live = len(self.queue) + len(self.running)
        if self._n_live != live:
            self._watchdog_trip("n_live", f"{self._n_live} != {live}")
            self._n_live = live
            self.watchdog_repairs += 1

    # ------------------------------------------------------------------
    def step(self) -> float:
        """One token-budgeted engine iteration; returns elapsed virtual time.

        Packs up to ``chunk_budget`` tokens: every live decode token first,
        the remainder prompt chunks — one mixed batch per step, so decode
        throughput is never head-of-line blocked behind a long prompt and
        queued requests' TTFT follows the chunk budget, not the longest
        prompt in front of them."""
        dec0 = [(r, len(r.generated), r.preemptions) for r in self.decoding]
        whole, chunks = self._schedule_prefill()
        emitted = self._exec_prefill(whole, chunks)
        pf_tokens = sum(r.prompt_len for r in whole) + \
            sum(c for _, _, c in chunks)
        # causal (q, kv) score pairs + paged context the chunks re-read
        pf_pairs = sum(r.prompt_len ** 2 / 2 for r in whole) + \
            sum(c * p0 + c * c / 2 for _, p0, c in chunks)
        pf_kv = sum(p0 + c for _, p0, c in chunks)
        dec = self.decoding
        stalled_rids: set = set()
        if dec:
            stalled = self._ensure_decode_blocks()
            stalled_rids = {r.rid for r in stalled}
            # a request stalled on a transient allocation fault has no KV
            # slot for its next token: it skips this decode and retries
            # next step (bounded by alloc_retry_limit before preemption)
            dec = [r for r in self.decoding if r.rid not in stalled_rids]
        if dec:
            if self.ec.compute == "real":
                self._decode_real(dec)
            else:
                for r in dec:
                    r.generated.append(self._sim_token(r))
        lvl = self.actuator.level
        if dec or pf_tokens:
            total_ctx = sum(r.context_len for r in dec)
            dt = self.cost.mixed_step_time(
                len(dec), total_ctx, pf_tokens, pf_pairs, pf_kv,
                self.plan.weight_bytes(lvl))
        else:
            dt = 1e-3                                   # idle tick
        if self.faults is not None:
            dt *= self.faults.step_time_factor(self.now)  # injected spike
        t = self.now + dt
        for r in emitted:
            # prefill (whole or final chunk) emits the first token — unless
            # same-step memory pressure (_grow_blocks/_ensure_decode_blocks)
            # preempted the request after it emitted: its token was folded
            # back into the prompt for recompute, so stamping times/levels
            # or recording TTFT here would log a phantom token
            if r.state != RState.RUNNING:
                continue
            if r.first_token_s is None:
                # a re-emission after preemption keeps the original TTFT
                # (the first token really was delivered back then)
                r.first_token_s = t
                self.monitor.record_ttft(t - r.arrival_s)
            r.token_times.append(t)
            r.token_levels.append(lvl)
        for r in dec:
            r.token_times.append(t)
            r.token_levels.append(lvl)
            if r.done:
                self._finish(r, t)
        self.now = t
        # liveness accounting: a request decoding at step start must have
        # produced a token (or been evicted) whenever prefill ran beside it
        if pf_tokens and dec0:
            self.mixed_steps += 1
            # an injected-fault stall is chaos doing its job, not a
            # scheduler liveness bug — exclude it from the gated counter
            if any(r.preemptions == p and len(r.generated) <= n
                   for r, n, p in dec0 if r.rid not in stalled_rids):
                self.decode_stall_steps += 1
        oldest = min((r.arrival_s for r in self.queue
                      if r.arrival_s <= self.now), default=None)
        # class-weighted queue pressure: interactive waits count at full
        # weight, offline classes discounted — with an all-interactive
        # queue this equals oldest_wait_s exactly
        urgent = max(((self.now - r.arrival_s) * self._slo(r).pressure_weight
                      for r in self.queue if r.arrival_s <= self.now),
                     default=0.0)
        backlog = sum(r.prefill_remaining for r in self.running
                      if r.state == RState.PREFILLING) + \
            sum(r.prompt_len for r in self.queue if r.arrival_s <= self.now)
        self.monitor.observe(Telemetry(
            time_s=self.now,
            kv_used_blocks=self.pool.alloc.n_used,
            kv_total_blocks=self.pool.num_blocks - 1,
            queue_len=sum(1 for r in self.queue if r.arrival_s <= self.now),
            oldest_wait_s=(self.now - oldest) if oldest is not None else 0.0,
            running=len(self.running),
            swap_level=lvl,
            step_time_s=dt,
            decode_tokens=len(dec),
            prefill_tokens=pf_tokens,
            prefill_backlog_tokens=backlog,
            chunk_budget=self.chunk_budget,
            prefix_cached_blocks=(self.prefix_cache.resident_blocks
                                  if self.prefix_cache is not None else 0),
            urgent_wait_s=urgent,
            kv_quant_blocks=len(self.pool.qbits),
            kv_bytes_relieved=self.ledger.bytes_relieved))
        self._step_idx += 1
        if self.ec.watchdog_interval > 0 \
                and self._step_idx % self.ec.watchdog_interval == 0:
            self._check_invariants()
        self._morph_tick()
        return dt

    def run_trace(self, trace: List[TraceRequest], *,
                  horizon_s: Optional[float] = None,
                  max_steps: int = 200000) -> ServingReport:
        for tr in trace:
            self.submit(tr)
        self.queue = collections.deque(
            sorted(self.queue, key=lambda r: (r.arrival_s, r.rid)))
        end = horizon_s if horizon_s is not None else \
            (max(tr.arrival_s for tr in trace) + 1e9)
        steps = 0
        while steps < max_steps:
            steps += 1
            # O(1) liveness check (was a per-step scan of all_requests)
            if self._n_live == 0:
                break
            if self.now > end:
                break
            nxt = min((r.arrival_s for r in self.queue), default=None)
            if not self.running and nxt is not None and nxt > self.now:
                self.now = nxt                           # fast-forward idle
            self.step()
        dur = max(self.now, 1e-9)
        for r in self.all_requests:
            for t in r.tpots():
                self.monitor.record_tpot(t)
        admitted = max(sum(1 for r in self.all_requests
                           if r.state not in (RState.FAILED, RState.SHED)), 1)
        return build_report(self.all_requests, ttft_slo_s=self.sc.ttft_slo_s,
                            duration_s=dur, history=self.monitor.history,
                            prefix_hit_rate=self.prefix_hit_requests
                            / admitted,
                            prefill_tokens_saved=self.prefill_tokens_saved,
                            starvation_bypasses=self.starvation_bypasses)


def _tensors(tree):
    """Every tensor of a param tree (QTensor fields included)."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    if isinstance(tree, torch.Tensor):
        return [tree]
    fields = ("packed", "scales", "zeros", "inv_act")
    return [t for f in fields
            for t in [getattr(tree, f, None)] if isinstance(t, torch.Tensor)]
