"""Multi-replica serving cluster (control plane) with fault tolerance.

A pod runs many model-parallel replica groups; this module is the dispatcher
layer above per-replica MorphServe engines (paper Fig. 2: Request Dispatcher
+ per-worker engines), with the operational features 1000-node serving needs:

  * **morph-aware routing**: replicas are scored on live morph telemetry —
    queue + running depth, KV-pool pressure, swap level, chunk-budget
    prefill backlog, and recent step time — not just queue length, so a
    degraded (swapped/pressured) replica sheds new load before it has to
    shed live requests
  * heartbeat failure detection: a replica that stops beating (killed or
    partitioned) is *fenced* — its terminal records and telemetry are
    harvested into the cluster report, its in-flight requests re-dispatched
    (KV lost → re-prefill) with prompt content and cluster identity
    preserved, and it rejoins after a restart delay (weights reload from
    the host checkpoint — modeled by the delay)
  * a per-logical-request re-dispatch cap: a request that keeps landing on
    dying replicas terminates as FAILED (an SLO violation) instead of
    ping-ponging forever
  * **graceful drain**: drained replicas (stragglers, or an explicit drain
    fault) stop taking new work but keep stepping until their running
    requests finish — queued work transfers out immediately
  * elastic scale-out: replicas can be added mid-run
  * **state-preserving failover** (opt-in via
    :class:`repro_torch.distributed.migration.MigrationConfig`): everywhere a
    request's computed state used to die, the cluster first tries to
    *migrate* it — drained replicas hand their running slot-holders' paged
    KV to a low-pressure peer instead of limping to completion, and fenced
    partitions (alive but unreachable by heartbeat) have their harvested
    live work migrated out while the source memory is still addressable.
    A migrated request resumes mid-stream on the destination with identity,
    TTFT, and (in simulated compute, bit-identically) its token stream
    intact — no re-prefill. Any transfer failure (stall past timeout,
    checksum-caught corruption, destination death mid-import, destination
    capacity) falls back to the recompute re-dispatch path below, so a
    request is never stranded and never double-run. Dispatch additionally
    does replica-crossing prefix-cache lookups: when a peer holds a longer
    cached prefix of an arriving prompt at the target's swap level, those
    blocks migrate ahead of admission.

Faults are injected from a declarative, seeded
:class:`repro_torch.distributed.faults.FaultPlan` (kill / flap / slow /
heartbeat-loss / drain / scale-out at the cluster seam; allocation
failures, swap delays/failures, and step spikes inside each engine), or
from the legacy :class:`FaultEvent` list. All replicas share one virtual
clock (lock-step rounds of the per-replica engines) so every chaos run is
deterministic for a fixed seed.

This is the JAX package's control plane with its logic unchanged. Every
replica is a port engine on ``device`` (the card unless the caller asks for
the CPU), restarts and scale-outs included; in real compute all of them
share the caller's ``params`` tensors and each builds its own swap plan.
A migrated request's KV leaves its source card through
``PagedKVPool.gather_blocks`` and lands on the destination through
``scatter_blocks``, where the next decode step reads it through the paged
attention kernels like any block the replica wrote itself.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from repro_torch.configs.base import ModelConfig, ServingConfig
from repro_torch.distributed.faults import ClusterFault, FaultPlan
from repro_torch.distributed.migration import (MigrationChannel,
                                               MigrationConfig)
from repro_torch.engine.engine import EngineConfig, MorphServeEngine
from repro_torch.engine.metrics import ServingReport, build_report
from repro_torch.engine.request import Request, RState
from repro_torch.engine.traces import (DEFAULT_SLO_CLASS, SLO_CLASSES,
                                      TraceRequest)


@dataclasses.dataclass
class FaultEvent:
    """Legacy imperative fault event (prefer ``faults.FaultPlan``)."""
    time_s: float
    kind: str                        # kill | restart | add | slow | heal
    replica: int
    factor: float = 1.0              # slow factor for 'slow'


# routing weights: one score per replica, lowest wins (ties break on index
# for determinism). Depth counts requests; pool/level are fractions in
# [0, 1]; backlog is prefill work in units of steps-at-current-budget;
# step_time is the replica's last wall step in seconds (stragglers score
# high before drain detection even fires).
DEFAULT_ROUTE_WEIGHTS = {"depth": 1.0, "pool": 4.0, "level": 2.0,
                         "backlog": 0.5, "step_time": 2.0}

_TERMINAL = (RState.FINISHED, RState.FAILED, RState.SHED)


@dataclasses.dataclass
class ReplicaState:
    engine: Optional[MorphServeEngine]
    alive: bool = True
    slow_factor: float = 1.0
    last_heartbeat: float = 0.0
    restart_at: Optional[float] = None
    drained: bool = False
    hb_mute_until: float = 0.0       # heartbeat-loss fault window end


class ServingCluster:
    def __init__(self, cfg: ModelConfig, params, serving: ServingConfig,
                 ecfg: EngineConfig, *, n_replicas: int = 2,
                 heartbeat_timeout_s: float = 1.0,
                 restart_delay_s: float = 5.0,
                 straggler_factor: float = 3.0, seed: int = 0,
                 max_redispatches: int = 4,
                 route_weights: Optional[Dict[str, float]] = None,
                 migration: Optional[MigrationConfig] = None,
                 device="cuda"):
        self.cfg, self.params, self.sc = cfg, params, serving
        self.device = device
        self.ec = ecfg
        self.hb_timeout = heartbeat_timeout_s
        self.restart_delay = restart_delay_s
        self.straggler_factor = straggler_factor
        self.max_redispatches = max_redispatches
        self.route_weights = dict(DEFAULT_ROUTE_WEIGHTS,
                                  **(route_weights or {}))
        self.now = 0.0
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self.fault_plan: Optional[FaultPlan] = None
        self.replicas: List[ReplicaState] = [
            ReplicaState(self._make_engine(i)) for i in range(n_replicas)]
        self.pending: List[TraceRequest] = []
        self._next_cid = 0
        # per-logical-request failover counter (cluster_id -> re-dispatches)
        self.redispatch_counts: Dict[int, int] = {}
        self.redispatched = 0
        self.detected_failures = 0
        self.drains = 0
        self.drains_refused = 0      # drain no-ops (dead / last live replica)
        # KV migration fabric (None: every failover is recompute re-dispatch)
        self.migration = migration
        self.channel: Optional[MigrationChannel] = None
        if migration is not None:
            cost = self.replicas[0].engine.cost
            self.channel = MigrationChannel(migration, cost,
                                            dtype_bytes=cost.dtype_bytes)
        self.migrations_attempted = 0
        self.migrations_ok = 0
        self.migration_aborts = {"stall": 0, "corrupt": 0, "dest_dead": 0,
                                 "capacity": 0}
        self.migrated_blocks = 0
        self.prefix_migrations = 0
        self.prefix_blocks_migrated = 0
        # report integrity across replica loss: terminal request records and
        # telemetry harvested from fenced replicas before their engine is
        # discarded, plus requests terminated by the re-dispatch cap
        self.archived_requests: List[Request] = []
        self.archived_history: List = []
        self.failed_records: List[Request] = []
        self.archived_starvation = 0   # bypass counters of fenced engines

    def _make_engine(self, i: int) -> MorphServeEngine:
        inj = (self.fault_plan.for_replica(i)
               if self.fault_plan is not None else None)
        e = MorphServeEngine(self.cfg, self.params, self.sc,
                             dataclasses.replace(self.ec, seed=self.ec.seed + i),
                             fault_injector=inj, device=self.device)
        e.now = self.now
        return e

    # ------------------------------------------------------------------
    # morph-aware routing
    # ------------------------------------------------------------------
    def _live(self) -> List[int]:
        return [i for i, r in enumerate(self.replicas)
                if r.alive and not r.drained and r.engine is not None]

    def _route_score(self, i: int, urgency: float = 1.0) -> float:
        """Routing score for replica ``i`` (lowest wins). ``urgency`` is the
        request's SLO-class pressure weight: the *degradation* terms (pool
        pressure, swap level, step time) are scaled by it, so a degraded
        replica sheds interactive load first while batch/background traffic
        still fills it — its capacity isn't wasted, just reserved for work
        that can tolerate it. Interactive (weight 1.0) scores exactly as
        before."""
        e = self.replicas[i].engine
        depth = len(e.queue) + len(e.running)
        pool = e.pool.usage()
        level = e.actuator.level / max(e.plan.n_layers, 1)
        backlog = (sum(q.prefill_remaining for q in e.running
                       if q.state == RState.PREFILLING)
                   + sum(q.prompt_len for q in e.queue))
        backlog_steps = backlog / max(e.chunk_budget, 1)
        step_t = (e.monitor.history[-1].step_time_s
                  if e.monitor.history else 0.0)
        w = self.route_weights
        return (w["depth"] * depth + w["backlog"] * backlog_steps
                + urgency * (w["pool"] * pool + w["level"] * level
                             + w["step_time"] * step_t))

    def _route(self, exclude: Optional[int] = None,
               urgency: float = 1.0) -> Optional[int]:
        live = [i for i in self._live() if i != exclude]
        if not live:
            return None
        return min(live, key=lambda i: (self._route_score(i, urgency), i))

    @staticmethod
    def _urgency(slo_class: str) -> float:
        slo = SLO_CLASSES.get(slo_class, SLO_CLASSES[DEFAULT_SLO_CLASS])
        return slo.pressure_weight

    def dispatch(self, tr: TraceRequest) -> None:
        if tr.request_id is None:
            tr = dataclasses.replace(tr, request_id=self._next_cid)
            self._next_cid += 1
        if tr.prompt_tokens is None:
            # fabricate prompt content at the *cluster* seam, keyed by the
            # logical request id — per-engine rng fabrication would make a
            # request's tokens (and its sim stream seed) depend on placement
            # history, defeating cross-run bit-identity checks
            prng = np.random.default_rng([self.seed, tr.request_id])
            tr = dataclasses.replace(tr, prompt_tokens=tuple(
                int(t) for t in prng.integers(0, self.cfg.vocab,
                                              size=tr.prompt_len)))
        tgt = self._route(urgency=self._urgency(tr.slo_class))
        if tgt is None:
            self.pending.append(tr)
            return
        if self.channel is not None and self.channel.cfg.prefix_migration:
            self._migrate_prefix(tr, tgt)
        req = self.replicas[tgt].engine.submit(tr)
        req.cluster_id = tr.request_id

    # ------------------------------------------------------------------
    # fault handling
    # ------------------------------------------------------------------
    def kill(self, i: int, *, restart_delay_s: Optional[float] = None) -> None:
        r = self.replicas[i]
        if not r.alive:
            return
        r.alive = False
        r.restart_at = self.now + (restart_delay_s
                                   if restart_delay_s is not None
                                   else self.restart_delay)

    def _drain(self, i: int) -> None:
        """Graceful drain: stop routing new work to replica ``i``. Queued
        work transfers out now (identity preserved); running slot-holders
        migrate their computed KV to a peer when the migration fabric is
        configured, and otherwise — or when a transfer fails — keep
        stepping here to completion."""
        r = self.replicas[i]
        if r.drained:
            return
        if not r.alive or r.engine is None or len(self._live()) <= 1:
            # dead replica, or the last live one: draining it would stop
            # the cluster — refuse (visibly, not as a silent no-op)
            self.drains_refused += 1
            return
        r.drained = True
        self.drains += 1
        e = r.engine
        for q in e.release_queued():
            self._redispatch_live(q)     # queued: no device state to move
        if self.channel is not None:
            # drain handoff: a straggler's live work leaves *with its KV*
            # instead of limping to completion at straggler speed
            for q in list(e.running):
                self._try_migrate(q, i)  # failure → keeps stepping here

    def _try_migrate(self, q: Request, src: int) -> bool:
        """Move a live slot-holder's paged-KV state from replica ``src`` to
        the best peer. True only when the destination has fully committed
        the request and the source record is detached — every failure path
        returns False with the source state untouched (drain: the request
        keeps stepping; fencing: the caller falls back to recompute)."""
        if self.channel is None:
            return False
        e_src = self.replicas[src].engine
        if e_src is None:
            return False
        tgt = self._route(exclude=src, urgency=self._urgency(q.slo_class))
        if tgt is None:
            return False
        st = e_src.export_request_state(q)
        if st is None:
            return False                 # nothing exportable: fall back
        self.migrations_attempted += 1
        faults = (self.fault_plan.migration_faults()
                  if self.fault_plan is not None else None)
        res, k, v = self.channel.transfer(
            st.n_blocks, st.k, st.v, quant=st.quant_payload,
            quant_bits=st.quant_bits, quant_blocks=len(st.quant_idx),
            faults=faults, now=self.now)
        if not res.ok:
            self.migration_aborts[
                "stall" if res.reason == "stall" else "corrupt"] += 1
            return False
        if faults is not None and faults.dest_kill_should_fire(self.now):
            # destination dies mid-import: nothing was committed there, so
            # the source copy is still the only live one — kill the target
            # through the normal fence/restart lifecycle and fall back
            self.migration_aborts["dest_dead"] += 1
            self.kill(tgt)
            return False
        st.k, st.v = k, v
        if st.quant_payload is not None:
            # quantized blocks crossed as codec payload — no round trip
            st.quant_payload = res.quant
        dst = self.replicas[tgt].engine
        imported = dst.import_request_state(st)
        if imported is None:
            self.migration_aborts["capacity"] += 1
            return False
        dst.now += res.time_s            # import busy-time lands on the dest
        e_src.detach_request(q)          # exactly one live copy from here on
        self.migrations_ok += 1
        self.migrated_blocks += st.n_blocks
        return True

    def _migrate_prefix(self, tr: TraceRequest, tgt: int) -> None:
        """Replica-crossing prefix-cache lookup: when a peer holds a longer
        cached prefix of this prompt than the target does, migrate those
        blocks ahead of admission so the target's own lookup hits locally
        instead of re-prefilling. Cache keys are level-independent, so a
        peer's chain is usable regardless of either replica's swap level —
        each entry carries its writer level (and any tolerance tag) along."""
        dst = self.replicas[tgt].engine
        if dst.prefix_cache is None or tr.prompt_tokens is None:
            return
        bs = dst.prefix_cache.block_size
        max_blocks = len(tr.prompt_tokens) // bs
        if max_blocks <= 0:
            return
        local = len(dst.prefix_cache.peek(tr.prompt_tokens, max_blocks))
        best, best_entries, best_len = None, None, local
        for j in self._live():
            e = self.replicas[j].engine
            if j == tgt or e.prefix_cache is None:
                continue
            ents = e.prefix_cache.peek(tr.prompt_tokens, max_blocks)
            if len(ents) > best_len:
                best, best_entries, best_len = j, ents, len(ents)
        if best is None or best_len - local < self.channel.cfg.min_prefix_blocks:
            return
        src_e = self.replicas[best].engine
        k, v, qidx, qbits, qpay = src_e.export_prefix_payload(best_entries)
        faults = (self.fault_plan.migration_faults()
                  if self.fault_plan is not None else None)
        res, k, v = self.channel.transfer(
            len(best_entries), k, v, quant=qpay, quant_bits=qbits,
            quant_blocks=len(qidx), faults=faults, now=self.now)
        if not res.ok:                   # best-effort: admission proceeds
            self.migration_aborts[
                "stall" if res.reason == "stall" else "corrupt"] += 1
            return
        adopted = dst.import_prefix_chain(
            tr.prompt_tokens, [e.level for e in best_entries],
            len(best_entries), k, v, quant_idx=qidx, quant_bits=qbits,
            quant=res.quant if qpay is not None else None,
            tols=[e.tol for e in best_entries])
        if adopted:
            dst.now += res.time_s
            self.prefix_migrations += 1
            self.prefix_blocks_migrated += adopted

    def _redispatch_live(self, q: Request, src: Optional[int] = None) -> None:
        """Re-dispatch a live request after its replica died or drained.

        When ``src`` names a still-reachable replica (partition fencing,
        drain), migration is tried first: the request resumes mid-stream on
        a peer with its KV intact — no re-prefill, no re-dispatch count.
        Otherwise (or on any transfer failure) the recompute policy runs:
        the *actual* prompt tokens travel with the request (prefix-cache
        reuse and cross-replica determinism survive failover), generated
        tokens are folded into the prompt (device KV lost), the stream seed
        and original identity ride along so the surviving replica continues
        the same logical stream, and the cluster-wide request id keeps the
        failover cap counting per logical request."""
        if src is not None and self._try_migrate(q, src):
            return
        cid = q.cluster_id
        prompt = tuple(q.prompt) + tuple(q.generated)
        rem = q.max_new_tokens - len(q.generated)
        if rem <= 0:                      # already had every token it needs
            q.state = RState.FINISHED
            q.finish_s = self.now
            self.archived_requests.append(q)
            return
        if cid is not None:
            self.redispatch_counts[cid] = \
                self.redispatch_counts.get(cid, 0) + 1
        self.redispatched += 1
        if cid is not None and \
                0 < self.max_redispatches < self.redispatch_counts[cid]:
            # livelocked across the cluster: terminate as FAILED (an SLO
            # violation) instead of ping-ponging between dying replicas.
            # The record keeps the request's real identity — its rid, its
            # *original* token budget, stream seed, and prompt boundary —
            # so report accounting and replay tooling see the request as
            # it was, not the synthetic remainder that failed to place.
            self.failed_records.append(Request(
                rid=q.rid, arrival_s=q.arrival_s, prompt=list(prompt),
                max_new_tokens=q.orig_max_new_tokens, state=RState.FAILED,
                cluster_id=cid, token_seed=q.token_seed,
                orig_prompt_len=q.orig_prompt_len,
                orig_max_new_tokens=q.orig_max_new_tokens,
                slo_class=q.slo_class))
            return
        self.dispatch(TraceRequest(q.arrival_s, len(prompt), rem, prompt,
                                   request_id=cid, token_seed=q.token_seed,
                                   orig_prompt_len=q.orig_prompt_len,
                                   orig_max_new_tokens=q.orig_max_new_tokens,
                                   slo_class=q.slo_class))

    def _harvest_and_discard(self, i: int) -> None:
        """Fence a dead/partitioned replica: keep its FINISHED/FAILED
        records and telemetry for the final report, move everything still
        live (migrating KV out of a *partitioned* replica — alive, merely
        unreachable by heartbeat — whose memory is still addressable; a
        killed replica's state is gone, so its work recomputes), then drop
        the engine."""
        e = self.replicas[i].engine
        src = i if self.replicas[i].alive else None
        # a partitioned replica is still `alive` with a live engine here, so
        # without this the dispatcher can route evacuated work *back* onto
        # the replica being fenced — the record then dies with the engine
        # (silent request loss). Pull it from the rotation first; the
        # restart path clears the flag on rejoin.
        self.replicas[i].drained = True
        for q in list(e.all_requests):
            if q.state in _TERMINAL:
                self.archived_requests.append(q)
            else:
                self._redispatch_live(q, src=src)
        self.archived_history.extend(e.monitor.history)
        self.archived_starvation += e.starvation_bypasses
        self.replicas[i].engine = None

    def _detect_and_recover(self) -> None:
        # live, un-partitioned replicas beat; killed or partitioned ones
        # go stale and get fenced after the timeout
        for r in self.replicas:
            if r.alive and r.engine is not None \
                    and self.now >= r.hb_mute_until:
                r.last_heartbeat = self.now
        for i, r in enumerate(self.replicas):
            if r.engine is not None \
                    and self.now - r.last_heartbeat > self.hb_timeout:
                self.detected_failures += 1
                self._harvest_and_discard(i)
                if r.alive:
                    # partition (heartbeat loss while serving): fence it;
                    # it rejoins through the same restart path as a kill
                    r.alive = False
                    r.restart_at = self.now + self.restart_delay
        med = np.median([r.engine.monitor.history[-1].step_time_s
                         for r in self.replicas
                         if r.alive and not r.drained and r.engine
                         and r.engine.monitor.history] or [0.0])
        for i, r in enumerate(self.replicas):
            if not r.alive:
                if r.restart_at is not None and self.now >= r.restart_at \
                        and r.engine is None:
                    r.engine = self._make_engine(i)   # reload from checkpoint
                    r.alive = True
                    r.drained = False
                    r.restart_at = None
                    r.hb_mute_until = 0.0
                    r.last_heartbeat = self.now
                continue
            if r.engine is None:
                continue
            # straggler: drain replicas far above the fleet median step time
            if (med > 0 and r.engine.monitor.history and
                    r.engine.monitor.history[-1].step_time_s
                    > self.straggler_factor * med and not r.drained):
                self._drain(i)

    # ------------------------------------------------------------------
    def migration_stats(self) -> Dict:
        """Migration observability for benches/tests: attempt/abort
        breakdown, moved volume, prefix-migration counts, and the raw
        channel counters (empty-ish when migration is off)."""
        d = {"attempted": self.migrations_attempted,
             "ok": self.migrations_ok,
             "aborts": dict(self.migration_aborts),
             "blocks": self.migrated_blocks,
             "prefix_migrations": self.prefix_migrations,
             "prefix_blocks": self.prefix_blocks_migrated,
             "drains_refused": self.drains_refused}
        if self.channel is not None:
            d["channel"] = self.channel.stats()
        return d

    # ------------------------------------------------------------------
    def add_replica(self) -> int:
        self.replicas.append(ReplicaState(self._make_engine(
            len(self.replicas))))
        return len(self.replicas) - 1

    # ------------------------------------------------------------------
    def _compile_faults(self, faults) -> List[ClusterFault]:
        if isinstance(faults, FaultPlan):
            self.fault_plan = faults
            for i, r in enumerate(self.replicas):
                if r.engine is not None:
                    inj = faults.for_replica(i)
                    r.engine.faults = inj
                    r.engine.actuator.faults = inj
            return faults.cluster_events()
        events = []
        for f in faults:
            kind = "hb_loss" if f.kind == "heartbeat_loss" else f.kind
            if kind == "restart":        # legacy no-op kind
                continue
            events.append(ClusterFault(f.time_s, kind, f.replica,
                                       factor=f.factor))
        return sorted(events, key=lambda e: (e.time_s, e.replica, e.kind))

    def _inject(self, ev: ClusterFault) -> None:
        if ev.kind == "add":
            self.add_replica()
            return
        if not (0 <= ev.replica < len(self.replicas)):
            return
        r = self.replicas[ev.replica]
        if ev.kind == "kill":
            self.kill(ev.replica, restart_delay_s=ev.restart_delay_s)
        elif ev.kind == "slow":
            r.slow_factor = ev.factor
        elif ev.kind == "heal":
            r.slow_factor = 1.0
            r.drained = False
        elif ev.kind == "hb_loss":
            r.hb_mute_until = self.now + ev.duration_s
        elif ev.kind == "drain":
            self._drain(ev.replica)

    # ------------------------------------------------------------------
    def collect_requests(self) -> List[Request]:
        """Every request record the cluster knows about: harvested archives,
        cap-terminated failures, live engines' books, and still-undispatched
        pending arrivals (synthesized as hung QUEUED records)."""
        reqs = list(self.archived_requests) + list(self.failed_records)
        for r in self.replicas:
            if r.engine is not None:
                reqs.extend(r.engine.all_requests)
        for tr in self.pending:
            reqs.append(Request(rid=-1, arrival_s=tr.arrival_s, prompt=[],
                                max_new_tokens=tr.max_new_tokens,
                                state=RState.QUEUED,
                                cluster_id=tr.request_id,
                                slo_class=tr.slo_class))
        return reqs

    def collect_history(self) -> List:
        hist = list(self.archived_history)
        for r in self.replicas:
            if r.engine is not None:
                hist.extend(r.engine.monitor.history)
        return hist

    def run(self, trace: List[TraceRequest],
            faults: Union[FaultPlan, Sequence[FaultEvent]] = (),
            *, round_s: float = 0.25, horizon_s: float = 120.0
            ) -> ServingReport:
        trace = sorted(trace, key=lambda t: t.arrival_s)
        events = self._compile_faults(faults)
        ti = ei = 0
        while self.now < horizon_s:
            # inject faults due now
            while ei < len(events) and events[ei].time_s <= self.now:
                self._inject(events[ei])
                ei += 1
            # dispatch arrivals due now; retry anything parked in pending
            while ti < len(trace) and trace[ti].arrival_s <= self.now:
                self.dispatch(trace[ti])
                ti += 1
            for tr in list(self.pending):
                self.pending.remove(tr)
                self.dispatch(tr)
            # advance every serving replica to self.now + round_s. Drained
            # replicas keep stepping: their running requests must finish
            # (they only stop *taking* work) — skipping them froze in-flight
            # requests forever and the done condition could never fire.
            target = self.now + round_s
            for r in self.replicas:
                if not r.alive or r.engine is None:
                    continue
                e = r.engine
                while e.now < target:
                    active = (e.queue or e.running)
                    if not active:
                        e.now = target
                        break
                    dt = e.step()
                    if r.slow_factor != 1.0:      # straggler runs slower
                        e.now += dt * (r.slow_factor - 1.0)
                        # the replica's own monitor measures wall time, so
                        # the slowdown must show up in its telemetry — the
                        # token-budgeted step loop equalizes *modeled* step
                        # cost across replicas, so the modeled dt alone no
                        # longer exposes a straggler
                        if e.monitor.history:
                            e.monitor.history[-1].step_time_s = \
                                dt * r.slow_factor
            self.now = target
            self._detect_and_recover()
            done = (ti >= len(trace) and ei >= len(events)
                    and not self.pending
                    and all(not (r.engine.queue or r.engine.running)
                            for r in self.replicas
                            if r.engine is not None))
            if done:
                break
        return build_report(self.collect_requests(),
                            ttft_slo_s=self.sc.ttft_slo_s,
                            duration_s=max(self.now, 1e-9),
                            history=self.collect_history(),
                            n_redispatched=self.redispatched,
                            n_migrated=self.migrations_ok,
                            starvation_bypasses=self.archived_starvation
                            + sum(r.engine.starvation_bypasses
                                  for r in self.replicas
                                  if r.engine is not None))
