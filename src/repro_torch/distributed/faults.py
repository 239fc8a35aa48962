"""Deterministic, seeded fault injection for chaos-testing the serving stack.

One declarative :class:`FaultPlan` is shared by unit tests and the cluster
runs: it compiles into

  * **cluster events** (:class:`ClusterFault`) — replica kill / restart
    flapping / stragglers / heartbeat loss / drain / scale-out, injected by
    ``ServingCluster.run`` at exact virtual times; and
  * **engine injectors** (:class:`ReplicaFaults`) — per-replica hooks the
    engine and actuator query at defined seams: KV-pool allocation failures
    (``MorphServeEngine._alloc_blocks``), swap-apply delays and failures
    (``MorphingActuator.issue``/``poll``), and step-time spikes
    (``MorphServeEngine.step``).

Everything is driven by ``numpy`` generators seeded from
``(plan.seed, replica)``, so a fixed plan + fixed workload replays
bit-identically — faults are *inputs*, not nondeterminism. This module is
the JAX package's ``repro.distributed.faults`` unchanged (numpy only), so
one plan draws the same faults in both packages.

Fault kinds
-----------
cluster-level (``replica`` required; compiled to timed events):
  ``kill``            replica dies at ``start_s``; restarts after
                      ``restart_delay_s`` (cluster default when None)
  ``flap``            ``count`` kill/restart cycles every ``period_s``
  ``slow``            step-time slowdown ``factor``x; auto-heals after
                      ``duration_s`` when > 0
  ``heal``            clear slow + drained state
  ``heartbeat_loss``  replica keeps serving but stops heartbeating for
                      ``duration_s`` (partition: the cluster fences it)
  ``drain``           stop routing new work to the replica; running
                      requests finish (graceful drain semantics)
  ``add``             elastic scale-out

engine-level (window ``[start_s, start_s + duration_s)``; ``replica = -1``
applies to every replica):
  ``alloc_fail``      each KV-block allocation fails with probability ``p``
  ``swap_delay``      in-flight weight swaps take ``delay_s`` longer
  ``swap_fail``       a completing swap aborts with probability ``p``
                      (level unchanged; the controller re-issues)
  ``step_spike``      engine step time multiplied by ``factor``

migration-seam (window ``[start_s, start_s + duration_s)``; drawn once per
KV-migration attempt from the plan's dedicated migration rng stream):
  ``migration_stall``      the transfer stalls ``delay_s`` extra seconds
                           with probability ``p`` — past the channel's stall
                           timeout it aborts and failover falls back to
                           recompute re-dispatch
  ``migration_corrupt``    one in-flight chunk is corrupted with
                           probability ``p``; the per-chunk checksum catches
                           it, the migration aborts cleanly, fallback
                           recompute (never a silent bad import)
  ``migration_dest_kill``  the destination replica dies mid-import with
                           probability ``p``: the half-imported request is
                           discarded before commit (exactly one live copy
                           survives, on the fallback path) and the
                           destination goes through the normal kill/fence
                           lifecycle
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

CLUSTER_KINDS = ("kill", "flap", "slow", "heal", "heartbeat_loss", "drain",
                 "add")
ENGINE_KINDS = ("alloc_fail", "swap_delay", "swap_fail", "step_spike")
MIGRATION_KINDS = ("migration_stall", "migration_corrupt",
                   "migration_dest_kill")


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One declarative fault. See module docstring for kind semantics."""
    kind: str
    start_s: float
    replica: int = -1                # -1 = all replicas (engine-level kinds)
    duration_s: float = 0.0          # active window for rate-based faults
    p: float = 1.0                   # per-opportunity probability
    factor: float = 1.0              # slow / step_spike multiplier
    delay_s: float = 0.0             # extra swap transfer seconds
    count: int = 1                   # flap: kill/restart cycles
    period_s: float = 0.0            # flap: cycle period
    restart_delay_s: Optional[float] = None   # kill/flap override

    def __post_init__(self):
        if self.kind not in CLUSTER_KINDS + ENGINE_KINDS + MIGRATION_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")

    def active(self, now: float) -> bool:
        if self.duration_s <= 0:
            return now >= self.start_s
        return self.start_s <= now < self.start_s + self.duration_s


@dataclasses.dataclass
class ClusterFault:
    """A compiled, timed control-plane event (internal to the cluster)."""
    time_s: float
    kind: str                        # kill | slow | heal | hb_loss | drain | add
    replica: int
    factor: float = 1.0
    duration_s: float = 0.0
    restart_delay_s: Optional[float] = None


class ReplicaFaults:
    """Engine-level injector for one replica. Queried at the engine seams;
    draws from its own seeded generator only while a fault window is active,
    so replays are deterministic and fault-free runs never touch the rng."""

    def __init__(self, specs: Sequence[FaultSpec], seed: int, replica: int):
        self.replica = replica
        self.rng = np.random.default_rng([seed, replica])
        mine = [s for s in specs
                if s.kind in ENGINE_KINDS and s.replica in (-1, replica)]
        self._alloc = [s for s in mine if s.kind == "alloc_fail"]
        self._swap_delay = [s for s in mine if s.kind == "swap_delay"]
        self._swap_fail = [s for s in mine if s.kind == "swap_fail"]
        self._spike = [s for s in mine if s.kind == "step_spike"]
        # observability (bench / tests)
        self.injected_alloc_failures = 0
        self.injected_swap_failures = 0
        self.injected_swap_delay_s = 0.0

    def alloc_should_fail(self, now: float) -> bool:
        for s in self._alloc:
            if s.active(now) and self.rng.random() < s.p:
                self.injected_alloc_failures += 1
                return True
        return False

    def swap_delay_s(self, now: float) -> float:
        d = sum(s.delay_s for s in self._swap_delay if s.active(now))
        self.injected_swap_delay_s += d
        return d

    def swap_should_fail(self, now: float) -> bool:
        for s in self._swap_fail:
            if s.active(now) and self.rng.random() < s.p:
                self.injected_swap_failures += 1
                return True
        return False

    def step_time_factor(self, now: float) -> float:
        f = 1.0
        for s in self._spike:
            if s.active(now):
                f *= s.factor
        return f

    def stats(self) -> Dict[str, float]:
        return {"alloc_failures": self.injected_alloc_failures,
                "swap_failures": self.injected_swap_failures,
                "swap_delay_s": self.injected_swap_delay_s}


class MigrationFaults:
    """Migration-seam injector, shared cluster-wide (one transfer fabric).

    Queried once per KV-migration attempt; draws come from a dedicated rng
    stream seeded ``(plan.seed, _STREAM)`` and only inside active windows,
    so runs without migrations — or without migration faults — leave the
    stream untouched and replays stay bit-deterministic."""

    _STREAM = 0x4D16  # 'MIG': disjoint from any per-replica (seed, i) stream

    def __init__(self, specs: Sequence[FaultSpec], seed: int):
        self.rng = np.random.default_rng([seed, self._STREAM])
        mine = [s for s in specs if s.kind in MIGRATION_KINDS]
        self._stall = [s for s in mine if s.kind == "migration_stall"]
        self._corrupt = [s for s in mine if s.kind == "migration_corrupt"]
        self._dest_kill = [s for s in mine
                           if s.kind == "migration_dest_kill"]
        # observability (bench / tests)
        self.injected_stalls = 0
        self.injected_corruptions = 0
        self.injected_dest_kills = 0

    def stall_seconds(self, now: float) -> float:
        d = 0.0
        for s in self._stall:
            if s.active(now) and self.rng.random() < s.p:
                self.injected_stalls += 1
                d += s.delay_s
        return d

    def corrupt_should_fire(self, now: float) -> bool:
        for s in self._corrupt:
            if s.active(now) and self.rng.random() < s.p:
                self.injected_corruptions += 1
                return True
        return False

    def dest_kill_should_fire(self, now: float) -> bool:
        for s in self._dest_kill:
            if s.active(now) and self.rng.random() < s.p:
                self.injected_dest_kills += 1
                return True
        return False

    def stats(self) -> Dict[str, float]:
        return {"migration_stalls": self.injected_stalls,
                "migration_corruptions": self.injected_corruptions,
                "migration_dest_kills": self.injected_dest_kills}


@dataclasses.dataclass
class FaultPlan:
    """Declarative chaos script: one object drives tests and benches.

    ``for_replica(i)`` hands the engine its injector (cached — rng state and
    counters survive replica restarts); ``cluster_events()`` compiles the
    control-plane schedule ``ServingCluster.run`` walks."""
    specs: Sequence[FaultSpec] = ()
    seed: int = 0

    def __post_init__(self):
        self._injectors: Dict[int, ReplicaFaults] = {}
        self._migration: Optional[MigrationFaults] = None

    def for_replica(self, i: int) -> ReplicaFaults:
        if i not in self._injectors:
            self._injectors[i] = ReplicaFaults(self.specs, self.seed, i)
        return self._injectors[i]

    def migration_faults(self) -> MigrationFaults:
        """The cluster-wide migration-seam injector (cached: one rng stream
        per plan, surviving replica restarts like the engine injectors)."""
        if self._migration is None:
            self._migration = MigrationFaults(self.specs, self.seed)
        return self._migration

    def injector_stats(self) -> Dict[int, Dict[str, float]]:
        return {i: inj.stats() for i, inj in sorted(self._injectors.items())}

    def migration_stats(self) -> Dict[str, float]:
        return (self._migration.stats() if self._migration is not None
                else MigrationFaults((), 0).stats())

    def cluster_events(self) -> List[ClusterFault]:
        ev: List[ClusterFault] = []
        for s in self.specs:
            if s.kind == "kill":
                ev.append(ClusterFault(s.start_s, "kill", s.replica,
                                       restart_delay_s=s.restart_delay_s))
            elif s.kind == "flap":
                rd = (s.restart_delay_s if s.restart_delay_s is not None
                      else max(s.period_s / 2, 0.5))
                for k in range(max(s.count, 1)):
                    ev.append(ClusterFault(s.start_s + k * s.period_s, "kill",
                                           s.replica, restart_delay_s=rd))
            elif s.kind == "slow":
                ev.append(ClusterFault(s.start_s, "slow", s.replica,
                                       factor=s.factor))
                if s.duration_s > 0:
                    ev.append(ClusterFault(s.start_s + s.duration_s, "heal",
                                           s.replica))
            elif s.kind == "heartbeat_loss":
                ev.append(ClusterFault(s.start_s, "hb_loss", s.replica,
                                       duration_s=s.duration_s))
            elif s.kind in ("heal", "drain", "add"):
                ev.append(ClusterFault(s.start_s, s.kind, s.replica))
            # engine-level kinds compile to no cluster events
        return sorted(ev, key=lambda e: (e.time_s, e.replica, e.kind))
