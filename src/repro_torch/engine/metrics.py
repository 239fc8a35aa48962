"""SLO / latency / throughput accounting (paper §4 metrics).

Per-class accounting: every request carries an SLO class (interactive /
batch / background — see ``repro_torch.engine.traces.SLO_CLASSES``) and the report
breaks TTFT, attainment against the *class's own* TTFT target, shed counts,
and goodput out per class. ``goodput_tok_s`` counts only tokens of finished
requests that met their class TTFT target — throughput that arrived too
late to matter is not good throughput.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional

import numpy as np

from repro_torch.engine.request import Request, RState
from repro_torch.engine.traces import DEFAULT_SLO_CLASS, SLO_CLASSES


def pct(xs: Iterable[float], q: float) -> float:
    xs = sorted(xs)
    if not xs:
        return float("nan")
    return float(np.percentile(xs, q))


@dataclasses.dataclass
class ServingReport:
    n_requests: int
    n_finished: int
    ttft_avg: float
    ttft_p50: float
    ttft_p95: float
    ttft_p99: float
    tpot_avg: float
    tpot_p95: float
    tpot_p99: float
    slo_violations: int
    slo_violation_rate: float
    throughput_tok_s: float
    preemptions: int
    degraded_token_frac: float
    kv_peak_usage: float
    kv_peak_blocks: int
    queue_delay_p95: float
    # terminal rejects (unservable prompts — never admitted, counted as
    # violations so a FAILED request can't improve the SLO picture)
    n_failed: int = 0
    # requests still in a non-terminal state when the report was built —
    # the chaos bench's no-hung-requests invariant gates on this being 0
    n_hung: int = 0
    # cluster failovers: logical requests re-dispatched after a replica
    # death, drain, or fencing (0 for single-engine runs)
    n_redispatched: int = 0
    # cluster failovers resolved by KV migration instead of recompute
    # re-dispatch: the request resumed mid-stream on a peer, no re-prefill
    n_migrated: int = 0
    # shared-prefix KV cache (0/absent when the cache is off)
    prefix_hit_rate: float = 0.0
    prefill_tokens_saved: int = 0
    # --- overload admission control / SLO classes ------------------------
    # terminal SHED outcomes (refused by admission control; counted as
    # violations like FAILED — shedding is honest, not free)
    n_shed: int = 0
    # tokens/s from finished requests that met their class TTFT target
    goodput_tok_s: float = 0.0
    # scheduler starvation audit (CI-gated zero): aged batch/background
    # candidates bypassed by a later admission in the same round
    starvation_bypasses: int = 0
    # per-class breakdown keyed by class name; values hold n, n_finished,
    # n_shed, n_failed, ttft_p50/p95, slo_attainment (finished within the
    # class TTFT target / all non-FAILED submissions), goodput_tok_s
    class_stats: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)

    def row(self) -> str:
        return (f"ttft_p95={self.ttft_p95:.3f}s slo_viol={self.slo_violation_rate:.2%} "
                f"tpot_avg={self.tpot_avg*1e3:.1f}ms thpt={self.throughput_tok_s:.0f}tok/s "
                f"preempt={self.preemptions} degraded_tok={self.degraded_token_frac:.2%}")

    def class_table(self) -> str:
        """Human-readable per-class SLO summary (CI prints this on a failed
        serving-smoke gate)."""
        hdr = (f"{'class':<12} {'n':>5} {'fin':>5} {'shed':>5} {'fail':>5} "
               f"{'ttft_p95':>9} {'attain':>7} {'goodput':>9}")
        lines = [hdr, "-" * len(hdr)]
        for name, s in sorted(self.class_stats.items()):
            lines.append(
                f"{name:<12} {int(s['n']):>5} {int(s['n_finished']):>5} "
                f"{int(s['n_shed']):>5} {int(s['n_failed']):>5} "
                f"{s['ttft_p95']:>9.3f} {s['slo_attainment']:>7.2%} "
                f"{s['goodput_tok_s']:>9.1f}")
        return "\n".join(lines)


def _class_ttft_target(name: str, fallback: float) -> float:
    slo = SLO_CLASSES.get(name)
    return slo.ttft_slo_s if slo is not None else fallback


def build_report(requests: List[Request], *, ttft_slo_s: float,
                 duration_s: float, history=None,
                 prefix_hit_rate: float = 0.0,
                 prefill_tokens_saved: int = 0,
                 n_redispatched: int = 0,
                 n_migrated: int = 0,
                 starvation_bypasses: int = 0) -> ServingReport:
    fin = [r for r in requests if r.state == RState.FINISHED]
    failed = sum(1 for r in requests if r.state == RState.FAILED)
    shed = sum(1 for r in requests if r.state == RState.SHED)
    hung = sum(1 for r in requests
               if r.state not in (RState.FINISHED, RState.FAILED,
                                  RState.SHED))
    ttfts = [r.ttft() for r in fin if r.ttft() is not None]
    tpots = [t for r in fin for t in r.tpots()]
    n_tok = sum(len(r.generated) for r in requests)
    viol = sum(1 for t in ttfts if t > ttft_slo_s)
    # terminally-failed and shed requests always violate: refusing work is
    # honest accounting, not a way to launder the SLO picture
    viol += failed + shed
    # unserved/unfinished requests whose wait already exceeds SLO also violate
    # (a request still short of its SLO window at the horizon is NOT a
    # violation — it simply hasn't been waiting long enough yet)
    for r in requests:
        if (r.state not in (RState.FINISHED, RState.FAILED, RState.SHED)
                and r.first_token_s is None
                and duration_s - r.arrival_s > ttft_slo_s):
            viol += 1
    deg = [r.degraded_token_frac() for r in fin] or [0.0]
    kv_peak = max((t.kv_usage for t in history), default=0.0) if history else 0.0
    kv_peak_blocks = max((t.kv_used_blocks for t in history), default=0) \
        if history else 0
    qd = [t.oldest_wait_s for t in history] if history else [0.0]
    # --- per-class breakdown + goodput -----------------------------------
    goodput_tok = 0
    class_stats: Dict[str, Dict[str, float]] = {}
    by_class: Dict[str, List[Request]] = {}
    for r in requests:
        by_class.setdefault(r.slo_class or DEFAULT_SLO_CLASS, []).append(r)
    for name, rs in by_class.items():
        target = _class_ttft_target(name, ttft_slo_s)
        cfin = [r for r in rs if r.state == RState.FINISHED]
        cttfts = [r.ttft() for r in cfin if r.ttft() is not None]
        good = [r for r in cfin
                if r.ttft() is not None and r.ttft() <= target]
        ctok = sum(len(r.generated) for r in good)
        goodput_tok += ctok
        n_eligible = sum(1 for r in rs if r.state != RState.FAILED)
        class_stats[name] = {
            "n": float(len(rs)),
            "n_finished": float(len(cfin)),
            "n_shed": float(sum(1 for r in rs if r.state == RState.SHED)),
            "n_failed": float(sum(1 for r in rs if r.state == RState.FAILED)),
            "ttft_p50": pct(cttfts, 50),
            "ttft_p95": pct(cttfts, 95),
            "slo_attainment": len(good) / max(n_eligible, 1),
            "goodput_tok_s": ctok / duration_s,
        }
    return ServingReport(
        n_requests=len(requests), n_finished=len(fin),
        ttft_avg=float(np.mean(ttfts)) if ttfts else float("nan"),
        ttft_p50=pct(ttfts, 50), ttft_p95=pct(ttfts, 95),
        ttft_p99=pct(ttfts, 99),
        tpot_avg=float(np.mean(tpots)) if tpots else float("nan"),
        tpot_p95=pct(tpots, 95), tpot_p99=pct(tpots, 99),
        slo_violations=viol,
        slo_violation_rate=viol / max(len(requests), 1),
        throughput_tok_s=n_tok / duration_s,
        preemptions=sum(r.preemptions for r in requests),
        degraded_token_frac=float(np.mean(deg)),
        kv_peak_usage=kv_peak, kv_peak_blocks=kv_peak_blocks,
        queue_delay_p95=pct(qd, 95),
        n_failed=failed,
        n_hung=hung,
        n_redispatched=n_redispatched,
        n_migrated=n_migrated,
        prefix_hit_rate=prefix_hit_rate,
        prefill_tokens_saved=prefill_tokens_saved,
        n_shed=shed,
        goodput_tok_s=goodput_tok / duration_s,
        starvation_bypasses=starvation_bypasses,
        class_stats=class_stats)
