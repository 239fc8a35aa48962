"""Workload trace generators shaped like the paper's two traces (§4).

* ``azure_like``  — Azure LLM Inference 2023: moderate base rate with sharp,
  short conversational spikes and heavy-tailed prompt lengths.
* ``burstgpt_like`` — BurstGPT (campus traffic): strong burst episodes
  (Gamma-distributed burst sizes) on top of a diurnal-ish modulation.

Both are deterministic given a seed and emit (arrival_s, prompt_len,
max_new_tokens) tuples over a configurable window (paper uses 72 s snippets),
downscalable with a rate factor like the paper's 1.75x / 4.75x.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class SLOClass:
    """Per-class service objectives the scheduler and admission controller
    consume.

    ``ttft_slo_s`` is the class's first-token target (slack ordering and
    per-class attainment are measured against it); ``deadline_s`` is the hard
    admission bound — when the estimated queue delay pushes first-token past
    ``arrival + deadline_s`` with no morph-relief headroom left, the request
    is shed at the front door instead of timing out silently.
    ``age_after_s > 0`` opts the class into starvation-bounded aging: past
    that wait its priority rises continuously (``aging_rate`` per waited
    second of slack) until it outranks fresh interactive work.
    ``pressure_weight`` scales how strongly this class's queue wait drives
    morph relief and routing away from degraded replicas (interactive
    backlog escalates sooner; background soaks degraded capacity)."""
    name: str
    ttft_slo_s: float
    deadline_s: float
    age_after_s: float = 0.0
    aging_rate: float = 2.0
    pressure_weight: float = 1.0


SLO_CLASSES: Dict[str, SLOClass] = {
    "interactive": SLOClass("interactive", ttft_slo_s=2.0, deadline_s=6.0,
                            age_after_s=0.0, pressure_weight=1.0),
    "batch": SLOClass("batch", ttft_slo_s=10.0, deadline_s=40.0,
                      age_after_s=12.0, pressure_weight=0.3),
    "background": SLOClass("background", ttft_slo_s=30.0, deadline_s=120.0,
                           age_after_s=30.0, pressure_weight=0.1),
}
DEFAULT_SLO_CLASS = "interactive"


@dataclasses.dataclass(frozen=True)
class TraceRequest:
    arrival_s: float
    prompt_len: int
    max_new_tokens: int
    # explicit token content (shared-prefix workloads); None lets the engine
    # fabricate random tokens of prompt_len as before
    prompt_tokens: Optional[Tuple[int, ...]] = None
    # cluster-wide logical id, assigned by the dispatcher on first dispatch
    # and preserved verbatim across re-dispatch (failover keeps identity)
    request_id: Optional[int] = None
    # sim-compute token stream seed (None: the engine derives it from the
    # prompt at first submit); re-dispatch must carry the original so the
    # surviving replica continues the same logical stream
    token_seed: Optional[int] = None
    # original identity for re-dispatched requests whose prompt has already
    # absorbed generated tokens (recompute policy): None on first dispatch
    orig_prompt_len: Optional[int] = None
    orig_max_new_tokens: Optional[int] = None
    # service class: keys SLO_CLASSES (TTFT/deadline targets, aging,
    # pressure weight) for the scheduler and admission controller.
    # (Declared last so existing positional construction stays valid.)
    slo_class: str = DEFAULT_SLO_CLASS


def _lens(rng, n, p_mean, p_sigma, p_max, g_mean, g_sigma, g_max):
    p = np.clip(rng.lognormal(np.log(p_mean), p_sigma, n), 8, p_max)
    g = np.clip(rng.lognormal(np.log(g_mean), g_sigma, n), 4, g_max)
    return p.astype(int), g.astype(int)


def _thin_poisson(rng, duration, rate_fn, max_rate):
    """Non-homogeneous Poisson arrivals by thinning."""
    t, out = 0.0, []
    while t < duration:
        t += rng.exponential(1.0 / max_rate)
        if t < duration and rng.random() < rate_fn(t) / max_rate:
            out.append(t)
    return np.array(out)


def azure_like(duration_s: float = 72.0, base_rps: float = 2.0,
               rate_scale: float = 1.0, seed: int = 0,
               prompt_mean: int = 512, gen_mean: int = 256,
               prompt_max: int = 2048, gen_max: int = 512
               ) -> List[TraceRequest]:
    rng = np.random.default_rng(seed)
    n_spikes = max(int(duration_s / 18), 1)
    centers = rng.uniform(0, duration_s, n_spikes)
    heights = rng.uniform(3.0, 8.0, n_spikes) * base_rps

    def rate(t):
        r = base_rps
        for c, h in zip(centers, heights):
            r += h * np.exp(-0.5 * ((t - c) / 1.5) ** 2)
        return r * rate_scale

    max_rate = (base_rps + heights.sum()) * rate_scale + 1
    arr = _thin_poisson(rng, duration_s, rate, max_rate)
    p, g = _lens(rng, len(arr), prompt_mean, 0.6, prompt_max,
                 gen_mean, 0.5, gen_max)
    return [TraceRequest(float(a), int(pl), int(gl))
            for a, pl, gl in zip(arr, p, g)]


def burstgpt_like(duration_s: float = 72.0, base_rps: float = 1.5,
                  rate_scale: float = 1.0, seed: int = 0,
                  prompt_mean: int = 512, gen_mean: int = 256,
                  prompt_max: int = 2048, gen_max: int = 512
                  ) -> List[TraceRequest]:
    rng = np.random.default_rng(seed + 1)
    # burst episodes: Gamma-sized clumps of arrivals
    t, times = 0.0, []
    while t < duration_s:
        t += rng.exponential(1.0 / (base_rps * rate_scale))
        times.append(t)
        if rng.random() < 0.08:                      # burst episode
            burst = int(rng.gamma(shape=3.0, scale=4.0))
            times.extend(t + rng.uniform(0, 0.8, burst))
    arr = np.sort([x for x in times if x < duration_s])
    p, g = _lens(rng, len(arr), prompt_mean, 0.7, prompt_max,
                 gen_mean, 0.6, gen_max)
    return [TraceRequest(float(a), int(pl), int(gl))
            for a, pl, gl in zip(arr, p, g)]


def constant_rate(duration_s: float, rps: float, prompt_len: int = 512,
                  gen_len: int = 256, seed: int = 0) -> List[TraceRequest]:
    """Fixed-rate trace for the Fig. 6 throughput/saturation sweep."""
    rng = np.random.default_rng(seed)
    arr = _thin_poisson(rng, duration_s, lambda t: rps, rps + 1)
    return [TraceRequest(float(a), prompt_len, gen_len) for a in arr]


def shared_prefix_multiturn(duration_s: float = 30.0, n_conversations: int = 12,
                            turns_per_conv: int = 4, system_len: int = 256,
                            conv_header_len: int = 128, turn_len: int = 64,
                            tail_max: int = 96, gen_mean: int = 48,
                            gen_max: int = 128, vocab: int = 32000,
                            seed: int = 0) -> List[TraceRequest]:
    """Multi-turn chat workload with explicit token content (prefix reuse).

    Every request shares one global *system prompt* (``system_len`` tokens);
    each conversation adds its own few-shot *header*; turn ``t`` replays the
    conversation's accumulated history (``t * turn_len`` tokens) plus a fresh
    user tail — the dominant production pattern the prefix cache targets:
    within a conversation each turn's prompt is a strict extension of the
    previous one, and across conversations the system prompt is common.
    Arrivals: conversations start uniformly over the window, turns follow
    with think-time gaps.
    """
    rng = np.random.default_rng(seed)
    system = tuple(rng.integers(0, vocab, size=system_len).tolist())
    out: List[TraceRequest] = []
    for _ in range(n_conversations):
        header = tuple(rng.integers(0, vocab, size=conv_header_len).tolist())
        history: Tuple[int, ...] = ()
        t = float(rng.uniform(0, duration_s * 0.5))
        for _turn in range(turns_per_conv):
            tail_len = int(rng.integers(8, tail_max + 1))
            tail = tuple(rng.integers(0, vocab, size=tail_len).tolist())
            prompt = system + header + history + tail
            gen = int(np.clip(rng.lognormal(np.log(gen_mean), 0.4),
                              4, gen_max))
            out.append(TraceRequest(t, len(prompt), gen, prompt))
            # next turn's prompt extends this one: tail + a modeled reply
            history = history + tail + tuple(
                rng.integers(0, vocab, size=turn_len).tolist())
            t += float(rng.exponential(duration_s / (2 * turns_per_conv)))
            if t >= duration_s:
                break
    return sorted(out, key=lambda r: r.arrival_s)


DEFAULT_CLASS_MIX: Sequence[Tuple[str, float]] = (
    ("interactive", 0.5), ("batch", 0.3), ("background", 0.2))


def _class_lens(rng, cls: str):
    """Class-conditioned (prompt_len, gen_len): interactive traffic is short
    chat turns; batch is long-document work; background is long-prompt,
    long-generation offline jobs."""
    if cls == "interactive":
        p_mean, p_sig, p_max, g_mean, g_sig, g_max = 192, 0.5, 512, 96, 0.4, 192
    elif cls == "batch":
        p_mean, p_sig, p_max, g_mean, g_sig, g_max = 640, 0.5, 1536, 192, 0.4, 384
    else:
        p_mean, p_sig, p_max, g_mean, g_sig, g_max = 768, 0.6, 2048, 256, 0.5, 512
    p = int(np.clip(rng.lognormal(np.log(p_mean), p_sig), 8, p_max))
    g = int(np.clip(rng.lognormal(np.log(g_mean), g_sig), 4, g_max))
    return p, g


def mixed_class_traffic(duration_s: float = 36.0, base_rps: float = 2.0,
                        rate_scale: float = 1.0, seed: int = 0,
                        class_mix: Sequence[Tuple[str, float]] =
                        DEFAULT_CLASS_MIX) -> List[TraceRequest]:
    """Sustained mixed-class load: Poisson arrivals, each request drawing an
    SLO class from ``class_mix`` with class-conditioned lengths. Run above
    capacity this is THE admission-control scenario: FIFO queues interactive
    chat turns behind batch documents; the class-aware scheduler must not."""
    rng = np.random.default_rng(seed + 11)
    arr = _thin_poisson(rng, duration_s, lambda t: base_rps * rate_scale,
                        base_rps * rate_scale + 1)
    names = [c for c, _ in class_mix]
    probs = np.array([w for _, w in class_mix], float)
    probs /= probs.sum()
    out = []
    for a in arr:
        cls = names[int(rng.choice(len(names), p=probs))]
        p, g = _class_lens(rng, cls)
        out.append(TraceRequest(float(a), p, g, slo_class=cls))
    return out


def diurnal_ramp(duration_s: float = 72.0, low_rps: float = 0.3,
                 high_rps: float = 3.0, n_cycles: float = 1.5, seed: int = 0,
                 class_mix: Sequence[Tuple[str, float]] = DEFAULT_CLASS_MIX
                 ) -> List[TraceRequest]:
    """Diurnal-style ramp: the arrival rate sweeps low→high→low sinusoidally
    (``n_cycles`` day-cycles over the window), with the interactive share
    peaking on-peak and background dominating the troughs — overload arrives
    and *recedes*, so shedding must stop once the peak passes."""
    rng = np.random.default_rng(seed + 13)

    def rate(t):
        phase = 2 * np.pi * n_cycles * t / duration_s
        return low_rps + (high_rps - low_rps) * 0.5 * (1 - np.cos(phase))

    arr = _thin_poisson(rng, duration_s, rate, high_rps + 1)
    names = [c for c, _ in class_mix]
    base = np.array([w for _, w in class_mix], float)
    out = []
    for a in arr:
        peak = (rate(float(a)) - low_rps) / max(high_rps - low_rps, 1e-9)
        w = base.copy()
        for i, c in enumerate(names):       # on-peak: interactive-heavy
            if c == "interactive":
                w[i] *= 0.5 + 1.5 * peak
            elif c == "background":
                w[i] *= 1.5 - peak
        w /= w.sum()
        cls = names[int(rng.choice(len(names), p=w))]
        p, g = _class_lens(rng, cls)
        out.append(TraceRequest(float(a), p, g, slo_class=cls))
    return out


def long_prompt_flood(duration_s: float = 36.0, base_rps: float = 1.0,
                      flood_start_s: float = 8.0, flood_duration_s: float = 8.0,
                      flood_rps: float = 3.0, flood_prompt: int = 1536,
                      seed: int = 0) -> List[TraceRequest]:
    """Adversarial long-prompt flood: a steady interactive trickle, then a
    window of near-max-length batch prompts at high rate — the classic
    head-of-line attack on a FIFO admission queue. A robust scheduler keeps
    interactive TTFT flat through the flood; admission control sheds flood
    prompts whose deadlines are already unmeetable."""
    rng = np.random.default_rng(seed + 17)
    out = []
    for a in _thin_poisson(rng, duration_s, lambda t: base_rps, base_rps + 1):
        p, g = _class_lens(rng, "interactive")
        out.append(TraceRequest(float(a), p, g, slo_class="interactive"))
    t = flood_start_s
    while t < flood_start_s + flood_duration_s:
        t += float(rng.exponential(1.0 / flood_rps))
        if t >= min(flood_start_s + flood_duration_s, duration_s):
            break
        p = int(np.clip(rng.normal(flood_prompt, flood_prompt * 0.1),
                        flood_prompt // 2, flood_prompt * 2))
        out.append(TraceRequest(float(t), p,
                                int(rng.integers(32, 128)),
                                slo_class="batch"))
    return sorted(out, key=lambda r: r.arrival_s)


def multi_tenant_prefix_pollution(duration_s: float = 30.0,
                                  n_tenants: int = 8,
                                  requests_per_tenant: int = 6,
                                  system_len: int = 384, tail_max: int = 96,
                                  gen_mean: int = 48, gen_max: int = 128,
                                  vocab: int = 32000, seed: int = 0
                                  ) -> List[TraceRequest]:
    """Multi-tenant prefix pollution: every tenant has its own long system
    prompt, and tenants interleave — each admission's cached prefix is
    *another tenant's* garbage, so a naive prefix cache churns (insert,
    never hit, evict). Tenant 0 is an interactive chat tenant; the rest are
    batch/background scripted tenants hammering the cache."""
    rng = np.random.default_rng(seed + 19)
    out: List[TraceRequest] = []
    for tenant in range(n_tenants):
        system = tuple(rng.integers(0, vocab, size=system_len).tolist())
        cls = ("interactive" if tenant == 0
               else ("batch" if tenant % 2 else "background"))
        t = float(rng.uniform(0, duration_s * 0.2))
        for _ in range(requests_per_tenant):
            tail = tuple(rng.integers(
                0, vocab, size=int(rng.integers(8, tail_max + 1))).tolist())
            prompt = system + tail
            gen = int(np.clip(rng.lognormal(np.log(gen_mean), 0.4),
                              4, gen_max))
            out.append(TraceRequest(t, len(prompt), gen, prompt,
                                    slo_class=cls))
            t += float(rng.exponential(
                duration_s / (1.5 * requests_per_tenant)))
            if t >= duration_s:
                break
    return sorted(out, key=lambda r: r.arrival_s)


TRACES = {"azure": azure_like, "burstgpt": burstgpt_like,
          "shared_prefix": shared_prefix_multiturn,
          "mixed_class": mixed_class_traffic,
          "diurnal": diurnal_ramp,
          "long_prompt_flood": long_prompt_flood,
          "prefix_pollution": multi_tenant_prefix_pollution}
