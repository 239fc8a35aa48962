"""The traffic generator: one general open-loop generator, driven by a mix file.

A mix (``mixes/<name>.json``) states its rates as multiples of the
configuration's knee (``knees/<config>.json``, the highest steady rate the
configuration sustains on the card, found once by ``sweep.py``), so the rate
a cell offers is a fixed number in the data of that cell. Its keys:

- ``lead_in_s``: traffic served before the window opens (not counted).
- ``base_rate_knee``: the base Poisson rate as a multiple of the knee.
- ``cap_to_no_swap``: lower the base rate to the highest swept rate at which
  the controller stayed at level 0 (``knees/<config>.json``), if that is less.
- ``spikes``: Gaussian surges ``{"at": share of the window, "height_base":
  peak above base as a multiple of base, "sigma_s": width}``; their centres
  are fixed points of the window, so every seed has them inside it.
- ``prompt`` / ``output``: lognormal lengths ``{"median", "sigma", "min",
  "max"}`` (the port's ``azure_like`` lengths, frozen here).
- ``arrival_seed``: the one draw of arrival times and lengths. Every run's
  ``--seed`` keeps the same arrivals and the same multiset of lengths and
  only permutes the lengths among the arrivals and draws the token ids, so
  all seeds offer the same work in another order.
- ``permute_lengths`` (default true): false keeps each arrival's lengths, so
  every seed offers the same work in the same order and draws only the
  token ids (and the weights). Past capacity the order decides which
  answers complete inside the window, so there a permutation changes the
  work.
- ``profile``: the span a traced run profiles, after the window has closed,
  so that no window metric is read while the device trace slows the host
  loop: ``{"start_after_close_s", "min_s", "max_s", "until", "spikes"}``.
  The span opens at the first step past ``start_after_close_s`` and closes
  at the first step past ``min_s`` at which it has held each event named in
  ``until`` (``"k1"``: a wNa16 GEMM launch, ``"chunk"``: a chunked-prefill
  call), or past ``max_s``. ``spikes`` are surges of the traffic after the
  close, ``{"after_close_s", "height_base", "sigma_s"}``. The schedule runs
  to the span's latest close; only a traced run serves past the window.

Lengths follow ``repro.engine.traces._lens`` and arrivals its
``_thin_poisson`` (copied here so the yardstick cannot move with the
program).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Tuple

import numpy as np


@dataclasses.dataclass
class Req:
    """One request of a run: due at ``due_s`` seconds after the window
    opens (negative in the lead-in)."""
    due_s: float
    prompt: List[int]
    out_len: int


def base_rate(mix: Dict, knee: Dict) -> float:
    """The base Poisson rate, requests a second."""
    rate = mix["base_rate_knee"] * knee["knee_rps"]
    if mix.get("cap_to_no_swap"):
        rate = min(rate, knee["highest_rps_no_swap"])
    return rate


def spikes(mix: Dict, window_s: float) -> List[Tuple[float, float, float]]:
    """Every surge of the mix as (centre s, peak above base as a multiple
    of base, sigma s): the window's, then those after its close."""
    out = [(s["at"] * window_s, s["height_base"], s["sigma_s"])
           for s in mix.get("spikes", ())]
    out += [(window_s + s["after_close_s"], s["height_base"], s["sigma_s"])
            for s in mix["profile"].get("spikes", ())]
    return out


def rate_fn(mix: Dict, knee: Dict, window_s: float) -> Callable[[float], float]:
    """Requests a second at time t (seconds from the window's opening)."""
    base = base_rate(mix, knee)
    spikes_ = [(c, h * base, sd) for c, h, sd in spikes(mix, window_s)]

    def rate(t: float) -> float:
        return base + sum(h * math.exp(-0.5 * ((t - c) / sd) ** 2)
                          for c, h, sd in spikes_)
    return rate


def _lens(rng, n: int, spec: Dict) -> np.ndarray:
    x = rng.lognormal(np.log(spec["median"]), spec["sigma"], n)
    return np.clip(x, spec["min"], spec["max"]).astype(int)


def _thin_poisson(rng, t0: float, t1: float, rate, max_rate: float):
    t, out = t0, []
    while t < t1:
        t += rng.exponential(1.0 / max_rate)
        if t < t1 and rng.random() < rate(t) / max_rate:
            out.append(t)
    return np.array(out)


def schedule(mix: Dict, knee: Dict, window_s: float
             ) -> List[Tuple[float, int, int]]:
    """The mix's fixed arrivals and lengths from -lead_in to the profiled
    span's latest close: (due_s, prompt_len, out_len), in due order, the
    same for every seed and for traced and untraced runs."""
    rng = np.random.default_rng(mix["arrival_seed"])
    rate = rate_fn(mix, knee, window_s)
    peak = base_rate(mix, knee) * (1 + sum(h for _, h, _ in
                                           spikes(mix, window_s)))
    span = profile_span(mix, window_s)
    due = _thin_poisson(rng, -float(mix["lead_in_s"]), span["t_max"], rate,
                        peak + 1.0)
    p = _lens(rng, len(due), mix["prompt"])
    g = _lens(rng, len(due), mix["output"])
    return [(float(d), int(a), int(b)) for d, a, b in zip(due, p, g)]


def requests(mix: Dict, knee: Dict, window_s: float, seed: int,
             vocab: int) -> List[Req]:
    """The run's requests: the fixed schedule, its (prompt, output) lengths
    permuted among the arrivals by ``seed`` (unless the mix keeps them),
    prompt tokens uniform over the vocabulary from ``seed``."""
    sched = schedule(mix, knee, window_s)
    rng = np.random.default_rng(seed)
    perm = (rng.permutation(len(sched)) if mix.get("permute_lengths", True)
            else range(len(sched)))
    lens = [(sched[i][1], sched[i][2]) for i in perm]
    toks = rng.integers(0, vocab, size=sum(p for p, _ in lens))
    out, at = [], 0
    for (due, _, _), (pl, gl) in zip(sched, lens):
        out.append(Req(due, toks[at:at + pl].tolist(), gl))
        at += pl
    return out


def profile_span(mix: Dict, window_s: float) -> Dict:
    """The traced run's span, in window time: opens at ``t0``, may close
    from ``t_min`` once it has held every event of ``until``, and closes at
    ``t_max`` at the latest."""
    pr = mix["profile"]
    t0 = window_s + pr["start_after_close_s"]
    return {"t0": t0, "t_min": t0 + pr["min_s"], "t_max": t0 + pr["max_s"],
            "until": tuple(pr.get("until", ()))}
