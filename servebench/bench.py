"""One run of one cell: build the engine, warm it, serve the mix open-loop
on the wall clock, measure, and check what was served.

The window drives ``repro_torch.engine.engine.MorphServeEngine`` with real
compute. Requests are submitted when due; before each ``step()`` the
engine's clock (``engine.now``) is set to the wall time since the traffic
began (the engine keeps a virtual clock, and this is the one seam it
offers; nothing else is written into it); when nothing is live the loop
sleeps until the next request is due. Every step ends in the host copy of
its argmax, so the wall time read after it is when that step's tokens were
delivered. Every latency is the harness's own stamp from the request's due
time; the engine's ``first_token_s``, ``token_times`` and report are never
read. A lead-in of traffic runs before the window, so the window opens on a
loaded engine; requests due in it are served but not counted.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

from servebench import check, rooflines, traffic, weights
from servebench.reference import model as refmodel

ROOT = Path(__file__).resolve().parent


# ---------------------------------------------------------------------------
# Data, found by name
# ---------------------------------------------------------------------------
def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    config: Dict
    mix: Dict
    knee: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]


def load_cell(repo: Path, workload: str) -> Cell:
    """The cell ``workload`` of ``repo``'s BENCHMARK.json with its
    configuration, mix and knee files."""
    bench = load_json(repo / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; have "
                         f"{sorted(cells)}")
    w = cells[workload]
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])
    here = repo / "servebench"
    config = load_json(repo / conf["file"])
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    per = [m for m in bench["per_layer"]
           if workload in m.get("workloads", [workload])]
    return Cell(workload, config, load_json(here / "mixes" /
                                            f"{w['traffic']}.json"),
                load_json(here / "knees" / f"{w['config']}.json"), e2e, per)


def port_configs(conf: Dict):
    """The port's ModelConfig, ServingConfig and EngineConfig of a
    configuration file."""
    from repro_torch.configs.base import (MLAConfig, MoEConfig, ModelConfig,
                                          ServingConfig)
    from repro_torch.engine import cost_model
    from repro_torch.engine.engine import EngineConfig
    m = dict(conf["model"])
    mla = m.pop("mla", None)
    moe = m.pop("moe", None)
    cfg = ModelConfig(**m, mla=MLAConfig(**mla) if mla else None,
                      moe=MoEConfig(**moe) if moe else None)
    s = dict(conf["serving"])
    s["swap_levels"] = tuple(s["swap_levels"])
    serving = ServingConfig(**s)
    e = dict(conf["engine"])
    e["hw"] = getattr(cost_model, e["hw"])
    return cfg, serving, EngineConfig(**e)


# ---------------------------------------------------------------------------
# Per-request bookkeeping
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Track:
    req: traffic.Req
    r: object                       # the engine's Request
    submitted: float                # window time it was submitted
    delivered: int = 0
    first_t: Optional[float] = None
    win_n: int = 0
    win_first: Optional[float] = None
    win_last: Optional[float] = None
    w: int = 0                      # positions written, this epoch
    chunks: int = 0
    epoch: int = 0
    segments: Dict[int, List[List[int]]] = dataclasses.field(
        default_factory=lambda: {0: []})
    tok_epoch: List[int] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class StepRec:
    t0: float
    t1: float
    kind: str                       # decode | mixed | idle
    level: int
    out: int = 0
    degraded: int = 0
    flops: float = 0.0
    decode_pos: List[int] = dataclasses.field(default_factory=list)
    chunk_calls: List = dataclasses.field(default_factory=list)


class Recorder:
    """Folds each step's effect on the requests it touched into the
    tracks and a step record."""

    def __init__(self, model: Dict, kinds: List[str], window_s: float):
        self.model = model
        self.kinds = kinds
        self.W = window_s
        self.by_rid: Dict[int, Track] = {}
        self.steps: List[StepRec] = []
        from repro_torch.engine.request import RState
        self.RS = RState

    def update(self, tr: Track, rec: StepRec, segs: List) -> None:
        r, RS = tr.r, self.RS
        if r.preemptions != tr.epoch:
            tr.epoch = r.preemptions
            tr.w = 0
            tr.segments[tr.epoch] = []
        st = r.state
        n_prompt = len(r.prompt)
        if st == RS.PREFILLING:
            w = r.prefill_pos
        elif st in (RS.RUNNING, RS.FINISHED):
            w = n_prompt + len(r.generated) - 1
        else:
            w = 0
        if w > tr.w:
            seg = tr.segments[tr.epoch]
            if seg and seg[-1][1] == tr.w and seg[-1][2] == rec.level:
                seg[-1][1] = w
            else:
                seg.append([tr.w, w, rec.level])
            segs.append((tr.w, w - tr.w))
            if tr.w < n_prompt:
                if r.prefill_chunks > tr.chunks:
                    rec.chunk_calls.append((tr.w, min(w, n_prompt) - tr.w))
                rec.kind = "mixed"
            elif rec.kind == "idle":
                rec.kind = "decode"
            if st in (RS.RUNNING, RS.FINISHED) and w - 1 >= n_prompt:
                rec.decode_pos.append(w - 1)
            tr.w = w
        tr.chunks = r.prefill_chunks
        count = n_prompt + len(r.generated) - len(tr.req.prompt)
        if count > tr.delivered:
            new = count - tr.delivered
            t = rec.t1
            if tr.first_t is None:
                tr.first_t = t
            tr.tok_epoch.extend([tr.epoch] * new)
            tr.delivered = count
            rec.out += new
            if rec.level > 0:
                rec.degraded += new
            if 0.0 <= t < self.W:
                tr.win_n += new
                if tr.win_first is None:
                    tr.win_first = t
                tr.win_last = t

    def fold(self, touched, rec: StepRec) -> None:
        segs: List = []
        for r in touched:
            self.update(self.by_rid[r.rid], rec, segs)
        if segs:
            rec.flops = rooflines.step_model_flops(
                self.model, self.kinds, [], segs, rec.out)
        self.steps.append(rec)


# ---------------------------------------------------------------------------
# End-to-end metrics (harness wall clock, from each request's due time)
# ---------------------------------------------------------------------------
def p95(xs: List[float]) -> float:
    """Nearest-rank 95th percentile."""
    s = sorted(xs)
    return s[max(math.ceil(0.95 * len(s)) - 1, 0)]


def end_to_end(tracks: List[Track], W: float, slo_s: float, RS) -> Dict:
    ttft, met, counted, failed = [], 0, 0, 0
    for tr in tracks:
        if not 0.0 <= tr.req.due_s < W:
            continue
        bad = tr.r.state in (RS.FAILED, RS.SHED)
        failed += bad
        if bad:
            t = math.inf
        elif tr.first_t is not None and tr.first_t < W:
            t = tr.first_t - tr.req.due_s
        elif W - tr.req.due_s > slo_s:
            t = math.inf               # no first token, already past the limit
        else:
            continue                   # still inside the limit at close
        counted += 1
        ttft.append(t)
        met += t <= slo_s
    tpot = [(tr.win_last - tr.win_first) / (tr.win_n - 1) * 1e3
            for tr in tracks if tr.win_n >= 2]
    out_tok = sum(tr.win_n for tr in tracks)
    return {"ttft_p95_s": p95(ttft) if ttft else math.inf,
            "tpot_p95_ms": p95(tpot) if tpot else math.inf,
            "slo_attain": met / counted if counted else 0.0,
            "out_tok_per_s": out_tok / W,
            "_counted": counted, "_failed": failed, "_tpot_n": len(tpot),
            "_out_tokens": out_tok}


# ---------------------------------------------------------------------------
# The run
# ---------------------------------------------------------------------------
def log(msg: str) -> None:
    print(f"[servebench] {msg}", file=sys.stderr, flush=True)


def card_info() -> Dict:
    """The card's name, count and power limit (nvidia-smi reads it)."""
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20)
        info["power_limit_w"] = float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        info["power_limit_w"] = None
    return info


def warm(engine, cfg, serving, ecfg, levels, max_tokens: int) -> None:
    """Run every shape this cell's traffic reaches once, at each level in
    ``levels``, on the scratch block: decode at each power-of-two table
    width up to the longest request, whole-prompt prefill of the batch at
    each padded length, and a chunk at each padded length."""
    from repro_torch.engine import model_exec as mx
    ex, pool, dev = engine.exec, engine.pool, engine.device
    bs = serving.kv_block_size
    slots = serving.max_batch_slots
    P = ecfg.max_prefills_per_step
    widths, w = [], 1
    while w <= mx.pad_bucket(-(-max_tokens // bs) + 1, 1):
        widths.append(min(w, engine.max_nb))
        w *= 2
    lens, L = [], bs
    while L <= mx.pad_bucket(ecfg.max_tokens_per_step, bs):
        lens.append(L)
        L *= 2
    z = dict(dtype=torch.int32, device=dev)
    for level in levels:
        ll = engine.actuator.layer_list(level)
        for nb in sorted(set(widths)):
            ex.decode(ll, torch.zeros((slots, 1), **z),
                      torch.zeros((slots,), **z), pool.k, pool.v,
                      torch.zeros((slots, nb), **z), engine.ssm_conv,
                      engine.ssm_ssm, None)
        for Sp in lens:
            ex.prefill_batch(ll, torch.zeros((P, Sp), **z), pool.k, pool.v,
                             torch.zeros((P, Sp // bs), **z),
                             torch.ones((P,), **z))
            nb_t = mx.pad_bucket(-(-(bs + Sp) // bs), 1)
            ex.prefill_chunk(ll, torch.zeros((1, Sp), **z), bs, pool.k,
                             pool.v, torch.zeros((nb_t,), **z), None)
        if dev.type == "cuda":
            torch.cuda.synchronize()


def build(conf: Dict, seed: int, device: str, params=None, plan=None):
    """The port's configs, the seeded weights and a fresh engine. Given
    ``params`` and ``plan`` of an earlier engine, the weights are not made
    again and the engine books that swap plan instead of quantizing the
    layers again."""
    from repro_torch.engine.engine import MorphServeEngine
    from repro_torch.models import lm
    model = conf["model"]
    cfg, serving, ecfg = port_configs(conf)
    kinds = refmodel.kinds(model)
    if list(lm.layer_kinds(cfg)) != kinds:
        raise AssertionError(f"layer kinds differ: port "
                             f"{lm.layer_kinds(cfg)} vs {kinds}")
    sync = (torch.cuda.synchronize if torch.device(device).type == "cuda"
            else (lambda: None))
    segments = lm.segment_plan(cfg)
    if params is None:
        t = time.perf_counter()
        params = weights.make(model, segments, seed, device)
        sync()
        log(f"weights {time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    engine = MorphServeEngine(cfg, params, serving, ecfg,
                              swap_order=list(conf["swap_order"]),
                              device=device, plan=plan)
    sync()
    log(f"engine (int4 variants of {cfg.n_layers} layers) "
        f"{time.perf_counter() - t:.2f} s; ladder {engine.plan.levels}, top "
        f"level {serving.max_level(cfg.n_layers)}; pool "
        f"{engine.pool.num_blocks - 1} blocks, capacity "
        f"{engine.pool.capacity}")
    return cfg, serving, ecfg, segments, params, engine


class Loop:
    """The open loop over one engine: ``run()`` serves ``reqs`` from
    window time -lead (the lead-in) to W, folding every step into ``rec``.
    With a ``span`` (a profiling.Span) it serves on past the close until
    the span, opened and closed at step boundaries as ``span_t``
    (``traffic.profile_span``) states, has ended; ``seen()`` names the
    events the span has held so far, and ``on_span(True | False)`` is
    called as it opens and closes."""

    def __init__(self, engine, reqs, W: float, lead: float,
                 rec: Recorder, span=None, span_t=None):
        self.engine, self.reqs, self.W, self.lead = engine, reqs, W, lead
        self.rec, self.span, self.span_t = rec, span, span_t
        self.lateness: List[float] = []
        self.origin = None
        self.span_state = "before"
        self.span_steps: List[StepRec] = []
        self.at_open = None            # callback at window open
        self.at_close = None           # callback at window close
        self.seen: Callable[[], set] = set
        self.on_span: Callable[[bool], None] = lambda on: None

    def now(self) -> float:
        return time.perf_counter() - self.origin

    def _span_tick(self, tau: float) -> bool:
        """Open or close the span at this step boundary; False once it
        has closed."""
        st = self.span_t
        if self.span_state == "before" and tau >= st["t0"]:
            self.span.start()
            self.span_state = "on"
            self.on_span(True)
        elif self.span_state == "on" and (
                tau >= st["t_max"] or (tau >= st["t_min"] and
                                       set(st["until"]) <= self.seen())):
            self.span.stop()
            self.span_state = "done"
            self.on_span(False)
        return self.span_state != "done"

    def run(self) -> None:
        from repro_torch.engine.traces import TraceRequest
        eng, rec, reqs, W, lead = (self.engine, self.rec, self.reqs, self.W,
                                   self.lead)
        end = W if self.span is None else self.span_t["t_max"] + 1.0
        nxt = 0
        self.origin = time.perf_counter() + lead
        opened = closed = False
        while True:
            tau = self.now()
            if not opened and tau >= 0.0:
                opened = True
                if self.at_open is not None:
                    self.at_open()
            if not closed and tau >= W:
                closed = True
                if self.at_close is not None:
                    self.at_close()
            if tau >= end or (self.span is not None and tau >= W
                              and not self._span_tick(tau)):
                break
            while nxt < len(reqs) and reqs[nxt].due_s <= tau:
                q = reqs[nxt]
                r = eng.submit(TraceRequest(q.due_s + lead, len(q.prompt),
                                            q.out_len,
                                            prompt_tokens=tuple(q.prompt)))
                rec.by_rid[r.rid] = Track(q, r, tau)
                if 0.0 <= q.due_s < W:
                    self.lateness.append(tau - q.due_s)
                nxt += 1
            if not eng.running and not eng.queue:
                due = reqs[nxt].due_s if nxt < len(reqs) else end
                wake = W if tau < W else end
                time.sleep(max(min(due, wake) - tau, 0.0))
                continue
            before = eng.running
            level = eng.actuator.level
            eng.now = tau + lead
            t0 = self.now()
            eng.step()
            t1 = self.now()
            touched = {id(r): r for r in before}
            for r in eng.running:
                touched[id(r)] = r
            step = StepRec(t0, t1, "idle", level)
            rec.fold(touched.values(), step)
            if self.span_state == "on":
                self.span_steps.append(step)
        if self.span_state == "on":
            self.span.stop()
            self.span_state = "done"
            self.on_span(False)


def serve(repo: Path, workload: str, seed: int, seconds: float, trace: bool,
          t_start: float, device: str = "cuda",
          fault: Optional[Callable] = None) -> Dict:
    """One run; returns what the result line is made of. ``fault``, for
    the benchmark's own tests, is called with the engine before the window
    to break the timed path underneath."""
    cell = load_cell(repo, workload)
    conf, mix, knee = cell.config, cell.mix, cell.knee
    model = conf["model"]
    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    W = float(seconds)
    lead = float(mix["lead_in_s"])
    cfg, serving, ecfg, segments, params, engine = build(conf, seed, device)
    kinds = refmodel.kinds(model)
    order = list(conf["swap_order"])
    top = serving.max_level(cfg.n_layers)
    reqs = traffic.requests(mix, knee, W, seed, cfg.vocab)
    longest = max(len(q.prompt) + q.out_len for q in reqs)
    t = time.perf_counter()
    warm(engine, cfg, serving, ecfg, sorted({0, top}), longest)
    log(f"warm-up {time.perf_counter() - t:.2f} s")
    span = None
    if trace:
        from servebench import profiling
        span = profiling.Span(sync, on_card)
        log(f"profiler warm-up {span.warm_up():.2f} s")
    if fault is not None:
        fault(engine)

    # --- counters the port keeps, and the K1 spy of the traced span -------
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import paged_attention as kpa
    from repro_torch.kernels import wna16_gemm as kw
    from repro_torch.models import moe as kmoe

    def counters():
        return (dict(kw.wna16_gemm.launches_by_shape),
                dict(kpa.paged_decode.launches_by_nb),
                kpa.paged_chunk.launches, kpa.paged_chunk_mla.launches,
                kmoe.moe_apply.host_syncs, len(engine.actuator.swap_log),
                len(engine.resize_log))
    rec = Recorder(model, kinds, W)
    loop = Loop(engine, reqs, W, lead, rec, span,
                traffic.profile_span(mix, W))
    opened = {}

    def at_open():
        opened["setup_s"] = loop.origin - t_start
        opened["counters"] = counters()
    loop.at_open = at_open
    loop.at_close = lambda: opened.update(close=counters())
    k1_calls: List = []
    orig_wna16 = kops.wna16_matmul

    def wna16_spy(x2, qt, **kw_):
        k1_calls.append((x2.shape[0], qt.K, qt.N, qt.bits, qt.group,
                         x2.element_size()))
        return orig_wna16(x2, qt, **kw_)

    def on_span(on: bool) -> None:
        kops.wna16_matmul = wna16_spy if on else orig_wna16
    loop.on_span = on_span
    loop.seen = lambda: (({"k1"} if k1_calls else set())
                         | ({"chunk"} if any(s.chunk_calls for s in
                                             loop.span_steps) else set()))
    try:
        loop.run()
    finally:
        kops.wna16_matmul = orig_wna16
    sync()
    peak = torch.cuda.max_memory_allocated() if on_card else 0

    # --- what the window measured -----------------------------------------
    tracks = list(rec.by_rid.values())
    RS = rec.RS
    e2e = end_to_end(tracks, W, serving.ttft_slo_s, RS)
    setup_s = opened.get("setup_s")
    e2e["setup_s"] = setup_s
    attempted = sum(1 for tr in tracks if 0.0 <= tr.req.due_s < W)
    log(f"setup_s {setup_s:.3f}; window {W:.0f} s: {attempted} requests "
        f"due, {e2e['_counted']} decided, {e2e['_failed']} failed, "
        f"{e2e['_out_tokens']} tokens delivered, {e2e['_tpot_n']} with >= 2; "
        f"steps {sum(1 for s in rec.steps if 0 <= s.t0 < W)}")
    if loop.lateness:
        lt = sorted(loop.lateness)
        log(f"generator lateness (submit - due), ms: median "
            f"{lt[len(lt) // 2] * 1e3:.1f}, p95 {p95(lt) * 1e3:.1f}, max "
            f"{lt[-1] * 1e3:.1f} over {len(lt)} requests")
    c0, c1 = opened.get("counters"), opened.get("close", counters())
    if c0 is not None:
        k1 = {f"{k[0]}x{k[1]}@{k[2]}": v - c0[0].get(k, 0)
              for k, v in c1[0].items() if v - c0[0].get(k, 0)}
        k2 = {k: v - c0[1].get(k, 0) for k, v in c1[1].items()
              if v - c0[1].get(k, 0)}
        log(f"window counters: K1 launches by (K x N @ M bucket) {k1}; "
            f"K2 by table width {k2}; K3 {c1[2] - c0[2]}, K3-mla "
            f"{c1[3] - c0[3]}; MoE host syncs {c1[4] - c0[4]}")
        swaps = engine.actuator.swap_log[c0[5]:c1[5]]
        resizes = engine.resize_log[c0[6]:c1[6]]
        log(f"window swaps (engine s, from, to): "
            f"{[(round(a - lead, 2), b, c) for a, b, c, _ in swaps]}; "
            f"resizes {[(round(a - lead, 2), b) for a, b in resizes]}")
    hist = [(h.time_s - lead, h.kv_used_blocks, h.kv_total_blocks)
            for h in engine.monitor.history]

    # --- the run's record for the per-layer readers -------------------------
    run = {"window_s": W, "steps": [s for s in rec.steps if 0 <= s.t0 < W],
           "kv_history": [h for h in hist if 0 <= h[0] < W],
           "peak_bytes": peak, "model": model, "kinds": kinds,
           "block_size": serving.kv_block_size, "trace": None,
           "k1_calls": k1_calls, "span_steps": [], "e2e": e2e}
    if span is not None and loop.span_state == "done":
        t = time.perf_counter()
        run["trace"] = span.summarize()
        run["span_steps"] = loop.span_steps
        log(f"profiled span {span.t0 - loop.origin:.2f}-"
            f"{span.t1 - loop.origin:.2f} s (window time; the window closed "
            f"at {W:.0f} s): start {span.start_cost:.3f} s, stop "
            f"{span.stop_cost:.3f} s, {run['trace']['events']} device "
            f"events, summary {time.perf_counter() - t:.2f} s; held "
            f"{sorted(loop.seen())}, levels "
            f"{sorted({x.level for x in loop.span_steps})}")
        for kind in ("decode", "mixed"):
            a = [x.t1 - x.t0 for x in run["steps"] if x.kind == kind]
            b = [x.t1 - x.t0 for x in loop.span_steps if x.kind == kind]
            if a and b:
                log(f"trace overhead: {kind} steps {len(b)} in the span at "
                    f"{sum(b) / len(b) * 1e3:.1f} ms, {len(a)} in the "
                    f"untraced window at {sum(a) / len(a) * 1e3:.1f} ms")

    # --- free the program's state, then the check ---------------------------
    finished = [check.Served(list(tr.req.prompt),
                             tr.r.logical_stream()[:tr.delivered],
                             list(tr.tok_epoch),
                             {e: [list(s) for s in v]
                              for e, v in tr.segments.items()})
                for tr in tracks if tr.r.state == RS.FINISHED]
    n_open = len(tracks) - len(finished)
    del engine, rec, tracks, loop
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    picked = check.sample(finished, seed, conf["check"]["sample_min_tokens"],
                          conf["check"]["sample_max_requests"])
    rank = [len(order)] * cfg.n_layers
    for i, l in enumerate(order):
        rank[l] = i
    layers = [p for _, p in weights.layer_list(params, segments)]
    misc = {k: v for k, v in params.items() if k != "segments"}
    ck = conf["check"]
    g = check.gaps(model, layers, misc, picked, rank, device,
                   alt_margin=ck.get("route_alt_margin"))
    widest = max((d for d, _ in g), default=None)
    limit = ck["max_gap_limit"]
    correct, why = check.verdict(widest, limit)
    tau = ck.get("route_alt_margin")
    near = sum(1 for _, m in g if tau is not None and m < tau)
    log(f"check: {len(picked)} of {len(finished)} finished requests "
        f"({n_open} open at close), {len(g)} served tokens"
        + (f", {near} routed within {tau} of a tie" if tau else "")
        + f", reference {time.perf_counter() - t:.2f} s")
    return {"cell": cell, "e2e": e2e, "run": run, "correct": correct,
            "why": why, "widest": widest, "limit": limit, "gaps": g,
            "attempted": attempted, "failed": e2e["_failed"],
            "peak": peak, "params": params, "segments": segments,
            "picked": picked, "rank": rank}
