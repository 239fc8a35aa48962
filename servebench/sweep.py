"""Find a configuration's knee on the card: the highest steady Poisson rate
at which the window's p95 TTFT stays within the limit (2 s) and no backlog
grows.

    python3 servebench/sweep.py --config <config> --rates 4 6 8 [--seconds 30]

Run from the root of a checkout, on one card. Each rate is served open-loop
by the harness's own loop (``bench.Loop``), lengths as in
``mixes/chat-steady.json``, after its lead-in, on a fresh engine that
books the first engine's swap plan. A rate's backlog grows when more than
two seconds of its arrivals are still waiting for a first token when the
window closes. Writes ``knees/<config>.json``: the knee, the highest swept
rate that also stayed at swap level 0 (the cap of ``chat-steady``), every
rate's readings, and the card's name and power limit.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402



def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--out", default=None,
                    help="where to write the knee (default: "
                         "servebench/knees/<config>.json)")
    a = ap.parse_args(argv)
    repo = Path.cwd()
    sys.path[:0] = [str(repo), str(repo / "src")]
    import torch
    if not torch.cuda.is_available():
        print("sweep: no CUDA card", file=sys.stderr)
        return 2
    from servebench import bench, traffic
    conf = bench.load_json(repo / "servebench" / "configs" /
                           f"{a.config}.json")
    mix = dict(bench.load_json(repo / "servebench" / "mixes" /
                               "chat-steady.json"),
               base_rate_knee=1.0, cap_to_no_swap=False, spikes=[])
    card = bench.card_info()
    params = plan = None
    rows = []
    slo = conf["serving"]["ttft_slo_s"]
    for rate in sorted(a.rates):
        cfg, serving, ecfg, segments, params, engine = bench.build(
            conf, a.seed, "cuda", params=params, plan=plan)
        plan = engine.plan
        reqs = traffic.requests(mix, {"knee_rps": rate}, a.seconds, a.seed,
                                cfg.vocab)
        if len(rows) == 0:
            top = serving.max_level(cfg.n_layers)
            longest = max(len(q.prompt) + q.out_len for q in reqs)
            bench.warm(engine, cfg, serving, ecfg, sorted({0, top}), longest)
        rec = bench.Recorder(conf["model"], [], a.seconds)
        loop = bench.Loop(engine, reqs, a.seconds, mix["lead_in_s"], rec)
        loop.run()
        torch.cuda.synchronize()
        tracks = list(rec.by_rid.values())
        e2e = bench.end_to_end(tracks, a.seconds, slo, rec.RS)
        waiting = sum(1 for tr in tracks if 0 <= tr.req.due_s < a.seconds
                      and (tr.first_t is None or tr.first_t >= a.seconds))
        W = a.seconds
        steps = [s for s in rec.steps if 0 <= s.t0 < W]
        levels = [s.level for s in steps]
        row = {"rps": rate, "ttft_p95_s": e2e["ttft_p95_s"],
               "tpot_p95_ms": e2e["tpot_p95_ms"],
               "slo_attain": e2e["slo_attain"],
               "out_tok_per_s": e2e["out_tok_per_s"],
               "waiting_at_close": waiting,
               "backlog_grows": waiting > 2.0 * rate,
               "max_level": max(levels, default=0),
               "steps": len(steps),
               "decode_step_ms": 1e3 * sum(s.t1 - s.t0 for s in steps
                                           if s.kind == "decode")
               / max(sum(1 for s in steps if s.kind == "decode"), 1),
               "mixed_step_ms": 1e3 * sum(s.t1 - s.t0 for s in steps
                                          if s.kind == "mixed")
               / max(sum(1 for s in steps if s.kind == "mixed"), 1)}
        rows.append(row)
        print(json.dumps(row), flush=True)
        del engine, rec, tracks, loop
        gc.collect()
        torch.cuda.empty_cache()
    ok = [r for r in rows if r["ttft_p95_s"] <= slo and not r["backlog_grows"]]
    knee = max((r["rps"] for r in ok), default=None)
    calm = max((r["rps"] for r in ok if r["max_level"] == 0), default=None)
    out = {"config": a.config, "knee_rps": knee, "highest_rps_no_swap": calm,
           "rule": "highest swept rate with p95 TTFT <= the limit and at "
                   "most two seconds of arrivals waiting at close",
           "swept": rows, "seconds": a.seconds, "seed": a.seed,
           "lengths_from": "chat-steady", "card": card["kind"],
           "power_limit_w": card["power_limit_w"],
           "took_s": time.perf_counter() - T_START}
    path = Path(a.out) if a.out else \
        repo / "servebench" / "knees" / f"{a.config}.json"
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: v for k, v in out.items() if k != "swept"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
