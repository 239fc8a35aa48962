"""The readings a cell's correctness limit is set from, on the card.

    python3 servebench/control.py --workload <cell> --seeds 11 12 13 [--seconds 51] --out <file>

Run from the root of a checkout, on one card. For each seed, one process
serves the cell as a run does (its set-up, lead-in and a window of
``--seconds`` at the cell's own load), reads the program's widest logit gap
over the check's sample, and the control's: the plain
reference computed in float8 e4m3 (the precision step below bf16) in the
program's place, read at the same positions of the same prompts and
served tokens (``check.gaps(control=True)``). Writes one JSON object per
seed to ``--out``. The limit in the configuration file lies between the
program's largest reading and the control's smallest.
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
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--out", required=True)
    a = ap.parse_args(argv)
    repo = Path.cwd()
    sys.path[:0] = [str(repo), str(repo / "src")]
    import torch
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    from servebench import bench, check, weights
    card = bench.card_info()
    for seed in a.seeds:
        t = time.perf_counter()
        out = bench.serve(repo, a.workload, seed, a.seconds, False,
                          time.perf_counter(), device="cuda")
        row = {"workload": a.workload, "seed": seed, "seconds": a.seconds,
               "program_widest": out["widest"],
               "program_tokens": len(out["gaps"]),
               "program_gaps": out["gaps"],
               "e2e": {k: v for k, v in out["e2e"].items()
                       if not k.startswith("_")},
               "card": card["kind"], "power_limit_w": card["power_limit_w"]}
        model = out["cell"].config["model"]
        layers = [p for _, p in weights.layer_list(out["params"],
                                                   out["segments"])]
        misc = {k: v for k, v in out["params"].items()
                if k != "segments"}
        ck = out["cell"].config["check"]
        g = check.gaps(model, layers, misc, out["picked"], out["rank"],
                       "cuda", control=True,
                       alt_margin=ck.get("route_alt_margin"))
        row["control_widest"] = max((d for d, _ in g), default=None)
        row["control_gaps"] = g
        row["control_share_off_top"] = (sum(1 for d, _ in g if d > 0)
                                        / len(g) if g else None)
        del layers, misc
        row["took_s"] = time.perf_counter() - t
        print(json.dumps(row), flush=True)
        with open(a.out, "a") as f:
            f.write(json.dumps(row) + "\n")
        del out
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
