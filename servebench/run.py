"""Run one cell of the port's serving benchmark once.

    python3 servebench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. Prints the cell's end-to-end metrics
(``--trace 0``) or its per-layer metrics (``--trace 1``, with a device
profile of the mix's span) as one JSON object on the last line of standard
output; the numbers that decide ``correct`` are the last lines of standard
error and the last key of that object. Exits non-zero, printing no result,
without a CUDA card, and when JAX or the JAX package is loaded once the
window has closed.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def prepare(repo: Path) -> None:
    """Keep every build or kernel cache at a fixed path inside the
    checkout, and import the harness and the port from it."""
    cache = repo / ".servebench_cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(cache / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    sys.path[:0] = [str(repo), str(repo / "src")]


def forbidden_modules(modules=None):
    """Loaded modules (``sys.modules`` by default) whose top-level name is
    JAX's or the JAX package's, compared whole (``repro_torch`` is not
    ``repro``)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def read_metric(repo: Path, name: str, run: dict):
    """The per-layer metric ``name`` from ``servebench/metrics/<name>.py``
    (None when its reader finds nothing to read)."""
    path = repo / "servebench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "servebench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run)


def result_line(repo: Path, out: dict, trace: bool, device: dict) -> dict:
    """The result's object: the cell's end-to-end metrics (untraced) or
    its per-layer metrics (traced), with the compared numbers last."""
    cell = out["cell"]
    metrics = {}
    if trace:
        for m in cell.per_layer:
            v = read_metric(repo, m["name"], out["run"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": out["e2e"][m["name"]],
                                  "unit": m["unit"]}
    for v in metrics.values():
        if isinstance(v["value"], float) and not math.isfinite(v["value"]):
            v["value"] = 1e9           # infinitely late: JSON has no inf
    line = {"correct": out["correct"], "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics, "device": device}
    tr = out["run"]["trace"]
    if trace and tr:
        device["busy_s"] = tr["busy_s"]
        device["window_s"] = tr["window_s"]
        line["breakdown"] = {"device_ops": tr["device_ops"],
                             "idle_gaps": tr["idle_gaps"]}
    line["compared"] = {"widest_logit_gap": {"value": out["widest"],
                                             "limit": out["limit"]}}
    return line


def run_cell(repo: Path, workload: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda", fault=None) -> int:
    """Everything a run does past the look for a card: serve, measure,
    check, refuse a process that holds JAX, print. ``fault`` breaks the
    timed path underneath (the benchmark's own tests)."""
    from servebench import bench
    if device == "cuda":
        info = bench.card_info()
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1}
    out = bench.serve(repo, workload, seed % 2 ** 63, seconds, trace,
                      T_START, device=device, fault=fault)
    info["memory_peak_bytes"] = out["peak"]
    line = result_line(repo, out, trace, info)
    bad = forbidden_modules()
    if bad:
        print(f"servebench: loaded after the window: {bad}", file=sys.stderr)
        return 3
    for name, v in line["compared"].items():
        print(f"compared {name}: {v['value']} (limit {v['limit']})"
              + (f"; {out['why']}" if out["why"] else ""), file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    repo = Path.cwd()
    prepare(repo)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        print("servebench: no CUDA card; this benchmark runs only on one",
              file=sys.stderr)
        return 2
    return run_cell(repo, a.workload, a.seed, a.seconds, bool(a.trace))


if __name__ == "__main__":
    sys.exit(main())
