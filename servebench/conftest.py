"""Fixtures of the benchmark's own CPU tests: a temporary checkout that
holds a copy of the harness, a tiny configuration of each model family the
harness serves, a tiny mix, and a BENCHMARK.json whose only cell runs them."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
REPO = HERE.parent

TINY = {
    "dense": {"name": "tiny-dense", "family": "dense", "n_layers": 3,
              "d_model": 128, "n_heads": 4, "n_kv_heads": 2, "head_dim": 32,
              "d_ff": 256, "vocab": 256, "norm": "layernorm",
              "act": "sqrelu", "gated_mlp": False, "rope_theta": 10000.0,
              "rope_fraction": 0.5, "tie_embeddings": False,
              "dtype": "bfloat16"},
    "mla": {"name": "tiny-mla", "family": "moe", "n_layers": 3,
            "d_model": 128, "n_heads": 4, "n_kv_heads": 4, "d_ff": 256,
            "vocab": 256, "norm": "rmsnorm", "act": "silu",
            "gated_mlp": True, "rope_theta": 10000.0, "rope_fraction": 1.0,
            "tie_embeddings": False, "dtype": "bfloat16",
            "mla": {"q_lora_rank": 128, "kv_lora_rank": 128,
                    "qk_nope_head_dim": 32, "qk_rope_head_dim": 16,
                    "v_head_dim": 32},
            "moe": {"n_routed_experts": 8, "top_k": 2, "n_shared_experts": 1,
                    "d_ff_expert": 128, "first_k_dense": 2,
                    "moe_layer_step": 1, "router_aux_free_bias": True,
                    "routed_scaling_factor": 2.5}},
}
# budgets that put each tiny pool under pressure at the tiny mix's load,
# so the controller swaps layers to int4 inside the window
BUDGET = {"dense": 1_200_000, "mla": 2_300_000}


def make_repo(root: Path, family: str = "dense", limit: float = 0.15,
              knee: float = 4.0) -> Path:
    """A checkout at ``root``: the harness copied, one tiny configuration,
    its knee, the tiny mix ``tiny-burst`` and the cell ``tiny.burst``."""
    shutil.copytree(HERE, root / "servebench",
                    ignore=shutil.ignore_patterns("__pycache__", "knees",
                                                  "test_*.py"))
    (root / "servebench" / "knees").mkdir()
    model = TINY[family]
    name = model["name"]
    conf = {"name": name, "source": "test", "reduced": [], "model": model,
            "serving": {"hbm_budget_bytes": BUDGET[family],
                        "kv_block_size": 16, "max_batch_slots": 8,
                        "max_seq_len": 512, "swap_levels": [0, 1, 2],
                        "swap_bits": 4, "use_quant_kernel": True,
                        "mode": "performance", "ttft_slo_s": 2.0},
            "engine": {"policy": "morph", "compute": "real",
                       "dtype": "bfloat16", "hw": "NVIDIA_H100_SXM",
                       "use_quant_kernel": True, "max_tokens_per_step": 128,
                       "prefix_caching": False},
            "swap_order": [2, 0, 1],
            "check": {"sample_min_tokens": 60, "sample_max_requests": 4,
                      "max_gap_limit": limit, "route_alt_margin": 0.01}}
    sb = root / "servebench"
    (sb / "configs" / f"{name}.json").write_text(json.dumps(conf))
    (sb / "knees" / f"{name}.json").write_text(json.dumps(
        {"knee_rps": knee, "highest_rps_no_swap": knee}))
    mix = json.loads((HERE / "mixes" / "chat-burst.json").read_text())
    mix.update(name="tiny-burst", lead_in_s=1,
               prompt={"median": 48, "sigma": 0.6, "min": 8, "max": 128},
               output={"median": 16, "sigma": 0.5, "min": 4, "max": 32},
               profile={"spikes": [{"after_close_s": 1.5, "height_base": 4.0,
                                    "sigma_s": 1.0}],
                        "start_after_close_s": 1.0, "min_s": 1.0,
                        "max_s": 4.0, "until": ["k1", "chunk"]})
    (sb / "mixes" / "tiny-burst.json").write_text(json.dumps(mix))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["configs"] = [{"name": name, "source": "test",
                         "file": f"servebench/configs/{name}.json",
                         "reduced": [], "why": "test"}]
    bench["workloads"] = [{"name": "tiny.burst", "config": name,
                           "traffic": "tiny-burst", "chips": 1,
                           "why": "test"}]
    for m in bench["per_layer"] + bench["end_to_end"]:
        if "workloads" in m:
            m["workloads"] = ["tiny.burst"]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def run_cpu(root: Path, workload: str = "tiny.burst", seed: int = 2 ** 31 + 7,
            seconds: float = 4.0, fault: str = None, trace: bool = False,
            timeout: int = 240):
    """One run past the look for a card, on the CPU, in a fresh process
    started in ``root``: (exit code, stdout lines, stderr)."""
    code = ("import sys; from pathlib import Path; "
            "from servebench import run, faults; "
            "run.prepare(Path.cwd()); "
            f"f = faults.BY_NAME.get({fault!r}); "
            f"sys.exit(run.run_cell(Path.cwd(), {workload!r}, {seed}, "
            f"{seconds}, {trace}, device='cpu', fault=f))")
    env = dict(os.environ, OMP_NUM_THREADS="2",
               PYTHONPATH=os.pathsep.join([str(root), str(REPO / "src")]))
    p = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                       capture_output=True, text=True, timeout=timeout)
    return p.returncode, p.stdout.strip().splitlines(), p.stderr


@pytest.fixture
def tiny_repo(tmp_path):
    return lambda family="dense", **kw: make_repo(tmp_path / family, family,
                                                 **kw)
