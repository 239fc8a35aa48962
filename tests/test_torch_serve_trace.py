"""``examples/serve_trace_torch.py``, the torch twin of
``examples/serve_trace.py``, against the JAX package:

(a) at full scale, the twin's printed lines for both traces equal, letter
    for letter, the JAX script's own output, recorded below. The twin runs
    on ``device="meta"``: its sim engines allocate no pool there (the sim
    engine never reads it), where each engine of either package would
    otherwise hold 17.2-34.4 GB of bf16 pool;
(b) at a reduced scale, the twin's ``run_policies`` against the JAX engine
    live, every report field, the KV block trajectory and the swap and
    resize logs exactly equal, for all four policies and both traces;
(c) a real-compute engine on a bf16 KV pool (the pool dtype of the
    example's engines) on the reduced Llama-2 in both packages: the
    report, the swap and resize logs and every greedy stream equal, on a
    trace seed whose every argmax wins by more than ``MIN_GAP``.
"""
import dataclasses

import pytest
import torch
from torch_parity import (MIN_GAP, ORDER, ROOT, jcfg, llama_params,
                          load_module, record_gaps, serving, tcfg)

from repro.configs import MORPH_LLAMA2_7B as J_LLAMA
from repro.configs import ServingConfig as JServingConfig
from repro.core.swap_plan import build_sim_swap_plan as j_sim_plan
from repro.engine import EngineConfig as JEC
from repro.engine import MorphServeEngine as JEngine
from repro.engine import NVIDIA_L4 as J_L4
from repro.engine import azure_like as j_azure
from repro.engine import burstgpt_like as j_burstgpt
from repro.engine.cost_model import HardwareProfile as JHW
from repro.engine.kv_cache import kv_block_bytes as j_block_bytes
from repro.engine.traces import TraceRequest as JTR
from repro_torch.configs import MORPH_LLAMA2_7B as T_LLAMA
from repro_torch.configs import ServingConfig as TServingConfig
from repro_torch.engine import EngineConfig as TEC
from repro_torch.engine import MorphServeEngine as TEngine
from repro_torch.engine import NVIDIA_L4 as T_L4
from repro_torch.engine import azure_like as t_azure
from repro_torch.engine import burstgpt_like as t_burstgpt
from repro_torch.engine.cost_model import HardwareProfile as THW
from repro_torch.engine.traces import TraceRequest as TTR



def _twin():
    return load_module("serve_trace_torch", "examples/serve_trace_torch.py")


# ---------------------------------------------------------------------------
# (a) full scale: the JAX script's own output
# ---------------------------------------------------------------------------
# ``<trace>.txt``: what ``JAX_PLATFORMS=cpu PYTHONPATH=src python
# examples/serve_trace.py [--trace burstgpt]`` printed at commit 3ec7065
# (its engines need 17-34 GB of host memory each, too much for the suite);
# chip_smoke.py holds the twin on the card to the azure file
JAX_LINES = ROOT / "tests" / "data" / "serve_trace_jax"


@pytest.mark.parametrize("trace", ["azure", "burstgpt"])
def test_full_scale_lines_match_jax_script(trace, capsys):
    _twin().main(["--device", "meta", "--trace", trace])
    want = (JAX_LINES / f"{trace}.txt").read_text()
    assert capsys.readouterr().out == want


# ---------------------------------------------------------------------------
# (b) reduced scale, live against the JAX engine
# ---------------------------------------------------------------------------
# Llama-2-7B cut to 4 layers and a quarter of its width (d 1024, 8 heads of
# 128, d_ff 2752); the trace's token lengths, max_seq_len and the budget's
# KV tokens cut to a quarter (327 blocks, as 1311 at full scale; the int4
# level then holds 1.9x the blocks, as at full scale); the L4's rates cut
# to 1/512: a step moves 1/128 of the full model's bytes and a request
# lasts 1/4 as many steps. Each pool stays within 0.27 GB, and every
# policy differs: the fp policy preempts, morph swaps and resizes.
CUT = dict(n_layers=4, d_model=1024, n_heads=8, n_kv_heads=8, d_ff=2752)
SLOW = 512
FP_BLOCKS = 327
TRACE = dict(duration_s=72.0, base_rps=0.45, seed=5, prompt_mean=128,
             gen_mean=64, prompt_max=256, gen_max=112)


def _cut_serving(cfg):
    """The example's ServingConfig fields at the cut: a budget of the sim
    plan's weights, the sim engine's embedding reserve and ``FP_BLOCKS``
    bf16 blocks; a quarter of max_seq_len; the ladder within 4 layers."""
    sc = dict(kv_block_size=16, max_batch_slots=48, max_seq_len=512,
              swap_levels=(0, 1, 2, 4))
    plan = j_sim_plan(cfg, list(range(cfg.n_layers)),
                      serving=JServingConfig(**sc), bits=4)
    blk = j_block_bytes(cfg, 16, dtype_bytes=2)
    embed = 2 * cfg.vocab * cfg.d_model * 2
    budget = int((embed + plan.weight_bytes(0) + FP_BLOCKS * blk) / 0.95) + blk
    return dict(sc, hbm_budget_bytes=budget)


def _slow(cls, l4):
    return cls(f"l4/{SLOW}", l4.flops / SLOW, l4.hbm_bw / SLOW, l4.hbm_bytes,
               l4.host_link_bps / SLOW)


def _jax_policies(cfg, trace, sc, hw):
    """``examples/serve_trace.py``'s loop, each engine's run kept."""
    out = []
    for policy, mode in _twin().POLICIES:
        eng = JEngine(cfg, None, dataclasses.replace(sc, mode=mode),
                      JEC(policy=policy, compute="sim", hw=hw,
                          dtype="bfloat16", seed=1))
        rep = eng.run_trace(trace, max_steps=60000)
        out.append((rep, [t.kv_total_blocks for t in eng.monitor.history],
                    list(eng.actuator.swap_log), list(eng.resize_log)))
    return out


@pytest.mark.parametrize("trace", ["azure", "burstgpt"])
def test_reduced_scale_matches_jax_engine(trace):
    twin = _twin()
    jc, tc = J_LLAMA.replace(**CUT), T_LLAMA.replace(**CUT)
    sc = _cut_serving(jc)
    gen_j, gen_t = ((j_azure, t_azure) if trace == "azure"
                    else (j_burstgpt, t_burstgpt))
    want = _jax_policies(jc, gen_j(**TRACE), JServingConfig(**sc),
                         _slow(JHW, J_L4))
    got = list(twin.run_policies(tc, None, gen_t(**TRACE),
                                 TServingConfig(**sc), compute="sim",
                                 hw=_slow(THW, T_L4), device="cpu"))
    assert [g[0] for g in got] == [twin.policy_name(*p)
                                   for p in twin.POLICIES]
    for (name, rep, blocks, swaps, resizes), (jrep, jb, js, jr) in zip(
            got, want):
        assert dataclasses.asdict(rep) == dataclasses.asdict(jrep), name
        assert blocks == jb, name
        assert swaps == js, name
        assert resizes == jr, name
    reports = {g[0]: g[1] for g in got}
    assert reports["static_fp16"].preemptions > 0
    for name in ("morph-accuracy", "morph-performance"):
        swaps, resizes = next((g[3], g[4]) for g in got if g[0] == name)
        assert swaps and resizes, name
    assert len({g[1].row() for g in got}) == 4


# ---------------------------------------------------------------------------
# (c) a real-compute engine over a bf16 KV pool
# ---------------------------------------------------------------------------
def test_real_engine_on_bf16_pool_matches_jax():
    """``test_torch_engine.test_real_engine_matches_jax``'s six requests,
    swap order and slow profile on a bf16 pool (float32 weights and
    activations; K and V round to bf16 as they enter the pool, the same
    rounding in both packages). Seed 20 draws prompts whose every argmax
    wins by > 0.035; the near-tie check holds the setup to ``MIN_GAP``."""
    params, _, tparams = llama_params()
    spec = [(0.0, 36, 8), (0.01, 40, 8), (0.02, 28, 6), (0.03, 40, 8),
            (0.3, 33, 8), (0.35, 24, 7)]
    ecfg = dict(policy="morph", compute="real", use_quant_kernel=True,
                max_tokens_per_step=32, seed=20, dtype="bfloat16")
    je = JEngine(jcfg(), params, serving(params, JServingConfig),
                 JEC(hw=JHW("slow", 1e9, 1e7, 2**30), **ecfg),
                 swap_order=ORDER)
    te = TEngine(tcfg(), tparams, serving(params, TServingConfig),
                 TEC(hw=THW("slow", 1e9, 1e7, 2**30), **ecfg),
                 swap_order=ORDER, device="cpu")
    assert te.pool.k.dtype == torch.bfloat16
    assert str(je.pool.k.dtype) == "bfloat16"
    gaps = record_gaps(te)
    rj = je.run_trace([JTR(*s) for s in spec])
    rt = te.run_trace([TTR(*s) for s in spec])
    assert min(gaps) > MIN_GAP, f"near-tie in the trace: {min(gaps)}"
    assert rt.n_finished == rt.n_requests == 6
    assert [r.generated for r in je.all_requests] == \
        [r.generated for r in te.all_requests]
    assert je.actuator.swap_log == te.actuator.swap_log
    assert je.resize_log == te.resize_log
    assert len(te.actuator.swap_log) > 0 and len(te.resize_log) > 0
    assert sum(r.prefill_chunks for r in te.all_requests) > 6
    assert dataclasses.asdict(rj) == dataclasses.asdict(rt)


@pytest.mark.parametrize("name", ["serve_trace_torch", "morph_profile_torch"])
def test_twin_imports_neither_jax_nor_repro(name):
    """The twins import the port alone (``benchmarks`` neither)."""
    import ast
    tree = ast.parse((ROOT / "examples" / f"{name}.py").read_text())
    mods = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
            for a in n.names]
    mods += [n.module for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom) and n.module]
    assert "repro_torch" in {m.split(".")[0] for m in mods}
    for m in mods:
        assert m.split(".")[0] not in ("jax", "jaxlib", "repro",
                                       "benchmarks"), m
