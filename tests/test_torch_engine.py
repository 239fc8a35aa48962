"""The port's morphing substrate and serving engine against the JAX
package on the reduced Llama-2: the LIS swap order, the ServingReport in
sim compute, and in real compute the token streams and the swap / resize
logs of a short bursty trace that morphs and chunks.

Tolerance: greedy token streams are compared exactly. The model math
agrees only to ~1e-5 across frameworks (float32 reductions in another
order), so the real-compute trace is checked free of near-ties first:
every argmax the engine takes must win by more than ``MIN_GAP``.
"""
import dataclasses

import numpy as np
import pytest
import torch
from torch_parity import (MIN_GAP, ORDER, jcfg, llama_params, record_gaps,
                          serving, tcfg)

from repro.configs import ServingConfig
from repro.core import profile_swap_sequence as j_profile
from repro.core import tree_bytes as j_tree_bytes
from repro.engine import EngineConfig as JEC
from repro.engine import MorphServeEngine as JEngine
from repro.engine import azure_like as j_azure
from repro.engine.cost_model import HardwareProfile as JHW
from repro.engine.traces import TraceRequest as JTR
from repro_torch.configs import ServingConfig as TServingConfig
from repro_torch.configs import reduced as t_reduced
from repro_torch.configs.archs import DEEPSEEK_V3_671B
from repro_torch.core import profile_swap_sequence as t_profile
from repro_torch.core import tree_bytes as t_tree_bytes
from repro_torch.engine import EngineConfig as TEC
from repro_torch.engine import MorphServeEngine as TEngine
from repro_torch.engine import PagedKVPool
from repro_torch.engine import azure_like as t_azure
from repro_torch.engine.cost_model import HardwareProfile as THW
from repro_torch.engine.traces import TraceRequest as TTR


def test_lis_order_matches_jax():
    params, _, tparams = llama_params()
    calib = np.random.default_rng(1).integers(0, 512, (2, 32)).astype(
        np.int32)
    pj = j_profile(jcfg(), params, calib, bits=4)
    pt = t_profile(tcfg(), tparams, torch.from_numpy(calib).long(), bits=4)
    assert pj.order == pt.order
    np.testing.assert_allclose(pj.lis, pt.lis, rtol=1e-5)
    np.testing.assert_allclose(pj.lts, pt.lts, rtol=1e-5)
    np.testing.assert_allclose(pj.lrs, pt.lrs, rtol=1e-5)
    assert j_tree_bytes(params) == t_tree_bytes(tparams)


def test_sim_report_matches_jax():
    """Sim compute: the same host logic on the same trace gives the same
    ServingReport, streams and morph logs, exactly."""
    params, _, tparams = llama_params()
    kw = dict(duration_s=6.0, base_rps=3.0, seed=3, prompt_mean=60,
              gen_mean=16, prompt_max=200, gen_max=32)
    ecfg = dict(policy="morph", compute="sim", max_tokens_per_step=64,
                prefix_caching=True)
    je = JEngine(jcfg(), params, serving(params, ServingConfig),
                 JEC(**ecfg), swap_order=ORDER)
    te = TEngine(tcfg(), tparams, serving(params, TServingConfig),
                 TEC(**ecfg), swap_order=ORDER, device="cpu")
    rj = je.run_trace(j_azure(**kw))
    rt = te.run_trace(t_azure(**kw))
    assert dataclasses.asdict(rj) == dataclasses.asdict(rt)
    assert [r.generated for r in je.all_requests] == \
        [r.generated for r in te.all_requests]
    assert je.actuator.swap_log == te.actuator.swap_log
    assert je.resize_log == te.resize_log
    assert je.chunk_log == te.chunk_log


def test_real_engine_matches_jax():
    """Real compute, int4 layers through the wNa16 route: six requests in
    two bursts. A slow virtual hardware profile stretches the steps so the
    controller swaps layers and resizes the pool within the trace; a 32-token
    budget chunks every prompt. Streams and morph logs equal the JAX
    engine's."""
    params, _, tparams = llama_params()
    spec = [(0.0, 36, 8), (0.01, 40, 8), (0.02, 28, 6), (0.03, 40, 8),
            (0.3, 33, 8), (0.35, 24, 7)]
    # seed 10 draws prompts whose every argmax wins by > 0.02 (the
    # near-tie check below holds the setup to that)
    ecfg = dict(policy="morph", compute="real", use_quant_kernel=True,
                max_tokens_per_step=32, seed=10)
    je = JEngine(jcfg(), params, serving(params, ServingConfig),
                 JEC(hw=JHW("slow", 1e9, 1e7, 2**30), **ecfg),
                 swap_order=ORDER)
    te = TEngine(tcfg(), tparams, serving(params, TServingConfig),
                 TEC(hw=THW("slow", 1e9, 1e7, 2**30), **ecfg),
                 swap_order=ORDER, device="cpu")
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


def test_sim_engine_books_a_prebuilt_plan():
    """A sim engine handed a prebuilt swap plan books that plan's bytes
    (``swap_rate.py`` hands it the real plan's per-layer bytes): its ledger
    starts at the real-compute engine's weight bytes, and a swap frees what
    the real engine's would."""
    from repro_torch.core import build_swap_plan
    params, _, tparams = llama_params()
    sc = serving(params, TServingConfig)
    plan = build_swap_plan(tcfg(), tparams, ORDER, serving=sc)
    sim = TEngine(tcfg(), None, sc, TEC(compute="sim"), swap_order=ORDER,
                  device="cpu", plan=plan)
    real = TEngine(tcfg(), tparams, sc, TEC(compute="real"),
                   swap_order=ORDER, device="cpu")
    assert sim.plan is plan
    assert sim.ledger.weight_bytes == real.ledger.weight_bytes
    assert [sim.plan.freed_bytes(lv) for lv in plan.levels] == \
        [real.plan.freed_bytes(lv) for lv in real.plan.levels]


def test_engine_admits_every_family_and_refuses_vlm_real_compute():
    """Every config, reduced and at full width, builds an engine with the
    JAX package's layer kinds: DeepSeek-V3 past its dense MLA layers and
    Llama-4 Maverick (MoE), Mamba-2 and Hymba (SSM and hybrid), and
    Whisper and InternVL2 (ENCDEC and VLM: ``dense`` x ``n_layers``, the
    decoder-only plan that both engines serve). A VLM engine in sim
    compute serves the JAX engine's report; with real compute it raises
    at construction, since the engine takes no image input, where the JAX
    engine asserts at its first whole-prompt prefill. Params on another
    device than the engine's raise instead of moving."""
    import jax
    from repro.configs import get_config, reduced
    from repro.models import lm as jlm
    from repro_torch import bridge
    from repro_torch.configs.archs import (HYMBA_1P5B, INTERNVL2_1B,
                                           LLAMA4_MAVERICK_400B,
                                           MAMBA2_780M, WHISPER_SMALL)
    params, _, tparams = llama_params()
    sc = serving(params, TServingConfig)
    mla_moe = t_reduced(DEEPSEEK_V3_671B)         # mla_dense, mla_moe x 3
    for cfg in (DEEPSEEK_V3_671B, LLAMA4_MAVERICK_400B):
        jcfg_ = get_config(cfg.name)
        for t, j in ((cfg, jcfg_), (t_reduced(cfg), reduced(jcfg_))):
            eng = TEngine(t, None, sc, TEC(compute="sim"), device="cpu")
            assert list(eng.kinds) == jlm.layer_kinds(j)
            assert any(k.endswith("moe") for k in eng.kinds)
    for cfg, kind in ((MAMBA2_780M, "mamba"), (HYMBA_1P5B, "hybrid"),
                      (WHISPER_SMALL, "dense"), (INTERNVL2_1B, "dense")):
        jcfg_ = get_config(cfg.name)
        for t, j in ((cfg, jcfg_), (t_reduced(cfg), reduced(jcfg_))):
            eng = TEngine(t, None, sc, TEC(compute="sim"), device="cpu")
            assert list(eng.kinds) == jlm.layer_kinds(j) == \
                [kind] * t.n_layers
    jvlm, tvlm = reduced(get_config(INTERNVL2_1B.name)), \
        t_reduced(INTERNVL2_1B)
    kw = dict(duration_s=3.0, base_rps=3.0, seed=3, prompt_mean=40,
              gen_mean=12, prompt_max=96, gen_max=24)
    je = JEngine(jvlm, None, serving(params, ServingConfig),
                 JEC(compute="sim"))
    te = TEngine(tvlm, None, sc, TEC(compute="sim"), device="cpu")
    rj, rt = je.run_trace(j_azure(**kw)), te.run_trace(t_azure(**kw))
    assert rt.n_finished == rt.n_requests > 0
    assert dataclasses.asdict(rj) == dataclasses.asdict(rt)
    vparams = jlm.init_params(jvlm, jax.random.PRNGKey(0))
    je = JEngine(jvlm, vparams, serving(params, ServingConfig),
                 JEC(compute="real"))
    with pytest.raises(AssertionError, match="vlm needs patch embeddings"):
        je.run_trace([JTR(0.0, 20, 4)])
    tv = bridge.to_torch(jax.tree.map(np.asarray, vparams), "cpu")
    with pytest.raises(ValueError, match="takes no image input"):
        TEngine(tvlm, tv, sc, TEC(compute="real"), device="cpu")
    pool = PagedKVPool(mla_moe, 8, 16, device="cpu")
    assert tuple(pool.k.shape) == (4, 8, 16, 1, 48)
    with pytest.raises(ValueError, match="params live on"):
        TEngine(tcfg(), tparams, sc, TEC(), device="meta")
