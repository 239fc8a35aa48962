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
from torch_parity import jcfg, llama_params, tcfg

from repro.configs import ServingConfig
from repro.core import profile_swap_sequence as j_profile
from repro.core import tree_bytes as j_tree_bytes
from repro.engine import EngineConfig as JEC
from repro.engine import MorphServeEngine as JEngine
from repro.engine import azure_like as j_azure
from repro.engine.cost_model import HardwareProfile as JHW
from repro.engine.kv_cache import kv_block_bytes
from repro.engine.traces import TraceRequest as JTR
from repro_torch.configs import ServingConfig as TServingConfig
from repro_torch.core import profile_swap_sequence as t_profile
from repro_torch.core import tree_bytes as t_tree_bytes
from repro_torch.engine import EngineConfig as TEC
from repro_torch.engine import KVQuantConfig
from repro_torch.engine import MorphServeEngine as TEngine
from repro_torch.engine import azure_like as t_azure
from repro_torch.engine.cost_model import HardwareProfile as THW
from repro_torch.engine.traces import TraceRequest as TTR

MIN_GAP = 1e-3
ORDER = [2, 0, 3, 1]


def _serving(params, cls):
    """quickstart's deliberately tight budget: weights + 8 fp32 blocks."""
    wb = j_tree_bytes(params)
    bb = kv_block_bytes(jcfg(), 16, 4)
    return cls(hbm_budget_bytes=int((wb + 8 * bb) / 0.95) + 2 * bb,
               kv_block_size=16, max_batch_slots=4, max_seq_len=256,
               swap_levels=(0, 1, 2, 4), mode="performance",
               kv_resize_step_frac=0.25)


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
    je = JEngine(jcfg(), params, _serving(params, ServingConfig),
                 JEC(**ecfg), swap_order=ORDER)
    te = TEngine(tcfg(), tparams, _serving(params, TServingConfig),
                 TEC(**ecfg), swap_order=ORDER, device="cpu")
    rj = je.run_trace(j_azure(**kw))
    rt = te.run_trace(t_azure(**kw))
    assert dataclasses.asdict(rj) == dataclasses.asdict(rt)
    assert [r.generated for r in je.all_requests] == \
        [r.generated for r in te.all_requests]
    assert je.actuator.swap_log == te.actuator.swap_log
    assert je.resize_log == te.resize_log
    assert je.chunk_log == te.chunk_log


def _top2_gap(row):
    top = torch.topk(row.float(), 2).values
    return float(top[0] - top[1])


def _record_gaps(eng):
    """Wrap the engine's real-compute calls to collect the top-2 logit gap
    of every argmax it takes."""
    gaps, last = [], {}
    for name in ("decode", "prefill", "prefill_batch", "prefill_chunk"):
        fn = getattr(eng.exec, name)

        def run(*a, _fn=fn, _name=name, **k):
            last[_name] = _fn(*a, **k)
            return last[_name]
        setattr(eng.exec, name, run)

    dec, many, chunk = (eng._decode_real, eng._prefill_real_many,
                        eng._prefill_chunk_real)

    def decode_real(run):
        dec(run)
        gaps.extend(_top2_gap(last["decode"][r.slot]) for r in run)

    def prefill_many(admitted):
        out = many(admitted)
        if "prefill_batch" in last and len(admitted) > 1:
            gaps.extend(_top2_gap(last["prefill_batch"][i])
                        for i in range(len(admitted)))
        return out

    def prefill_chunk(r, clen):
        first = chunk(r, clen)
        if first is not None:
            gaps.append(_top2_gap(last["prefill_chunk"][clen - 1]))
        return first

    eng._decode_real = decode_real
    eng._prefill_real_many = prefill_many
    eng._prefill_chunk_real = prefill_chunk
    return gaps


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
    je = JEngine(jcfg(), params, _serving(params, ServingConfig),
                 JEC(hw=JHW("slow", 1e9, 1e7, 2**30), **ecfg),
                 swap_order=ORDER)
    te = TEngine(tcfg(), tparams, _serving(params, TServingConfig),
                 TEC(hw=THW("slow", 1e9, 1e7, 2**30), **ecfg),
                 swap_order=ORDER, device="cpu")
    gaps = _record_gaps(te)
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


def test_engine_refuses_what_is_not_ported():
    """The quantized-KV tier raises (its kernel lane is not ported), and
    params on another device than the engine's raise instead of moving."""
    params, _, tparams = llama_params()
    sc = _serving(params, TServingConfig)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TEngine(tcfg(), tparams, sc,
                TEC(kv_quant=KVQuantConfig(enabled=True)), device="cpu")
    with pytest.raises(ValueError, match="params live on"):
        TEngine(tcfg(), tparams, sc, TEC(), device="meta")
