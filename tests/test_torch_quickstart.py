"""The quickstart in both packages: ``examples/quickstart.py`` (JAX) and
its torch twin ``examples/quickstart_torch.py``, on the example's own
``PRNGKey(0)`` weights and ``PRNGKey(1)`` calibration batch (carried to
the port through numpy), its ``ServingConfig`` and its trace.

The LIS profile (order exactly, scores to 1e-5 relative), the swap and
resize logs, the report and every greedy stream are held equal. Streams
are compared exactly only where every argmax the port takes wins by more
than ``MIN_GAP`` would a near-tie be expected to part them
(cross-framework float32 logits differ by ~1e-5): on a parting the test
reports the request and the step, and the smallest gap.
"""
import dataclasses
import importlib.util
from pathlib import Path

import jax
import numpy as np
import torch
from torch_parity import MIN_GAP, record_gaps

from repro.configs import MORPH_LLAMA2_7B, ServingConfig, reduced
from repro.core import profile_swap_sequence, tree_bytes
from repro.engine import EngineConfig, MorphServeEngine, azure_like
from repro.engine.kv_cache import kv_block_bytes
from repro.models import lm
from repro_torch import bridge
from repro_torch.configs import reduced as t_reduced
from repro_torch.configs.archs import MORPH_LLAMA2_7B as T_LLAMA
from repro_torch.engine import azure_like as t_azure

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"


def _twin():
    spec = importlib.util.spec_from_file_location(
        "quickstart_torch", EXAMPLES / "quickstart_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_quickstart():
    """``examples/quickstart.py``'s steps 1-4, its engine kept."""
    cfg = reduced(MORPH_LLAMA2_7B)
    params = lm.init_params(cfg, jax.random.PRNGKey(0))
    calib = jax.random.randint(jax.random.PRNGKey(1), (2, 32), 0, cfg.vocab)
    prof = profile_swap_sequence(cfg, params, calib, bits=4)
    wb = tree_bytes(params)
    bb = kv_block_bytes(cfg, 16, 4)
    sc = ServingConfig(hbm_budget_bytes=int((wb + 8 * bb) / 0.95) + 2 * bb,
                       kv_block_size=16, max_batch_slots=4, max_seq_len=256,
                       swap_levels=(0, 1, 2, 4), mode="performance",
                       kv_resize_step_frac=0.25)
    eng = MorphServeEngine(cfg, params, sc,
                           EngineConfig(policy="morph", compute="real"),
                           swap_order=prof.order)
    trace = azure_like(duration_s=6.0, base_rps=3.0, seed=3, prompt_mean=40,
                       gen_mean=16, prompt_max=96, gen_max=32)
    return params, calib, prof, eng, eng.run_trace(trace), sc


def _first_parting(jreqs, treqs):
    """(request id, step) of the first token where the streams part, or
    None."""
    for a, b in zip(jreqs, treqs):
        for i, (x, y) in enumerate(zip(a.generated, b.generated)):
            if x != y:
                return a.rid, i
        if len(a.generated) != len(b.generated):
            return a.rid, min(len(a.generated), len(b.generated))
    return None


def test_quickstart_matches_jax():
    twin = _twin()
    params, calib, jprof, je, rj, jsc = _jax_quickstart()
    tparams = bridge.to_torch(jax.tree.map(np.asarray, params), "cpu")
    tcfg = t_reduced(T_LLAMA)
    tprof, te = twin.build(tcfg, tparams,
                           torch.from_numpy(np.array(calib)).long(), "cpu")
    assert dataclasses.asdict(twin.serving_config(tcfg, tparams)) == \
        dataclasses.asdict(jsc)
    assert twin.TRACE == dict(duration_s=6.0, base_rps=3.0, seed=3,
                              prompt_mean=40, gen_mean=16, prompt_max=96,
                              gen_max=32)
    assert tprof.order == jprof.order
    np.testing.assert_allclose(tprof.lis, jprof.lis, rtol=1e-5)
    gaps = record_gaps(te)
    rt = te.run_trace(t_azure(**twin.TRACE))
    parting = _first_parting(je.all_requests, te.all_requests)
    assert parting is None, \
        f"streams part at (request, step) {parting}; smallest top-2 gap " \
        f"{min(gaps)} (near-tie below {MIN_GAP})"
    assert rt.n_finished == rt.n_requests == rj.n_requests
    assert je.actuator.swap_log == te.actuator.swap_log
    assert je.resize_log == te.resize_log
    assert len(te.actuator.swap_log) > 0 and len(te.resize_log) > 0
    assert dataclasses.asdict(rj) == dataclasses.asdict(rt)
