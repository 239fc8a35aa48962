"""The port's two families with an extra input against the JAX package,
reduced (float32, d 128, 4 heads over 2 kv heads of 32, vocab 512):

- Whisper (``models/encdec.py``: 2 encoder and 4 decoder layers, 64
  frames of 32; layernorm, tanh GELU, the three biases, tied head):
  ``encode``, ``decode_forward`` and ``forward``; ``init_cache`` +
  ``start_cache`` + twelve ``decode_step`` calls at the fp decoder and at
  an int4 one (the JAX ``quantize_tree`` of the stacked decoder,
  kernel-flagged: the JAX side runs its xla lane and its Pallas kernel in
  interpret mode, the port K1's plain version through each layer's
  ``QTensor.expert`` view); the steps against the teacher-forced logits;
  and a real-compute engine trace of the decoder-only plan that both
  engines serve for an ENCDEC config (``lm.layer_kinds``: ``dense`` x 4),
  the first engine test of layernorm, the non-gated GELU MLP, the QKV,
  output and MLP biases and the tied head through ``ModelExec``;
- InternVL2 (``lm`` with the ``projector``: 8 image tokens of 32 before
  the text): ``forward`` with the frontend, the LIS order with the
  frontend, and the contiguous-cache decode after an image + text prompt.

Tolerances: logits and caches through the layers and steps, float32
reduced in another order by torch and XLA: 1e-4 relative and absolute
(values are O(1)); LIS scores 1e-5 relative and the order exactly; a
decode step against the teacher-forced logits at the JAX arch test's
2e-3. Greedy streams and the swap and resize logs are compared exactly on
a trace checked free of near-ties (``MIN_GAP``).
"""
import dataclasses
import functools
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import (MIN_GAP, ORDER, close, np_tree, record_gaps, rnd,
                          trees_close)

from repro.configs import ServingConfig as JSC
from repro.configs import reduced as j_reduced
from repro.configs.archs import INTERNVL2_1B as J_VLM
from repro.configs.archs import WHISPER_SMALL as J_WHISPER
from repro.core import profile_swap_sequence as j_profile
from repro.core import tree_bytes as j_tree_bytes
from repro.engine import EngineConfig as JEC
from repro.engine import MorphServeEngine as JEngine
from repro.engine.cost_model import HardwareProfile as JHW
from repro.engine.kv_cache import kv_block_bytes
from repro.engine.traces import TraceRequest as JTR
from repro.kernels import dispatch
from repro.models import encdec as jed
from repro.models import lm as jlm
from repro.quant import awq as j_awq
from repro_torch import bridge
from repro_torch.configs import ServingConfig as TSC
from repro_torch.configs import reduced as t_reduced
from repro_torch.configs.archs import INTERNVL2_1B as T_VLM
from repro_torch.configs.archs import WHISPER_SMALL as T_WHISPER
from repro_torch.core import profile_swap_sequence as t_profile
from repro_torch.engine import EngineConfig as TEC
from repro_torch.engine import MorphServeEngine as TEngine
from repro_torch.engine.cost_model import HardwareProfile as THW
from repro_torch.engine.traces import TraceRequest as TTR
from repro_torch.models import encdec as ted
from repro_torch.models import lm as tlm
from repro_torch.quant import qlinear as tq

TOL = dict(rtol=1e-4, atol=1e-4)
B, S_TEXT, STEPS, MAX_SEQ = 2, 12, 12, 16


@pytest.fixture
def free_compiled():
    """The test's JAX executables go with it, so the file stays within
    one worker's memory."""
    yield
    jax.clear_caches()
    gc.collect()


@functools.lru_cache(maxsize=1)
def whisper():
    """(JAX config, port config, JAX params, port params on the CPU,
    frames, tokens) of the reduced Whisper."""
    jc, tc = j_reduced(J_WHISPER), t_reduced(T_WHISPER)
    params = jed.init_params(jc, jax.random.PRNGKey(0))
    frames = rnd((B, jc.encoder_seq, jc.frontend_dim), 1)
    tokens = np.random.default_rng(2).integers(0, jc.vocab, (B, S_TEXT))
    return jc, tc, params, bridge.to_torch(np_tree(params), "cpu"), \
        frames, tokens


def int4_decoder(params):
    """The JAX ``quantize_tree`` of the stacked decoder, kernel-flagged:
    every (L, K, N) weight becomes one stacked QTensor, each layer
    quantized on its own."""
    return dict(params, dec_blocks=j_awq.quantize_tree(
        params["dec_blocks"], bits=4, use_kernel=True))


# ---------------------------------------------------------------------------
# Whisper
# ---------------------------------------------------------------------------
def test_whisper_tree_and_forward_match_jax():
    """The param tree (stacked blocks) crosses the bridge intact; the
    port's own ``init_params`` draws the same tree; ``encode``,
    ``decode_forward`` and ``forward`` give the JAX values."""
    jc, tc, params, tparams, frames, tokens = whisper()
    shapes = jax.tree.map(lambda a: tuple(a.shape), params)
    for tree in (tparams, ted.init_params(tc, torch.Generator())):
        assert shapes == jax.tree.map(
            lambda a: tuple(a.shape), tree,
            is_leaf=lambda x: isinstance(x, torch.Tensor))
    jenc = jed.encode(jc, params, jnp.asarray(frames))
    tenc = ted.encode(tc, tparams, torch.from_numpy(frames))
    close(tenc, jenc, TOL)
    close(ted.decode_forward(tc, tparams, torch.from_numpy(tokens), tenc),
          jed.decode_forward(jc, params, jnp.asarray(tokens), jenc), TOL)
    close(ted.forward(tc, tparams, torch.from_numpy(tokens),
                      frontend=torch.from_numpy(frames)),
          jed.forward(jc, params, jnp.asarray(tokens),
                      frontend=jnp.asarray(frames)), TOL)
    # full width: torch's and XLA's float32 exp differ by one ulp on 28 of
    # the 384 timescales, which at position 1499 moves an angle by up to
    # one of its own ulps (1.2e-4): the sines agree to that
    close(ted.sinusoids(1500, 768), jed.sinusoids(1500, 768),
          dict(rtol=0, atol=2.5e-4))


@pytest.mark.parametrize("decoder,lane", [("fp", "xla"), ("int4", "xla"),
                                          ("int4", "pallas_interpret")])
def test_whisper_decode_steps_match_jax(decoder, lane, free_compiled):
    """``init_cache`` + ``start_cache`` + twelve ``decode_step`` calls:
    the cache trees (the port's own and the bridged JAX one) and every
    step's logits and the final self-attention cache equal JAX's. An int4
    decoder reaches K1's route through each layer's 2-D view of the
    stacked QTensors."""
    jc, tc, params, _, frames, tokens = whisper()
    if decoder == "int4":
        params = int4_decoder(params)
    tparams = bridge.to_torch(np_tree(params), "cpu")
    if decoder == "int4":
        wq = tparams["dec_blocks"]["self_attn"]["wq"]
        assert tq.is_quantized(wq) and wq.use_kernel and wq.packed.ndim == 3
    prev = dispatch.set_mode(lane)
    try:
        jenc = jed.encode(jc, params, jnp.asarray(frames))
        jcache = jed.start_cache(jc, params, jenc,
                                 jed.init_cache(jc, B, MAX_SEQ))
        step = jax.jit(functools.partial(jed.decode_step, jc))
        jlogits = []
        for t in range(STEPS):
            lg, jcache = step(params, jcache, jnp.asarray(tokens[:, t:t + 1]))
            jlogits.append(lg)
    finally:
        dispatch.set_mode(prev)
    tenc = ted.encode(tc, tparams, torch.from_numpy(frames))
    tcache = ted.init_cache(tc, B, MAX_SEQ, device="cpu")
    assert {k: tuple(v.shape) for k, v in tcache.items()} == \
        {k: v.shape for k, v in jcache.items()}
    tcache = ted.start_cache(tc, tparams, tenc, tcache)
    close(tcache["cross_k"], jcache["cross_k"], TOL)
    close(tcache["cross_v"], jcache["cross_v"], TOL)
    for t in range(STEPS):
        lg, tcache = ted.decode_step(tc, tparams, tcache,
                                     torch.from_numpy(tokens[:, t:t + 1]))
        close(lg, jlogits[t], TOL)
    trees_close(tcache, jcache, TOL)
    # a bridged JAX cache continues the same way
    bcache = bridge.to_torch(np_tree(jcache), "cpu")
    assert sorted(bcache) == sorted(tcache)
    assert bcache["pos"].dtype == torch.int32
    trees_close(bcache, jcache, TOL)


def test_whisper_decode_matches_teacher_forced_forward():
    """The port's decode steps give its teacher-forced logits, at the
    JAX arch test's 2e-3."""
    _, tc, _, tparams, frames, tokens = whisper()
    tenc = ted.encode(tc, tparams, torch.from_numpy(frames))
    full = ted.decode_forward(tc, tparams, torch.from_numpy(tokens), tenc)
    cache = ted.start_cache(tc, tparams, tenc,
                            ted.init_cache(tc, B, 32, device="cpu"))
    errs = []
    for t in range(S_TEXT):
        lg, cache = ted.decode_step(tc, tparams, cache,
                                    torch.from_numpy(tokens[:, t:t + 1]))
        errs.append(float((lg[:, 0] - full[:, t]).abs().max()))
    assert max(errs) < 2e-3, errs


WHISPER_TRACE = [(0.0, 36, 8), (0.01, 40, 8), (0.02, 28, 6), (0.03, 40, 8),
                 (0.3, 33, 8), (0.35, 24, 7)]


def _whisper_serving(jc, params, cls):
    """The quickstart's tight budget: the weights + 8 float32 blocks."""
    wb = j_tree_bytes(params)
    bb = kv_block_bytes(jc, 16, 4)
    return cls(hbm_budget_bytes=int((wb + 8 * bb) / 0.95) + 2 * bb,
               kv_block_size=16, max_batch_slots=4, max_seq_len=256,
               swap_levels=(0, 1, 2, 4), mode="performance",
               kv_resize_step_frac=0.25)


def test_whisper_real_engine_matches_jax(free_compiled):
    """Real compute on the plan both engines serve for an ENCDEC config
    (``dense`` x 4 from ``lm.init_params``: layernorm, GELU, biases, tied
    head), int4 layers through the wNa16 route, a 32-token budget that
    chunks every prompt, and a slow virtual hardware profile that swaps
    and resizes: streams, morph logs and report equal the JAX engine's."""
    jc, tc = j_reduced(J_WHISPER), t_reduced(T_WHISPER)
    params = jlm.init_params(jc, jax.random.PRNGKey(0))
    tparams = bridge.to_torch(np_tree(params), "cpu")
    assert tlm.layer_kinds(tc) == jlm.layer_kinds(jc) == ["dense"] * 4
    ecfg = dict(policy="morph", compute="real", use_quant_kernel=True,
                max_tokens_per_step=32, seed=10)
    je = JEngine(jc, params, _whisper_serving(jc, params, JSC),
                 JEC(hw=JHW("slow", 1e9, 1e7, 2**30), **ecfg),
                 swap_order=ORDER)
    te = TEngine(tc, tparams, _whisper_serving(jc, params, TSC),
                 TEC(hw=THW("slow", 1e9, 1e7, 2**30), **ecfg),
                 swap_order=ORDER, device="cpu")
    gaps = record_gaps(te)
    rj = je.run_trace([JTR(*s) for s in WHISPER_TRACE])
    rt = te.run_trace([TTR(*s) for s in WHISPER_TRACE])
    assert min(gaps) > MIN_GAP, f"near-tie in the trace: {min(gaps)}"
    assert rt.n_finished == rt.n_requests == len(WHISPER_TRACE)
    assert [r.generated for r in je.all_requests] == \
        [r.generated for r in te.all_requests]
    assert je.actuator.swap_log == te.actuator.swap_log
    assert je.resize_log == te.resize_log
    assert len(te.actuator.swap_log) > 0 and len(te.resize_log) > 0
    assert sum(r.prefill_chunks for r in te.all_requests) > 0
    assert dataclasses.asdict(rj) == dataclasses.asdict(rt)


# ---------------------------------------------------------------------------
# InternVL2
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=1)
def vlm():
    """(JAX config, port config, JAX params, port params, frontend,
    tokens) of the reduced InternVL2."""
    jc, tc = j_reduced(J_VLM), t_reduced(T_VLM)
    params = jlm.init_params(jc, jax.random.PRNGKey(0))
    frontend = rnd((B, jc.n_image_tokens, jc.frontend_dim), 3)
    tokens = np.random.default_rng(4).integers(0, jc.vocab, (B, S_TEXT))
    return jc, tc, params, bridge.to_torch(np_tree(params), "cpu"), \
        frontend, tokens


def test_vlm_forward_matches_jax():
    """The projector's image tokens go first; forward logits (image +
    text positions) equal JAX's; without a frontend both refuse."""
    jc, tc, params, tparams, fe, tokens = vlm()
    assert set(tparams["projector"]) == {"w", "b"}
    tp = tlm.init_params(tc, torch.Generator())
    assert tuple(tp["projector"]["w"].shape) == (jc.frontend_dim, jc.d_model)
    got = tlm.forward(tc, tparams, torch.from_numpy(tokens),
                      frontend=torch.from_numpy(fe))
    want = jlm.forward(jc, params, jnp.asarray(tokens),
                       frontend=jnp.asarray(fe))
    assert tuple(got.shape) == (B, jc.n_image_tokens + S_TEXT, jc.vocab)
    close(got, want, TOL)
    with pytest.raises(AssertionError, match="patch embeddings"):
        jlm.forward(jc, params, jnp.asarray(tokens))
    with pytest.raises(ValueError, match="patch embeddings"):
        tlm.forward(tc, tparams, torch.from_numpy(tokens))


def test_vlm_lis_order_matches_jax():
    """The LIS profile with the frontend on the calibration batch."""
    jc, tc, params, tparams, fe, tokens = vlm()
    pj = j_profile(jc, params, jnp.asarray(tokens), bits=4,
                   frontend=jnp.asarray(fe))
    pt = t_profile(tc, tparams, torch.from_numpy(tokens), bits=4,
                   frontend=torch.from_numpy(fe))
    assert pj.order == pt.order
    np.testing.assert_allclose(pj.lis, pt.lis, rtol=1e-5)
    np.testing.assert_allclose(pj.lts, pt.lts, rtol=1e-5)
    np.testing.assert_allclose(pj.lrs, pt.lrs, rtol=1e-5)


def test_vlm_decode_after_an_image_prompt_matches_jax():
    """The image + text prompt's k/v (``prefill_collect`` with the
    frontend) written into each package's ``init_cache``, then eight
    text-token ``decode_step`` calls: the logits equal JAX's, and the
    port's equal its own forward over the longer prompt at 2e-3."""
    jc, tc, params, tparams, fe, tokens = vlm()
    P = jc.n_image_tokens + S_TEXT
    _, jpay = jlm.prefill_collect(
        jc, params, jlm.params_to_layer_list(jc, params),
        jnp.asarray(tokens), frontend=jnp.asarray(fe))
    _, tpay = tlm.prefill_collect(
        tc, tparams, tlm.params_to_layer_list(tc, tparams),
        torch.from_numpy(tokens), frontend=torch.from_numpy(fe))
    for a, b in zip(tpay, jpay):
        close(a["k"], b["k"], TOL)
        close(a["v"], b["v"], TOL)
    jcache = jlm.init_cache(jc, B, 32)
    (seg,) = jcache["segments"]                 # one run of 4 dense layers
    k = jnp.stack([p["k"] for p in jpay])
    v = jnp.stack([p["v"] for p in jpay])
    jcache = {"segments": [({"k": seg[0]["k"].at[:, :, :P].set(k),
                             "v": seg[0]["v"].at[:, :, :P].set(v)},)],
              "pos": jnp.full((B,), P, jnp.int32)}
    tcache = tlm.init_cache(tc, B, 32, device="cpu")
    tseg = tcache["segments"][0][0]
    tseg["k"][:, :, :P] = torch.stack([p["k"] for p in tpay])
    tseg["v"][:, :, :P] = torch.stack([p["v"] for p in tpay])
    tcache["pos"][:] = P
    more = np.random.default_rng(5).integers(0, jc.vocab, (B, 8))
    step = jax.jit(functools.partial(jlm.decode_step, jc))
    for t in range(8):
        jl, jcache = step(params, jcache, jnp.asarray(more[:, t:t + 1]))
        tl, tcache = tlm.decode_step(tc, tparams, tcache,
                                     torch.from_numpy(more[:, t:t + 1]))
        close(tl, jl, TOL)
    full = tlm.forward(tc, tparams, torch.from_numpy(
        np.concatenate([tokens, more], axis=1)),
        frontend=torch.from_numpy(fe))
    assert float((tl[:, 0] - full[:, -1]).abs().max()) < 2e-3
