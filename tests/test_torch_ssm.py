"""The port's SSM and hybrid families against the JAX package, on two
reduced models (float32, d 128, vocab 512, 4 layers):

- Mamba-2 (``reduced``: four ``mamba`` layers; d_inner 256, 16 SSD heads
  of 16, d_state 16, one group, chunk 32; in_proj (128, 560));
- Hymba (``reduced``: four ``hybrid`` layers; 4 / 2 heads of 32 and the
  same SSD mixer side by side, a sliding window of 16 except on layer 0,
  then an MLP of 256).

``ssd_chunked`` at even and odd S (the odd S scans one token a chunk) and
from a given state, ``mamba_apply`` with its state and ``mamba_decode``
(fp and through K1's plain version), prefill then decode against the full
sequence, the layer kinds, the param tree and forward logits, the LIS
order and the swap plan's bytes, the ``ModelExec`` steps with their state
at the fp and the all-int4 level, and one real-compute engine trace a
model against the JAX engine.

Tolerance: as ``test_torch_model.py`` states for float32, 1e-4 relative
and absolute (torch and XLA reduce the scan's einsums, the matmuls and the
norms in their own order; logits, pool contents and states are O(1)).
LIS scores agree to 1e-5 relative and the order exactly; byte counts
exactly. Greedy streams and the swap and resize logs are compared exactly
on traces checked free of near-ties (``MIN_GAP``).
"""
import dataclasses
import functools
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import MIN_GAP, record_gaps, to_np

from repro.configs import ServingConfig as JSC
from repro.configs import reduced as j_reduced
from repro.configs.archs import HYMBA_1P5B as J_HYMBA
from repro.configs.archs import MAMBA2_780M as J_MAMBA
from repro.core import profile_swap_sequence as j_profile
from repro.core import tree_bytes as j_tree_bytes
from repro.core.swap_plan import build_swap_plan as j_build_plan
from repro.engine import EngineConfig as JEC
from repro.engine import MorphServeEngine as JEngine
from repro.engine.cost_model import HardwareProfile as JHW
from repro.engine.kv_cache import StatePool as JStatePool
from repro.engine.kv_cache import kv_block_bytes
from repro.engine.model_exec import ModelExec as JExec
from repro.engine.traces import TraceRequest as JTR
from repro.models import lm as jlm
from repro.models import mamba as jm
from repro.quant import awq as j_awq
from repro_torch import bridge
from repro_torch.configs import ServingConfig as TSC
from repro_torch.configs import reduced as t_reduced
from repro_torch.configs.archs import HYMBA_1P5B as T_HYMBA
from repro_torch.configs.archs import MAMBA2_780M as T_MAMBA
from repro_torch.core import build_swap_plan as t_build_plan
from repro_torch.core import profile_swap_sequence as t_profile
from repro_torch.core import tree_bytes as t_tree_bytes
from repro_torch.engine import EngineConfig as TEC
from repro_torch.engine import MorphServeEngine as TEngine
from repro_torch.engine.cost_model import HardwareProfile as THW
from repro_torch.engine.kv_cache import StatePool as TStatePool
from repro_torch.engine.kv_cache import kv_block_bytes as t_kv_block_bytes
from repro_torch.engine.model_exec import ModelExec as TExec
from repro_torch.engine.traces import TraceRequest as TTR
from repro_torch.models import lm as tlm
from repro_torch.models import mamba as tm
from repro_torch.quant import qlinear as tq

TOL = dict(rtol=1e-4, atol=1e-4)
BS, CAP = 16, 12
MODELS = {"mamba": (J_MAMBA, T_MAMBA), "hymba": (J_HYMBA, T_HYMBA)}
ORDER = [2, 0, 3, 1]


@pytest.fixture
def free_compiled():
    """The test's JAX executables go with it (the JAX ModelExec and engine
    compile a prefill for every prompt length and a decode for every pool
    capacity): the file then stays within one worker's memory."""
    yield
    jax.clear_caches()
    gc.collect()


def cfgs(name, d_model=128):
    j, t = MODELS[name]
    return (j_reduced(j).replace(d_model=d_model),
            t_reduced(t).replace(d_model=d_model))


@functools.lru_cache(maxsize=3)
def model(name, d_model=128):
    """(JAX config, port config, JAX params, port params on the CPU)."""
    jc, tc = cfgs(name, d_model)
    params = jlm.init_params(jc, jax.random.PRNGKey(0))
    tparams = bridge.to_torch(np_tree(params), "cpu")
    return jc, tc, params, tparams


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def mixer(name, li=0, precision="fp"):
    """Layer ``li``'s SSD mixer params in both packages: ``fp``, or the
    JAX ``quantize_tree``'s int4 variant (``in_proj`` and ``out_proj``
    quantized, kernel-flagged) carried across by the bridge."""
    jc, tc, params, _ = model(name)
    layer = jlm.params_to_layer_list(jc, params)[li][1]
    jp = layer["mixer" if name == "mamba" else "ssm"]
    if precision == "int4":
        jp = j_awq.quantize_tree(jp, bits=4, use_kernel=True)
    tp = bridge.to_torch(np_tree(jp), "cpu")
    assert tq.is_quantized(tp["in_proj"]) == (precision == "int4")
    return jp, tp


def _x(S, seed=2, scale=0.5):
    return (np.random.default_rng(seed).standard_normal((2, S, 128))
            .astype(np.float32) * scale)


# ---------------------------------------------------------------------------
# the layer plan and the param tree
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(MODELS))
def test_layer_kinds_and_segments_match_jax(name):
    """Full width and reduced: the JAX package's layer kinds, and the
    segment plan, which splits Hymba's layers on their window."""
    j, t = MODELS[name]
    assert tlm.layer_kinds(t) == jlm.layer_kinds(j)
    assert tlm.segment_plan(t) == jlm.segment_plan(j)
    jc, tc = cfgs(name)
    assert tlm.layer_kinds(tc) == jlm.layer_kinds(jc)
    assert tlm.segment_plan(tc) == jlm.segment_plan(jc)
    kind = "mamba" if name == "mamba" else "hybrid"
    assert set(tlm.layer_kinds(tc)) == {kind}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_init_params_tree_matches_jax_structure(name):
    """The port's own init draws the JAX tree's shapes and dtypes
    (``dt_bias``, ``A_log``, ``D`` and the 0-d ``beta_a``/``beta_s`` in
    float32), and round-trips through the layer list."""
    jc, tc, params, _ = model(name)
    t = tlm.init_params(tc, torch.Generator().manual_seed(0))
    want = jax.tree.map(lambda a: (tuple(a.shape), a.dtype.name),
                        np_tree(params))
    got = jax.tree.map(lambda a: (tuple(a.shape),
                                  str(a.dtype).replace("torch.", "")), t,
                       is_leaf=torch.is_tensor)
    assert want == got
    ll = tlm.params_to_layer_list(tc, t)
    assert [k for k, _ in ll] == jlm.layer_kinds(jc)
    back = tlm.layer_list_to_params(tc, ll, t)
    for a, b in zip(jax.tree.leaves(back, is_leaf=torch.is_tensor),
                    jax.tree.leaves(t, is_leaf=torch.is_tensor)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the SSD scan and the mixer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("S", [32, 21])
def test_ssd_chunked_matches_jax(S, with_state):
    """Two groups of four heads at the chunk rule of ``mamba_apply`` (S = 32
    scans four chunks of 8; the odd S = 21 one token a chunk), from zero
    or from a given state: outputs and final state."""
    rng = np.random.default_rng(S + with_state)
    b, h, p, g, n = 2, 8, 16, 2, 16
    chunk = 8 if S == 32 else 1
    x = rng.standard_normal((b, S, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, S, h)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(h) * 0.3).astype(np.float32)
    Bm = rng.standard_normal((b, S, g, n)).astype(np.float32)
    Cm = rng.standard_normal((b, S, g, n)).astype(np.float32)
    s0 = (rng.standard_normal((b, h, p, n)).astype(np.float32)
          if with_state else None)
    y1, st1 = jm.ssd_chunked(*map(jnp.asarray, (x, dt, A, Bm, Cm)),
                             chunk=chunk, init_state=None if s0 is None
                             else jnp.asarray(s0))
    y2, st2 = tm.ssd_chunked(*map(torch.from_numpy, (x, dt, A, Bm, Cm)),
                             chunk=chunk, init_state=None if s0 is None
                             else torch.from_numpy(s0))
    np.testing.assert_allclose(to_np(y2), np.asarray(y1), **TOL)
    np.testing.assert_allclose(to_np(st2), np.asarray(st1), **TOL)


def test_chunk_rule():
    """``ssd_chunk_len`` is the JAX ``mamba_apply``'s rule: the config's
    chunk (32 here) or S if shorter, halved until it divides S, so an odd
    S past the chunk scans one token a chunk."""
    _, tc = cfgs("mamba")
    assert [tm.ssd_chunk_len(tc, S) for S in (64, 32, 24, 21, 33, 48)] == \
        [32, 32, 24, 21, 1, 16]


@pytest.mark.parametrize("precision", ["fp", "int4"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_mamba_apply_and_decode_match_jax(name, precision):
    """``mamba_apply`` with its state (conv tail and SSD state), at an odd
    length past the chunk (37 chunks of one token), then three
    ``mamba_decode`` steps from that state: outputs and states, with fp
    weights and with int4 ``in_proj``/``out_proj`` (the port through K1's
    plain version)."""
    jc, tc, _, _ = model(name)
    jp, tp = mixer(name, precision=precision)
    x = _x(37)
    jy, jst = jm.mamba_apply(jp, jc, jnp.asarray(x), return_state=True)
    ty, tst = tm.mamba_apply(tp, tc, torch.from_numpy(x), return_state=True)
    np.testing.assert_allclose(to_np(ty), np.asarray(jy), **TOL)
    for k in ("conv", "ssm"):
        assert tst[k].dtype == torch.float32
        np.testing.assert_allclose(to_np(tst[k]), np.asarray(jst[k]), **TOL)
    for t in range(3):
        xt = _x(1, seed=10 + t)
        jy, jst = jm.mamba_decode(jp, jc, jnp.asarray(xt), jst)
        ty, tst = tm.mamba_decode(tp, tc, torch.from_numpy(xt), tst)
        np.testing.assert_allclose(to_np(ty), np.asarray(jy), **TOL)
        for k in ("conv", "ssm"):
            np.testing.assert_allclose(to_np(tst[k]), np.asarray(jst[k]),
                                       **TOL)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_prefill_state_continues_decode(name):
    """The port's own twin of the JAX property test: prefill(x[:8])'s
    state and then decode(x[8:]) give the full sequence's outputs (chunked
    scan against the recurrent step, within ``TOL``)."""
    _, tc, _, _ = model(name)
    _, tp = mixer(name)
    x = torch.from_numpy(_x(12))
    full = tm.mamba_apply(tp, tc, x)
    out, st = tm.mamba_apply(tp, tc, x[:, :8], return_state=True)
    outs = [out]
    for t in range(8, 12):
        y, st = tm.mamba_decode(tp, tc, x[:, t:t + 1], st)
        outs.append(y)
    np.testing.assert_allclose(to_np(torch.cat(outs, 1)), to_np(full), **TOL)


# ---------------------------------------------------------------------------
# the model, the LIS profile and the swap plan
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("S", [64, 37])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_forward_logits_match_jax(name, S):
    """At two chunks of 32 and at an odd length past the chunk (a token a
    chunk); Hymba's window layers mask past 16 tokens."""
    jc, tc, params, tparams = model(name)
    toks = np.random.default_rng(S).integers(0, 512, (2, S)).astype(np.int32)
    want = jlm.forward(jc, params, jnp.asarray(toks))
    got = tlm.forward(tc, tparams, torch.from_numpy(toks).long())
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_lis_order_and_swap_plan_bytes_match_jax(name, free_compiled):
    """The LIS profile and the swap plan's fp and int4 bytes, layer by
    layer and at every level. The int4 variant quantizes ``in_proj``,
    ``out_proj`` and, in Hymba, the attention and MLP weights; ``conv_w``
    (under ``min_size``), ``A_log``, ``D``, ``dt_bias``, the norms and the
    0-d ``beta_a``/``beta_s`` stay as they are, as in JAX."""
    jc, tc, params, tparams = model(name)
    calib = np.random.default_rng(1).integers(0, 512, (2, 32)).astype(
        np.int32)
    pj = j_profile(jc, params, calib, bits=4)
    pt = t_profile(tc, tparams, torch.from_numpy(calib).long(), bits=4)
    assert pj.order == pt.order
    np.testing.assert_allclose(pj.lis, pt.lis, rtol=1e-5)
    np.testing.assert_allclose(pj.lts, pt.lts, rtol=1e-5)
    np.testing.assert_allclose(pj.lrs, pt.lrs, rtol=1e-5)
    jplan = j_build_plan(jc, params, pj.order, bits=4, use_kernel=True)
    tplan = t_build_plan(tc, tparams, pt.order, bits=4, use_kernel=True)
    assert jplan.fp_bytes == tplan.fp_bytes
    assert jplan.q_bytes == tplan.q_bytes
    assert jplan.levels == tplan.levels
    for level in jplan.levels:
        assert jplan.weight_bytes(level) == tplan.weight_bytes(level)
    assert j_tree_bytes(params) == t_tree_bytes(tparams)
    q = tplan.q_layers[0]
    ssm = q["mixer" if name == "mamba" else "ssm"]
    assert tq.is_quantized(ssm["in_proj"]) and tq.is_quantized(ssm["out_proj"])
    assert ssm["in_proj"].use_kernel
    for k in ("conv_w", "conv_b", "A_log", "D", "dt_bias"):
        assert isinstance(ssm[k], torch.Tensor)
    if name == "hymba":
        assert tq.is_quantized(q["attn"]["wq"])
        assert tq.is_quantized(q["mlp"]["w_down"])
        assert q["beta_a"].ndim == 0 and q["beta_a"] is \
            tplan.fp_layers[0][1]["beta_a"]


# ---------------------------------------------------------------------------
# the step functions
# ---------------------------------------------------------------------------
def _layer_lists(name, level):
    """The same layer list at ``level`` for both packages: the JAX plan's
    int4 layers (kernel-flagged) carried across."""
    jc, _, params, _ = model(name)
    plan = j_build_plan(jc, params, ORDER, bits=4, use_kernel=True)
    jll = plan.layer_list(level)
    tll = [(k, bridge.to_torch(np_tree(lp), "cpu")) for k, lp in jll]
    return jll, tll


def _close(t, j, live=slice(None)):
    np.testing.assert_allclose(to_np(t)[:, live], np.asarray(j)[:, live],
                               **TOL)


@pytest.mark.parametrize("level", [0, 4])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_model_exec_steps_match_jax(name, level, free_compiled):
    """Whole-prompt prefill of two requests at their exact lengths (21
    into slot 2, 32 into slot 0) and two decode steps over 4 slots (two
    live, two idle, whose state advances too, as in JAX): logits, the
    pool (Hymba's KV) and the SSM state of every slot after prefill and of
    the live slots after decode equal the JAX ModelExec's, which returns
    what the port updates in place."""
    jc, tc, params, tparams = model(name)
    jll, tll = _layer_lists(name, level)
    jx = JExec(jc, params, jlm.layer_kinds(jc))
    tx = TExec(tc, tparams, tlm.layer_kinds(tc))
    rng = np.random.default_rng(level + 3)
    hybrid = name == "hymba"
    shape = (jc.n_layers, CAP, BS, max(jc.n_kv_heads, 1),
             jc.resolved_head_dim or 1)
    pk = rng.standard_normal(shape).astype(np.float32)
    pv = rng.standard_normal(shape).astype(np.float32)
    jk, jv = jnp.asarray(pk), jnp.asarray(pv)
    tk, tv = torch.from_numpy(pk.copy()), torch.from_numpy(pv.copy())
    js = JStatePool(jc, 4)
    jconv, jssm = js.conv, js.ssm
    ts = TStatePool(tc, 4, device="cpu")
    assert ts.state_bytes_per_slot() == js.state_bytes_per_slot()
    for S, slot, ids in ((21, 2, [3, 5]), (32, 0, [1, 2])):
        toks = rng.integers(0, 512, (1, S)).astype(np.int32)
        ids = np.asarray(ids if hybrid else [], np.int32)
        jl, jk, jv, jconv, jssm = jx.prefill(
            jll, jnp.asarray(toks), jk, jv, jnp.asarray(ids), jconv, jssm,
            slot)
        tl = tx.prefill(tll, torch.from_numpy(toks), tk, tv,
                        torch.from_numpy(ids), ts.conv, ts.ssm, slot)
        np.testing.assert_allclose(to_np(tl), np.asarray(jl), **TOL)
        _close(ts.conv, jconv)
        _close(ts.ssm, jssm)
    if hybrid:
        _close(tk, jk, [1, 2, 3, 5])
        _close(tv, jv, [1, 2, 3, 5])
    pos = np.array([32, 0, 21, 0], np.int32)
    dtab = np.array([[1, 2, 4], [0] * 3, [3, 5, 0], [0] * 3], np.int32)
    for step in range(2):
        tokens = rng.integers(0, 512, (4, 1)).astype(np.int32)
        jl, jk, jv, jconv, jssm = jx.decode(
            jll, jnp.asarray(tokens), jnp.asarray(pos), jk, jv,
            jnp.asarray(dtab), jconv, jssm)
        tl = tx.decode(tll, torch.from_numpy(tokens), torch.from_numpy(pos),
                       tk, tv, torch.from_numpy(dtab), ts.conv, ts.ssm)
        np.testing.assert_allclose(to_np(tl)[[0, 2]], np.asarray(jl)[[0, 2]],
                                   **TOL)
        # the live slots' state: the idle slots both append to scratch
        # block 0, and the JAX decode reads back whichever write won
        _close(ts.conv, jconv, [0, 2])
        _close(ts.ssm, jssm, [0, 2])
        pos = pos + np.array([1, 0, 1, 0], np.int32)   # a new buffer: jax
        #                                     may still read the old one
    if hybrid:
        _close(tk, jk, [1, 2, 3, 4, 5])
        _close(tv, jv, [1, 2, 3, 4, 5])


def test_state_pool_and_bridge_carry_the_state():
    """``StatePool`` has the JAX pool's layers, shapes and bytes, and the
    bridge copies a JAX engine's per-slot SSM state into the port's engine
    in place; 0-d arrays and numpy scalars cross as 0-d tensors."""
    jc, tc = cfgs("hymba")
    js, ts = JStatePool(jc, 3), TStatePool(tc, 3, device="cpu")
    assert ts.layers == js.layers == [0, 1, 2, 3]
    assert tuple(ts.conv.shape) == tuple(js.conv.shape)
    assert tuple(ts.ssm.shape) == tuple(js.ssm.shape)
    rng = np.random.default_rng(0)
    src = dataclasses.make_dataclass("S", ["ssm_conv", "ssm_ssm"])(
        rng.standard_normal(js.conv.shape).astype(np.float32),
        rng.standard_normal(js.ssm.shape).astype(np.float32))
    conv = ts.conv
    bridge.copy_ssm_state(src, dataclasses.make_dataclass(
        "D", ["ssm_conv", "ssm_ssm"])(ts.conv, ts.ssm))
    assert ts.conv is conv
    np.testing.assert_array_equal(to_np(ts.conv), src.ssm_conv)
    np.testing.assert_array_equal(to_np(ts.ssm), src.ssm_ssm)
    with pytest.raises(ValueError, match="state shapes differ"):
        bridge.copy_ssm_state(src, dataclasses.make_dataclass(
            "D", ["ssm_conv", "ssm_ssm"])(ts.conv[:, :2], ts.ssm))
    for a in (np.asarray(np.float32(1.5)), np.float32(1.5)):
        t = bridge.to_torch({"beta": a}, "cpu")["beta"]
        assert t.ndim == 0 and t.dtype == torch.float32 and float(t) == 1.5
    assert TStatePool(t_reduced(T_HYMBA).replace(family="dense"), 2,
                      device="cpu").state_bytes_per_slot() == 0


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
def _serving(name, cls, blocks=8):
    """A tight budget: the weights + ``blocks`` float32 KV blocks (an SSM
    config's block is 0 bytes)."""
    jc, _, params, _ = model(name, ENGINE_D[name])
    wb = j_tree_bytes(params)
    bb = kv_block_bytes(jc, BS, 4)
    return cls(hbm_budget_bytes=int((wb + blocks * bb) / 0.95) + 2 * bb,
               kv_block_size=BS, max_batch_slots=4, max_seq_len=256,
               swap_levels=(0, 1, 2, 4), mode="performance",
               kv_resize_step_frac=0.25)


# the engine traces' widths: Mamba-2 at d 64, because a swap grows its pool
# by the freed bytes in 0-byte blocks and the JAX pool pads its (empty)
# arrays to the new capacity bucket, which costs that package ~2 KB of host
# memory a block (2^19 blocks at d 128)
ENGINE_D = {"mamba": 64, "hymba": 128}
# (arrival s, prompt, generated): a burst of eight that queues past the 4
# slots and a later pair, odd and even prompt lengths
TRACE = [(0.0, 37, 6), (0.0, 40, 6), (0.01, 29, 5), (0.01, 33, 6),
         (0.02, 24, 5), (0.02, 31, 6), (0.03, 45, 6), (0.03, 26, 5),
         (0.6, 35, 6), (0.65, 28, 5)]


@pytest.mark.parametrize("name", sorted(MODELS))
def test_real_engine_matches_jax(name, free_compiled):
    """Real compute, int4 layers through the wNa16 route, whole-prompt
    prefill at exact lengths: ten requests, eight of them in a burst over
    4 slots. A slow virtual hardware profile stretches the steps so that
    queue delay (and, for Hymba, KV pressure) swaps layers and resizes the
    pool (for Mamba-2, by its 0-byte blocks, tens of thousands of them,
    in both packages). Streams, morph logs and the report equal the JAX
    engine's; the per-slot SSM state is allocated in float32 on the
    engine's device."""
    jc, tc, params, tparams = model(name, ENGINE_D[name])
    ecfg = dict(policy="morph", compute="real", use_quant_kernel=True,
                seed=10)
    je = JEngine(jc, params, _serving(name, JSC), JEC(
        hw=JHW("slow", 1e9, 1e7, 2**30), **ecfg), swap_order=ORDER)
    te = TEngine(tc, tparams, _serving(name, TSC), TEC(
        hw=THW("slow", 1e9, 1e7, 2**30), **ecfg), swap_order=ORDER,
        device="cpu")
    assert te.ssm_conv.dtype == te.ssm_ssm.dtype == torch.float32
    assert tuple(te.ssm_ssm.shape) == tuple(je.ssm_ssm.shape)
    assert te.prefix_cache is None and not te._can_chunk()
    gaps = record_gaps(te)
    rj = je.run_trace([JTR(*s) for s in TRACE])
    rt = te.run_trace([TTR(*s) for s in TRACE])
    assert min(gaps) > MIN_GAP, f"near-tie in the trace: {min(gaps)}"
    assert rt.n_finished == rt.n_requests == len(TRACE)
    assert [r.generated for r in je.all_requests] == \
        [r.generated for r in te.all_requests]
    assert je.actuator.swap_log == te.actuator.swap_log
    assert je.resize_log == te.resize_log
    assert len(te.actuator.swap_log) >= 1 and len(te.resize_log) > 0
    assert all(r.prefill_chunks == 0 for r in te.all_requests)
    assert dataclasses.asdict(rj) == dataclasses.asdict(rt)
    if name == "mamba":
        assert t_kv_block_bytes(tc, BS, 4) == 0
        assert max(n for _, n in te.resize_log) > 10 ** 4
        assert te.pool.alloc.n_free == te.pool.num_blocks - 1
