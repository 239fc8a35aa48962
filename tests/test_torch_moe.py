"""The port's MoE expert FFN against the JAX package, on two reduced
models (float32, d 128, vocab 512):

- DeepSeek-V3 (``reduced``: ``mla_dense`` then three ``mla_moe`` layers;
  4 routed experts of d_ff 64, top-2, a sigmoid router whose selection
  bias steers only the choice, routed scaling 2.5, one shared expert; the
  MLA of ``test_torch_mla.py``);
- Llama-4 Maverick (``reduced``: ``dense, moe, dense, moe`` in one
  alternating segment; 4 routed experts of d_ff 64, top-1 softmax router,
  one shared expert; 4 heads over 2 kv heads).

``moe_apply`` at both capacities with fp and stacked int4 experts, the
stacked ``QTensor``, forward logits, the LIS order and the swap plan's
bytes, the four step functions at the fp and all-int4 levels, and a
real-compute engine trace that swaps and resizes. The JAX chunk steps run
under ``dispatch.set_mode("pallas_interpret")``, the numerics the port
always takes for MLA, as ``test_torch_mla.py`` does.

One recorded difference: the port keeps the router in full precision,
where the JAX ``quantize_tree`` quantizes it once D·E >= ``min_size`` and
the JAX ``moe_apply`` then raises.

Tolerances: one layer's output is float32 reduced in another order by
torch and XLA (matmuls, and the combine adding each token's K expert
outputs in expert order rather than in k order): rtol = atol = 2e-5;
logits and pool contents through four layers: 1e-4 (relative and
absolute; logits are O(1)). LIS scores agree to 1e-5 relative and the
order exactly; int4 payloads and byte counts exactly. Greedy streams and
the swap and resize logs are compared exactly on traces checked free of
near-ties (``MIN_GAP``).
"""
import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import MIN_GAP, record_gaps, to_np

from repro.configs import ServingConfig as JSC
from repro.configs import reduced as j_reduced
from repro.configs.archs import DEEPSEEK_V3_671B as J_DSV3
from repro.configs.archs import LLAMA4_MAVERICK_400B as J_MAV
from repro.core import profile_swap_sequence as j_profile
from repro.core import tree_bytes as j_tree_bytes
from repro.core.swap_plan import build_swap_plan as j_build_plan
from repro.engine import EngineConfig as JEC
from repro.engine import MorphServeEngine as JEngine
from repro.engine.cost_model import HardwareProfile as JHW
from repro.engine.kv_cache import kv_block_bytes
from repro.engine.model_exec import ModelExec as JExec
from repro.engine.traces import TraceRequest as JTR
from repro.kernels import dispatch
from repro.models import lm as jlm
from repro.models import moe as jmo
from repro.quant import awq as j_awq
from repro.quant import qlinear as jq
from repro_torch import bridge
from repro_torch.configs import ServingConfig as TSC
from repro_torch.configs import reduced as t_reduced
from repro_torch.configs.archs import DEEPSEEK_V3_671B as T_DSV3
from repro_torch.configs.archs import LLAMA4_MAVERICK_400B as T_MAV
from repro_torch.core import build_swap_plan as t_build_plan
from repro_torch.core import profile_swap_sequence as t_profile
from repro_torch.core import tree_bytes as t_tree_bytes
from repro_torch.engine import EngineConfig as TEC
from repro_torch.engine import MorphServeEngine as TEngine
from repro_torch.engine.cost_model import HardwareProfile as THW
from repro_torch.engine.model_exec import ModelExec as TExec
from repro_torch.engine.traces import TraceRequest as TTR
from repro_torch.models import lm as tlm
from repro_torch.models import moe as tmo
from repro_torch.quant import awq as t_awq
from repro_torch.quant import qlinear as tq

TOL = dict(rtol=2e-5, atol=2e-5)
STEP_TOL = dict(rtol=1e-4, atol=1e-4)
BS, CAP = 16, 12
MODELS = {"deepseek": (J_DSV3, T_DSV3), "maverick": (J_MAV, T_MAV)}
# the engine tests' swap order: an MoE layer of both models first
ORDER = [1, 2, 0, 3]
# DeepSeek-V3's selection bias in the tests: it changes which experts are
# chosen, with a margin between the K-th and (K+1)-th score (top_k in JAX
# and in torch may break a tie differently)
BIAS = np.array([0.1, -0.05, 0.0, 0.02], np.float32)


def cfgs(name):
    j, t = MODELS[name]
    return j_reduced(j), t_reduced(t)


@functools.lru_cache(maxsize=2)
def model(name):
    """(JAX config, port config, JAX params, port params on the CPU)."""
    jc, tc = cfgs(name)
    params = jlm.init_params(jc, jax.random.PRNGKey(0))
    tparams = bridge.to_torch(jax.tree.map(np.asarray, params), "cpu")
    return jc, tc, params, tparams


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@contextlib.contextmanager
def pallas_interpret():
    prev = dispatch.set_mode("pallas_interpret")
    try:
        yield
    finally:
        dispatch.set_mode(prev)


def moe_layer(name, li=1):
    """Layer ``li``'s MoE params in both packages (DeepSeek with ``BIAS``)."""
    jc, tc, params, tparams = model(name)
    jp = jlm.params_to_layer_list(jc, params)[li][1]["moe"]
    tp = tlm.params_to_layer_list(tc, tparams)[li][1]["moe"]
    if "router_bias" in jp:
        jp = dict(jp, router_bias=jnp.asarray(BIAS))
        tp = dict(tp, router_bias=torch.from_numpy(BIAS))
    return jp, tp


# ---------------------------------------------------------------------------
# the layer plan and the param tree
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(MODELS))
def test_layer_kinds_and_segments_match_jax(name):
    """Full width and reduced: the JAX package's layer kinds and segment
    plan (Maverick's alternating (dense, moe) pairs are one segment)."""
    j, t = MODELS[name]
    assert tlm.layer_kinds(t) == jlm.layer_kinds(j)
    jc, tc = cfgs(name)
    assert tlm.layer_kinds(tc) == jlm.layer_kinds(jc)
    assert tlm.segment_plan(tc) == jlm.segment_plan(jc)
    assert "moe" in "".join(tlm.layer_kinds(tc))


@pytest.mark.parametrize("name", sorted(MODELS))
def test_init_params_tree_matches_jax_structure(name):
    """The port's own init draws the JAX tree's shapes (``moe`` where an
    MoE layer has its FFN) and round-trips through the layer list."""
    jc, tc, params, _ = model(name)
    t = tlm.init_params(tc, torch.Generator().manual_seed(0))
    shapes = jax.tree.map(lambda a: tuple(a.shape), np_tree(params))
    tshapes = jax.tree.map(lambda a: tuple(a.shape), t,
                           is_leaf=lambda x: isinstance(x, torch.Tensor))
    assert shapes == tshapes
    ll = tlm.params_to_layer_list(tc, t)
    assert [k for k, _ in ll] == jlm.layer_kinds(jc)
    back = tlm.layer_list_to_params(tc, ll, t)
    for a, b in zip(jax.tree.leaves(back, is_leaf=torch.is_tensor),
                    jax.tree.leaves(t, is_leaf=torch.is_tensor)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# moe_apply
# ---------------------------------------------------------------------------
def _x(S=16, seed=2):
    return np.random.default_rng(seed).standard_normal((2, S, 128)).astype(
        np.float32)


def test_selection_bias_changes_the_choice_with_a_margin():
    """DeepSeek's ``BIAS`` moves some tokens to other experts and leaves
    every token's K-th score clear of the next."""
    jc, _ = cfgs("deepseek")
    jp, _ = moe_layer("deepseek")
    logits = _x().reshape(-1, 128) @ np.asarray(jp["router"])
    score = 1 / (1 + np.exp(-logits))
    K = jc.moe.top_k
    for bias in (BIAS, 0 * BIAS):
        s = np.sort(score + bias, axis=-1)[:, ::-1]
        assert (s[:, K - 1] - s[:, K]).min() > 1e-4
    pick = (lambda b: np.sort(np.argsort(-(score + b), -1)[:, :K], -1))
    assert (pick(BIAS) != pick(0 * BIAS)).any()


def _experts(name, experts):
    """The MoE params at an expert precision: ``fp``, or ``int4`` /
    ``int4-kernel`` (the JAX ``quantize_tree`` at a ``min_size`` that also
    quantizes the shared expert, unflagged / kernel-flagged, carried across
    by the bridge)."""
    jp, tp = moe_layer(name)
    if experts == "fp":
        return jp, tp
    jqp = j_awq.quantize_tree(jp, bits=4, min_size=1 << 12,
                              use_kernel=experts == "int4-kernel")
    tqp = bridge.to_torch(np_tree(jqp), "cpu")
    for k in ("w_gate", "w_up", "w_down"):
        assert tqp[k].packed.ndim == 3 and tqp[k].inv_act is None
        assert tqp[k].use_kernel == (experts == "int4-kernel")
    assert tq.is_quantized(tqp["shared"]["w_up"])
    assert not tq.is_quantized(tqp["router"])
    return jqp, tqp


@pytest.mark.parametrize("experts", ["fp", "int4", "int4-kernel"])
@pytest.mark.parametrize("cf", [-1.0, 1.25])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_moe_apply_matches_jax(name, cf, experts):
    """The output and the aux dict at no-drop capacity and at 1.25 (where
    the JAX side drops pairs), with fp experts and stacked int4 experts
    (the plain dequant route and K1's plain version)."""
    jc, tc, _, _ = model(name)
    jp, tp = _experts(name, experts)
    x = _x()
    want, waux = jmo.moe_apply(jp, jc, jnp.asarray(x), capacity_factor=cf)
    n0 = tmo.moe_apply.host_syncs
    got, aux = tmo.moe_apply(tp, tc, torch.from_numpy(x), capacity_factor=cf)
    assert tmo.moe_apply.host_syncs == n0 + 1
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)
    assert (float(waux["dropped_frac"]) > 0) == (cf > 0)
    for k in ("expert_load", "dropped_frac", "router_entropy"):
        np.testing.assert_allclose(to_np(aux[k]), np.asarray(waux[k]), **TOL)


def test_experts_without_rows_are_never_read():
    """The port multiplies only the rows routed to each expert: with the
    router steering every token away from expert 3, NaN weights there
    change nothing, fp or int4. (The JAX dispatch multiplies every expert's
    zero-padded buffer, so its output would turn NaN.)"""
    _, tc, _, _ = model("maverick")
    _, tp = moe_layer("maverick")
    router = tp["router"].clone()
    router[:, 3] = -1e3 * router[:, :3].abs().sum(-1)
    x = torch.from_numpy(_x()).abs()
    for p in (dict(tp, router=router),
              t_awq.quantize_tree(dict(tp, router=router), bits=4,
                                  use_kernel=True)):
        want, aux = tmo.moe_apply(p, tc, x, capacity_factor=-1.0)
        assert float(aux["expert_load"][3]) == 0.0
        bad = dict(p)
        for k in ("w_gate", "w_up", "w_down"):
            w = p[k]
            if tq.is_quantized(w):
                scales = w.scales.clone()
                scales[3] = float("nan")
                bad[k] = tq.QTensor(w.packed, scales, w.zeros, bits=w.bits,
                                    group=w.group, K=w.K, N=w.N,
                                    use_kernel=w.use_kernel)
            else:
                bad[k] = w.clone()
                bad[k][3] = float("nan")
        got, _ = tmo.moe_apply(bad, tc, x, capacity_factor=-1.0)
        assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# the stacked QTensor and quantize_tree
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(MODELS))
def test_stacked_qtensor_matches_jax(name):
    """``quantize_tree`` of an MoE layer: the same leaves quantized (each
    expert stack one stacked QTensor by RTN, ``w_down`` at K = 64 with the
    group shrunk to 64; router and norms fp) with the same payload and
    bytes; ``expert(e)`` views and their matmuls equal JAX's, through the
    dequant route and K1's plain version."""
    jc, tc, params, tparams = model(name)
    jlayer = jlm.params_to_layer_list(jc, params)[1][1]
    tlayer = tlm.params_to_layer_list(tc, tparams)[1][1]
    jql = j_awq.quantize_tree(jlayer, bits=4)
    tql = t_awq.quantize_tree(tlayer, bits=4)
    assert j_tree_bytes(jql) == t_tree_bytes(tql)
    assert tql["moe"]["router"] is tlayer["moe"]["router"]
    bridged = bridge.to_torch(np_tree(jql["moe"]), "cpu")
    x = np.random.default_rng(3).standard_normal((5, 128)).astype(np.float32)
    for k in ("w_gate", "w_up", "w_down"):
        j, t = jql["moe"][k], tql["moe"][k]
        assert (j.bits, j.group, j.K, j.N) == (t.bits, t.group, t.K, t.N)
        assert t.group == (64 if k == "w_down" else 128)
        assert j.nbytes == t.nbytes == bridged[k].nbytes
        np.testing.assert_array_equal(np.asarray(j.packed), to_np(t.packed))
        np.testing.assert_array_equal(to_np(bridged[k].packed),
                                      to_np(t.packed))
        np.testing.assert_allclose(to_np(t.scales), np.asarray(j.scales),
                                   rtol=1e-6)
        np.testing.assert_allclose(to_np(t.dequantize()),
                                   np.asarray(j.dequantize()), rtol=1e-6,
                                   atol=1e-6)
        for e in range(jc.moe.n_routed_experts):
            je, te = j.expert(e), t.expert(e)
            assert te.packed.is_contiguous() and te.packed.ndim == 2
            assert (je.bits, je.group, je.K, je.N, je.use_kernel) == \
                (te.bits, te.group, te.K, te.N, te.use_kernel)
            np.testing.assert_array_equal(np.asarray(je.packed),
                                          to_np(te.packed))
            xe = x[:, :te.K]
            for kernel in (False, True):
                want = jq.matmul(jnp.asarray(xe), je.with_use_kernel(kernel))
                got = tq.matmul(torch.from_numpy(xe),
                                te.with_use_kernel(kernel))
                np.testing.assert_allclose(to_np(got), np.asarray(want),
                                           **TOL)
    with pytest.raises(ValueError, match="stacked"):
        tql["moe"]["w_gate"].expert(0).expert(0)


def test_router_stays_full_precision_where_jax_fails():
    """The recorded difference. At D·E >= min_size (reduced DeepSeek-V3
    with 128 routed experts: 128 · 128) the JAX ``quantize_tree`` makes
    the router a QTensor and the JAX ``moe_apply`` raises TypeError; the
    port keeps the router fp and equals the JAX ``moe_apply`` run on the
    same quantized tree with the fp router put back."""
    jc, tc = cfgs("deepseek")
    jc = jc.replace(moe=dataclasses.replace(jc.moe, n_routed_experts=128))
    tc = tc.replace(moe=dataclasses.replace(tc.moe, n_routed_experts=128))
    jp = jmo.moe_init(jax.random.PRNGKey(5), jc, jnp.float32)
    jqp = j_awq.quantize_tree(jp, bits=4)
    assert jq.is_quantized(jqp["router"])
    x = _x()
    with pytest.raises(TypeError):
        jmo.moe_apply(jqp, jc, jnp.asarray(x), capacity_factor=-1.0)
    tp = bridge.to_torch(np_tree(jp), "cpu")
    tqp = t_awq.quantize_tree(tp, bits=4)
    assert tqp["router"] is tp["router"]
    assert tq.is_quantized(tqp["w_gate"])
    want, _ = jmo.moe_apply(dict(jqp, router=jp["router"]), jc,
                            jnp.asarray(x), capacity_factor=-1.0)
    got, _ = tmo.moe_apply(tqp, tc, torch.from_numpy(x), capacity_factor=-1.0)
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# the model, the LIS profile and the swap plan
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("cf", [None, -1.0])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_forward_logits_match_jax(name, cf):
    """At the default capacity factor (1.25 in both) and at no drop."""
    jc, tc, params, tparams = model(name)
    toks = np.random.default_rng(0).integers(0, 512, (2, 24)).astype(
        np.int32)
    kw = {} if cf is None else dict(moe_cf=cf)
    want = jlm.forward(jc, params, jnp.asarray(toks), **kw)
    got = tlm.forward(tc, tparams, torch.from_numpy(toks).long(), **kw)
    np.testing.assert_allclose(to_np(got), np.asarray(want), **STEP_TOL)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_lis_order_and_swap_plan_bytes_match_jax(name):
    """The LIS profile (through the MoE branch at no drop, int4 experts on
    the dequant route) and the swap plan's fp and int4 bytes, layer by
    layer and at every level."""
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
    moe = [i for i, k in enumerate(jlm.layer_kinds(jc)) if "moe" in k]
    for i in moe:
        w = tplan.q_layers[i]["moe"]["w_up"]
        assert w.packed.ndim == 3 and w.use_kernel


# ---------------------------------------------------------------------------
# the step functions
# ---------------------------------------------------------------------------
def _layer_lists(name, level):
    """The same layer list at ``level`` for both packages: the JAX plan's
    int4 layers (kernel-flagged, stacked experts) carried across."""
    jc, _, params, _ = model(name)
    plan = j_build_plan(jc, params, ORDER, bits=4, use_kernel=True)
    jll = plan.layer_list(level)
    tll = [(k, bridge.to_torch(np_tree(lp), "cpu")) for k, lp in jll]
    assert sum(1 for _, lp in tll
               if hasattr(lp["attn"]["wo"], "packed")) == level
    return jll, tll


def _pools(name, seed):
    """Pool contents: the latent pool (and the (1,) placeholder) for MLA,
    k and v pools for GQA, as numpy."""
    jc, _ = cfgs(name)
    rng = np.random.default_rng(seed)
    if jc.mla is not None:
        W = jc.mla.kv_lora_rank + jc.mla.qk_rope_head_dim
        return (rng.standard_normal((jc.n_layers, CAP, BS, 1, W)).astype(
            np.float32), None)
    shape = (jc.n_layers, CAP, BS, jc.n_kv_heads, jc.resolved_head_dim)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _jv(pv):
    """The JAX value pool operand (a fresh placeholder for MLA: its jitted
    steps donate it)."""
    return jnp.zeros((1,), jnp.float32) if pv is None else jnp.asarray(pv)


def _no_ssm():
    return jnp.zeros((0,), jnp.float32), jnp.zeros((0,), jnp.float32)


def _close_pools(tk, tv, jk, jv, live):
    np.testing.assert_allclose(to_np(tk)[:, live], np.asarray(jk)[:, live],
                               **STEP_TOL)
    if tv.ndim > 1:
        np.testing.assert_allclose(to_np(tv)[:, live],
                                   np.asarray(jv)[:, live], **STEP_TOL)


@pytest.mark.parametrize("level", [0, 4])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_model_exec_steps_match_jax(name, level):
    """Batched prefill, a decode step, then a chunk step (the JAX one under
    pallas_interpret): logits and the in-place pool updates equal the JAX
    ModelExec's at the fp level and with every layer int4 (experts through
    K1's plain version, one call per expert with rows)."""
    jc, tc, params, tparams = model(name)
    jll, tll = _layer_lists(name, level)
    jx = JExec(jc, params, jlm.layer_kinds(jc))
    tx = TExec(tc, tparams, tlm.layer_kinds(tc))
    pk, pv = _pools(name, level)
    tk = torch.from_numpy(pk.copy())
    tv = torch.zeros((1,)) if pv is None else torch.from_numpy(pv.copy())
    rng = np.random.default_rng(level + 1)
    n0 = tmo.moe_apply.host_syncs

    # 1. batched prefill: two prompts (20, 13 tokens) at Sp = 32
    toks = rng.integers(0, 512, (2, 32)).astype(np.int32)
    tables = np.array([[1, 2], [3, 4]], np.int32)
    lens = np.array([20, 13], np.int32)
    jl, jk, jv = jx.prefill_batch(jll, jnp.asarray(toks), jnp.asarray(pk),
                                  _jv(pv), jnp.asarray(tables),
                                  jnp.asarray(lens))
    tl = tx.prefill_batch(tll, torch.from_numpy(toks), tk, tv,
                          torch.from_numpy(tables), torch.from_numpy(lens))
    np.testing.assert_allclose(to_np(tl), np.asarray(jl), **STEP_TOL)
    _close_pools(tk, tv, jk, jv, [1, 2, 3, 4])

    # 2. one decode step: slots 0 and 1 live, slots 2-3 idle (scratch 0)
    tokens = np.array([[7], [9], [0], [0]], np.int32)
    pos = np.array([20, 13, 0, 0], np.int32)
    dtab = np.array([[1, 2, 5, 0], [3, 4, 0, 0], [0] * 4, [0] * 4],
                    np.int32)
    jl, jk, jv, _, _ = jx.decode(jll, jnp.asarray(tokens), jnp.asarray(pos),
                                 jk, _jv(None) if pv is None else jv,
                                 jnp.asarray(dtab), *_no_ssm())
    tl = tx.decode(tll, torch.from_numpy(tokens), torch.from_numpy(pos), tk,
                   tv, torch.from_numpy(dtab))
    np.testing.assert_allclose(to_np(tl)[:2], np.asarray(jl)[:2], **STEP_TOL)
    _close_pools(tk, tv, jk, jv, [1, 2, 3, 4, 5])

    # 3. one chunk of 11 tokens (padded to 16) at pos0 = 21 for slot 0
    chunk = np.zeros((1, 16), np.int32)
    chunk[0, :11] = rng.integers(0, 512, 11)
    ctab = np.array([1, 2, 5, 6], np.int32)
    with pallas_interpret():
        jl, jk, jv = jx.prefill_chunk(jll, jnp.asarray(chunk), jnp.int32(21),
                                      jk, _jv(None) if pv is None else jv,
                                      jnp.asarray(ctab))
    tl = tx.prefill_chunk(tll, torch.from_numpy(chunk), 21, tk, tv,
                          torch.from_numpy(ctab))
    np.testing.assert_allclose(to_np(tl)[:11], np.asarray(jl)[:11],
                               **STEP_TOL)
    _close_pools(tk, tv, jk, jv, [1, 2, 3, 4, 5, 6])
    # one host copy of the expert row counts per MoE layer and step
    n_moe = sum("moe" in k for k in tlm.layer_kinds(tc))
    assert tmo.moe_apply.host_syncs - n0 == 3 * n_moe


@pytest.mark.parametrize("name", sorted(MODELS))
def test_single_prefill_matches_jax(name):
    """Whole-prompt prefill of one request (the non-batched path) with the
    first layer of ``ORDER`` (an MoE layer) int4."""
    jc, tc, params, tparams = model(name)
    jll, tll = _layer_lists(name, 1)
    jx = JExec(jc, params, jlm.layer_kinds(jc))
    tx = TExec(tc, tparams, tlm.layer_kinds(tc))
    pk, pv = _pools(name, 9)
    tk = torch.from_numpy(pk.copy())
    tv = torch.zeros((1,)) if pv is None else torch.from_numpy(pv.copy())
    toks = np.random.default_rng(9).integers(0, 512, (1, 30)).astype(
        np.int32)
    ids = np.array([6, 2], np.int32)
    jl, jk, jv, _, _ = jx.prefill(jll, jnp.asarray(toks), jnp.asarray(pk),
                                  _jv(pv), jnp.asarray(ids), *_no_ssm(), 0)
    tl = tx.prefill(tll, torch.from_numpy(toks), tk, tv,
                    torch.from_numpy(ids))
    np.testing.assert_allclose(to_np(tl), np.asarray(jl), **STEP_TOL)
    _close_pools(tk, tv, jk, jv, slice(None))


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
def _serving(name, cls, blocks=8):
    """A tight budget: the weights + ``blocks`` float32 KV blocks."""
    jc, _, params, _ = model(name)
    wb = j_tree_bytes(params)
    bb = kv_block_bytes(jc, BS, 4)
    return cls(hbm_budget_bytes=int((wb + blocks * bb) / 0.95) + 2 * bb,
               kv_block_size=BS, max_batch_slots=4, max_seq_len=256,
               swap_levels=(0, 1, 2, 4), mode="performance",
               kv_resize_step_frac=0.25)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_real_engine_matches_jax(name):
    """Real compute, int4 layers (stacked int4 experts) through the wNa16
    route: five requests in two bursts. A slow virtual hardware profile
    stretches the steps so the controller swaps an MoE layer and then a
    second layer and resizes the pool within the trace; a 32-token budget
    chunks every prompt. Streams, morph logs and the report equal the JAX
    engine's (under pallas_interpret)."""
    jc, tc, params, tparams = model(name)
    spec = [(0.0, 36, 6), (0.01, 40, 6), (0.02, 28, 5), (0.3, 33, 6),
            (0.35, 24, 5)]
    ecfg = dict(policy="morph", compute="real", use_quant_kernel=True,
                max_tokens_per_step=32, seed=10)
    je = JEngine(jc, params, _serving(name, JSC), JEC(
        hw=JHW("slow", 1e9, 1e7, 2**30), **ecfg), swap_order=ORDER)
    te = TEngine(tc, tparams, _serving(name, TSC), TEC(
        hw=THW("slow", 1e9, 1e7, 2**30), **ecfg), swap_order=ORDER,
        device="cpu")
    gaps = record_gaps(te)
    with pallas_interpret():
        rj = je.run_trace([JTR(*s) for s in spec])
    rt = te.run_trace([TTR(*s) for s in spec])
    assert min(gaps) > MIN_GAP, f"near-tie in the trace: {min(gaps)}"
    assert rt.n_finished == rt.n_requests == 5
    assert [r.generated for r in je.all_requests] == \
        [r.generated for r in te.all_requests]
    assert je.actuator.swap_log == te.actuator.swap_log
    assert je.resize_log == te.resize_log
    assert len(te.actuator.swap_log) >= 2 and len(te.resize_log) > 0
    assert te.kinds[ORDER[0]].endswith("moe")
    assert sum(r.prefill_chunks for r in te.all_requests) > 5
    assert dataclasses.asdict(rj) == dataclasses.asdict(rt)
