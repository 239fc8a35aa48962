"""The port's MLA slice against the JAX package, on the reduced DeepSeek-V3
cut to its dense MLA layers (``n_layers=3``, ``first_k_dense=3``: three
``mla_dense`` layers at d 128, 4 heads, q_lora 64, kv_lora r = 32, rope 16,
nope 32, v 32, float32): the MLA projections, the latent mode of chunk
attention (K3-mla's plain version) against the JAX Pallas kernel in
interpret mode, the absorbed weights, the four step functions, the latent
pool, the LIS order, the sim-compute report and a real-compute engine
trace.

The JAX chunk step takes the absorbed numerics (the latent pool through
the chunk kernel) only under its Pallas dispatch modes; the port always
does. So every JAX chunk step here runs under
``dispatch.set_mode("pallas_interpret")``, and the mode is restored after.

Tolerances: attention outputs and projections are float32 reduced in
another order by torch and XLA: rtol = atol = 2e-5 (the JAX package's own
kernel tolerance); absorbed weights are a dequant and a reshape: 1e-6;
model-step logits and latent-pool contents compound the orders through
three layers: 1e-4 (relative and absolute; logits are O(1)). LIS scores
agree to 1e-5 relative and the order exactly. Swap variants: int4
payloads exactly, scales to 1e-6 and the AWQ ``inv_act`` to 1e-5
relative (float32 statistics summed in another order). The sim-compute
report is compared exactly; greedy token streams and the swap and resize
logs are compared exactly on a trace checked free of near-ties
(``MIN_GAP``), and a migrated request's stream exactly (the same engine
code on both sides).
"""
import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import MIN_GAP, record_gaps, same_free_ids, to_np

from repro.configs import ServingConfig as JSC
from repro.configs import reduced as j_reduced
from repro.configs.archs import DEEPSEEK_V3_671B as J_DSV3
from repro.core import profile_swap_sequence as j_profile
from repro.core import tree_bytes as j_tree_bytes
from repro.core.swap_plan import build_swap_plan as j_build_plan
from repro.engine import EngineConfig as JEC
from repro.engine import MorphServeEngine as JEngine
from repro.engine import azure_like as j_azure
from repro.engine.cost_model import HardwareProfile as JHW
from repro.engine.kv_cache import PagedKVPool as JPool
from repro.engine.kv_cache import kv_block_bytes
from repro.engine.model_exec import ModelExec as JExec
from repro.engine.model_exec import absorb_mla_decode_weights as j_absorb
from repro.engine.traces import TraceRequest as JTR
from repro.kernels import dispatch
from repro.kernels import paged_attention as jpa
from repro.models import layers as jL
from repro.models import lm as jlm
from repro.quant.qlinear import quantize_tensor as j_quantize
from repro_torch import bridge
from repro_torch.configs import ServingConfig as TSC
from repro_torch.configs import reduced as t_reduced
from repro_torch.configs.archs import DEEPSEEK_V3_671B as T_DSV3
from repro_torch.core import profile_swap_sequence as t_profile
from repro_torch.core import tree_bytes as t_tree_bytes
from repro_torch.engine import EngineConfig as TEC
from repro_torch.engine import MorphServeEngine as TEngine
from repro_torch.engine import azure_like as t_azure
from repro_torch.engine.cost_model import HardwareProfile as THW
from repro_torch.engine.kv_cache import PagedKVPool as TPool
from repro_torch.engine.model_exec import ModelExec as TExec
from repro_torch.engine.model_exec import absorb_mla_decode_weights as t_absorb
from repro_torch.engine.traces import TraceRequest as TTR
from repro_torch.kernels import AttentionSpec, ops, ref
from repro_torch.kernels.paged_attention import paged_chunk_mla
from repro_torch.models import layers as tL
from repro_torch.models import lm as tlm

TOL = dict(rtol=2e-5, atol=2e-5)
STEP_TOL = dict(rtol=1e-4, atol=1e-4)
BS, CAP = 16, 12
ORDER = [1, 0, 2]          # the engine tests' swap order (3 layers)


def _dense_mla(cfg):
    return cfg.replace(n_layers=3, moe=dataclasses.replace(
        cfg.moe, first_k_dense=3))


def jcfg():
    return _dense_mla(j_reduced(J_DSV3))


def tcfg():
    return _dense_mla(t_reduced(T_DSV3))


@functools.lru_cache(maxsize=1)
def mla_params():
    """(JAX params, numpy copy, port params on the CPU)."""
    params = jlm.init_params(jcfg(), jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, params)
    return params, np_params, bridge.to_torch(np_params, "cpu")


@contextlib.contextmanager
def pallas_interpret():
    prev = dispatch.set_mode("pallas_interpret")
    try:
        yield
    finally:
        dispatch.set_mode(prev)


def _width():
    m = jcfg().mla
    return m.kv_lora_rank + m.qk_rope_head_dim, m.kv_lora_rank


def _scale():
    m = jcfg().mla
    return (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5


def test_family_check_admits_every_family():
    """The dense MLA cut, DeepSeek-V3 with its MoE layers (full width and
    reduced) and Llama-4 Maverick have the JAX package's layer kinds, and so
    do Mamba-2 and Hymba (SSM and hybrid), Whisper (ENCDEC: the decoder-only
    plan of the JAX ``lm``) and InternVL2 (VLM), whose params build: the
    decoder-only ones through ``lm.init_params`` (InternVL2's with its
    projector), Whisper's encoder-decoder through ``encdec.init_params``."""
    from repro.configs.archs import LLAMA4_MAVERICK_400B as J_MAV
    from repro_torch.configs.archs import (HYMBA_1P5B, INTERNVL2_1B,
                                           LLAMA4_MAVERICK_400B,
                                           MAMBA2_780M, WHISPER_SMALL)
    assert tlm.layer_kinds(tcfg()) == jlm.layer_kinds(jcfg()) == \
        ["mla_dense"] * 3
    assert tlm.layer_kinds(T_DSV3.replace(n_layers=3)) == ["mla_dense"] * 3
    assert tlm.layer_kinds(T_DSV3.replace(n_layers=4)) == \
        ["mla_dense"] * 3 + ["mla_moe"]
    assert tlm.layer_kinds(T_DSV3) == jlm.layer_kinds(J_DSV3)
    assert tlm.layer_kinds(t_reduced(T_DSV3)) == \
        jlm.layer_kinds(j_reduced(J_DSV3))
    assert tlm.layer_kinds(LLAMA4_MAVERICK_400B) == jlm.layer_kinds(J_MAV)
    assert tlm.layer_kinds(LLAMA4_MAVERICK_400B.replace(n_layers=2)) == \
        ["dense", "moe"]
    p = tlm.init_params(t_reduced(T_DSV3), torch.Generator())
    assert "moe" in p["segments"][1][0] and "mlp" not in p["segments"][1][0]
    from repro.configs.archs import HYMBA_1P5B as J_HYMBA
    from repro.configs.archs import MAMBA2_780M as J_MAMBA
    for cfg, jc in ((MAMBA2_780M, J_MAMBA), (HYMBA_1P5B, J_HYMBA)):
        assert tlm.layer_kinds(cfg) == jlm.layer_kinds(jc)
        assert tlm.layer_kinds(t_reduced(cfg)) == \
            jlm.layer_kinds(j_reduced(jc))
        p = tlm.init_params(t_reduced(cfg), torch.Generator())
        assert len(tlm.params_to_layer_list(t_reduced(cfg), p)) == \
            t_reduced(cfg).n_layers
    from repro.configs.archs import INTERNVL2_1B as J_VLM
    from repro.configs.archs import WHISPER_SMALL as J_WHISPER
    from repro_torch.models import encdec as ted
    for cfg, jc in ((WHISPER_SMALL, J_WHISPER), (INTERNVL2_1B, J_VLM)):
        tlm.check_family(cfg)
        assert tlm.layer_kinds(cfg) == jlm.layer_kinds(jc) == \
            ["dense"] * cfg.n_layers
        assert tlm.layer_kinds(t_reduced(cfg)) == \
            jlm.layer_kinds(j_reduced(jc))
        p = tlm.init_params(t_reduced(cfg), torch.Generator())
        assert len(tlm.params_to_layer_list(t_reduced(cfg), p)) == \
            t_reduced(cfg).n_layers
        assert ("projector" in p) == (cfg is INTERNVL2_1B)
    p = ted.init_params(t_reduced(WHISPER_SMALL), torch.Generator())
    assert p["dec_blocks"]["self_attn"]["wq"].shape[0] == 4
    assert p["enc_blocks"]["attn"]["wq"].shape[0] == 2


def test_init_params_tree_matches_jax_structure():
    _, np_params, _ = mla_params()
    t = tlm.init_params(tcfg(), torch.Generator().manual_seed(0))
    shapes = jax.tree.map(lambda a: tuple(a.shape), np_params)
    tshapes = jax.tree.map(lambda a: tuple(a.shape), t,
                           is_leaf=lambda x: isinstance(x, torch.Tensor))
    assert shapes == tshapes


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------
def test_mla_projections_match_jax():
    """``_mla_qkv``, ``_mla_expand_kv`` and ``mla_prefill`` of one layer."""
    _, np_params, tparams = mla_params()
    jp = jax.tree.map(jnp.asarray, np_params["segments"][0][0]["attn"])
    jp = jax.tree.map(lambda a: a[1], jp)            # layer 1 of the stack
    tp = jax.tree.map(lambda a: a[1], tparams["segments"][0][0]["attn"],
                      is_leaf=lambda x: isinstance(x, torch.Tensor))
    x = np.random.default_rng(2).standard_normal((2, 12, 128)).astype(
        np.float32)
    pos = np.arange(12)[None, :] + 5
    want = jL._mla_qkv(jp, jcfg(), jnp.asarray(x), jnp.asarray(pos))
    got = tL._mla_qkv(tp, tcfg(), torch.from_numpy(x), torch.from_numpy(pos))
    for w, g in zip(want, got):
        np.testing.assert_allclose(to_np(g), np.asarray(w), **TOL)
    c_kv = want[2]
    for w, g in zip(jL._mla_expand_kv(jp, jcfg(), c_kv),
                    tL._mla_expand_kv(tp, tcfg(), got[2])):
        np.testing.assert_allclose(to_np(g), np.asarray(w), **TOL)
    jy, jlat = jL.mla_prefill(jp, jcfg(), jnp.asarray(x))
    ty, tlat = tL.mla_prefill(tp, tcfg(), torch.from_numpy(x))
    np.testing.assert_allclose(to_np(ty), np.asarray(jy), **TOL)
    np.testing.assert_allclose(to_np(tlat), np.asarray(jlat), **TOL)


def test_forward_logits_match_jax():
    params, _, tparams = mla_params()
    toks = np.random.default_rng(0).integers(0, 512, (2, 24)).astype(
        np.int32)
    want = jlm.forward(jcfg(), params, jnp.asarray(toks))
    got = tlm.forward(tcfg(), tparams, torch.from_numpy(toks).long())
    np.testing.assert_allclose(to_np(got), np.asarray(want), **STEP_TOL)


# ---------------------------------------------------------------------------
# the latent mode of chunk attention (K3-mla's plain version)
# ---------------------------------------------------------------------------
def _latent_case(seed, B, C, H, W, bs, pos0):
    """A latent pool (cap, bs, 1, W) and ragged tables: each sequence owns
    globally distinct blocks, the table is padded to a power of two with
    scratch 0, and the chunk's rows are scattered at ``pos0 ..``."""
    rng = np.random.default_rng(seed)
    need = -(-(pos0 + C) // bs)
    nb = 1 << (need - 1).bit_length()
    if nb == need:
        nb *= 2                                       # always some padding
    cap = B * need + 2
    pool = rng.standard_normal((cap, bs, 1, W)).astype(np.float32)
    perm = rng.permutation(np.arange(1, cap))
    tables = np.zeros((B, nb), np.int32)
    for b in range(B):
        tables[b, :need] = perm[b * need:(b + 1) * need]
    q = rng.standard_normal((B, C, H, W)).astype(np.float32)
    new = rng.standard_normal((B, C, 1, W)).astype(np.float32)
    pos = pos0 + np.arange(C)
    for b in range(B):
        pool[tables[b, pos // bs], pos % bs] = new[b]
    return q, new, pool, tables


def _latent_pair(q, new, pool, tables, pos0, dv, fused, scale):
    """The JAX Pallas kernel in interpret mode and the port's chunk route,
    both with the latent pool as keys and values."""
    if fused:
        want = jpa.paged_chunk_attention_fused(
            q, new, new, pool, pool, tables, pos0, scale=scale, dv=dv,
            interpret=True)
    else:
        want = jpa.paged_chunk_attention(q, pool, pool, tables, pos0,
                                         scale=scale, dv=dv, interpret=True)
    spec = AttentionSpec(scale=scale, q_heads=q.shape[2], kv_heads=1,
                         latent_dv=dv)
    tq, tn, tp, tt = (torch.from_numpy(a) for a in (q, new, pool, tables))
    got = ops.paged_latent_chunk_attention(tq, tp, tt, pos0, spec,
                                           latent_new=tn if fused else None)
    return got, want


@pytest.mark.parametrize("pos0", [0, 37])
@pytest.mark.parametrize("fused", [True, False])
def test_latent_chunk_matches_pallas_interpret(fused, pos0):
    """Both modes at the reduced latent width (48, values 32), two
    sequences on ragged tables: against the JAX kernel in interpret mode
    and its gather oracle. The fused mode reads the pool only below pos0,
    so scrubbing the chunk's own rows must not change its result."""
    W, dv = _width()
    q, new, pool, tables = _latent_case(7 + pos0 + fused, 2, 16, 4, W, 8,
                                        pos0)
    oracle = jpa.paged_chunk_gather_attention(q, pool, pool, tables, pos0,
                                              scale=_scale(), dv=dv)
    if fused:
        pos = pos0 + np.arange(16)
        for b in range(2):
            pool[tables[b, pos // 8], pos % 8] = 99.0
    got, want = _latent_pair(q, new, pool, tables, pos0, dv, fused,
                             _scale())
    assert got.shape == (2, 16, 4, dv)
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)
    np.testing.assert_allclose(to_np(got), np.asarray(oracle), **TOL)


@pytest.mark.parametrize("fused", [True, False])
def test_latent_chunk_full_width_matches_pallas_interpret(fused):
    """DeepSeek-V3's latent width on the card (576 = 512 + 64, values 512,
    bs 16, scale 192 ** -0.5) with two heads, at an unaligned offset."""
    q, new, pool, tables = _latent_case(40 + fused, 1, 8, 2, 576, 16, 21)
    got, want = _latent_pair(q, new, pool, tables, 21, 512, fused,
                             192 ** -0.5)
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)
    direct = ref.paged_chunk_ref(
        *(torch.from_numpy(a) for a in (q, new, new, pool, pool, tables)),
        21, scale=192 ** -0.5, fused_new=fused, dv=512)
    assert torch.equal(direct, got)


def test_latent_spec_and_wrapper_refuse_what_they_lack():
    """The latent spec takes one latent pool (one kv head, a width above
    latent_dv, no kv_quant), only the latent route takes it (the GQA chunk
    and decode routes refuse it, and it refuses a spec without latent_dv),
    and the CUDA wrapper raises for a width it is not built for instead of
    handing it to the plain version."""
    W, dv = _width()
    q, new, pool, tables = (torch.from_numpy(a) for a in
                            _latent_case(3, 1, 8, 4, W, 8, 5))
    spec = AttentionSpec(scale=0.2, kv_heads=1, latent_dv=dv)
    with pytest.raises(ValueError, match="one kv head"):
        ops.paged_latent_chunk_attention(q, pool.expand(-1, -1, 2, -1),
                                         tables, 5, spec)
    with pytest.raises(ValueError, match="below the latent width"):
        ops.paged_latent_chunk_attention(
            q, pool, tables, 5, AttentionSpec(kv_heads=1, latent_dv=W))
    with pytest.raises(ValueError, match="keeps fp blocks"):
        ops.paged_latent_chunk_attention(
            q, pool, tables, 5,
            AttentionSpec(kv_heads=1, latent_dv=dv, kv_quant=True))
    with pytest.raises(ValueError, match="takes a spec with latent_dv"):
        ops.paged_latent_chunk_attention(q, pool, tables, 5,
                                         AttentionSpec(kv_heads=1))
    with pytest.raises(ValueError, match="latent route"):
        ops.paged_prefill_attention(q, pool, pool, tables, 5, spec,
                                    k_new=new, v_new=new)
    with pytest.raises(ValueError, match="chunk-attention lane"):
        ops.paged_decode_attention(q[:, 0], new[:, 0], new[:, 0], pool, pool,
                                   tables, torch.tensor([5]), spec)
    with pytest.raises(ValueError, match="latent width"):
        paged_chunk_mla(q, new, pool, tables, 5, dv=dv, scale=0.2)
    big = _latent_case(4, 1, 8, 2, 576, 16, 5)
    tq, tn, tp, tt = (torch.from_numpy(a) for a in big)
    with pytest.raises(ValueError, match="CUDA tensor"):
        paged_chunk_mla(tq, tn, tp, tt, 5, dv=512, scale=0.2)
    with pytest.raises(ValueError, match="pool dtype"):
        paged_chunk_mla(tq, tn.half(), tp.half(), tt, 5, dv=512, scale=0.2)


# ---------------------------------------------------------------------------
# absorbed weights and the model steps
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("w_ukv", ["float", "int4"])
def test_absorbed_weights_match_jax(w_ukv):
    """``absorb_mla_decode_weights`` on a float ``w_ukv`` and on an int4
    QTensor (the JAX codec's, carried across by the bridge)."""
    params, _, _ = mla_params()
    jll = jlm.params_to_layer_list(jcfg(), params)
    jlp = [lp for _, lp in jll]
    if w_ukv == "int4":
        jlp = [dict(lp, attn=dict(lp["attn"], w_ukv=j_quantize(
            lp["attn"]["w_ukv"], bits=4, group=16))) for lp in jlp]
    tlp = [bridge.to_torch(jax.tree.map(np.asarray, lp), "cpu")
           for lp in jlp]
    assert (w_ukv == "int4") == hasattr(tlp[0]["attn"]["w_ukv"], "packed")
    want = j_absorb(jcfg(), tuple(jlp))
    got = t_absorb(tcfg(), tlp)
    for w, g in zip(want, got):
        assert "w_ukv" not in g["attn"]
        for name in ("wk_abs", "wv_abs"):
            np.testing.assert_allclose(to_np(g["attn"][name]),
                                       np.asarray(w["attn"][name]),
                                       rtol=1e-6, atol=1e-6)


def _layer_lists(level):
    """The same layer list at ``level`` for both packages: the JAX plan's
    int4 layers (kernel-flagged) carried across by the bridge."""
    params, _, _ = mla_params()
    plan = j_build_plan(jcfg(), params, ORDER, bits=4, use_kernel=True)
    jll = plan.layer_list(level)
    tll = [(k, bridge.to_torch(jax.tree.map(np.asarray, lp), "cpu"))
           for k, lp in jll]
    assert sum(1 for _, lp in tll
               if hasattr(lp["attn"]["wo"], "packed")) == level
    return jll, tll


def _latent_pools(seed):
    W, _ = _width()
    pk = np.random.default_rng(seed).standard_normal(
        (3, CAP, BS, 1, W)).astype(np.float32)
    return pk, torch.from_numpy(pk.copy())


def _placeholders():
    """The JAX steps' latent-pool placeholder v and (empty) SSM state: new
    buffers each call, since its jitted steps donate them."""
    return (jnp.zeros((1,), jnp.float32), jnp.zeros((0,), jnp.float32),
            jnp.zeros((0,), jnp.float32))


@pytest.mark.parametrize("level", [0, 3])
def test_model_exec_steps_match_jax(level):
    """Batched prefill, then a decode step, then a chunk step (the JAX one
    under pallas_interpret, where it takes the absorbed numerics) — logits
    and the in-place latent-pool updates equal the JAX ModelExec's, with
    int4 layers (at level 3) through the wNa16 plain version."""
    params, _, tparams = mla_params()
    jll, tll = _layer_lists(level)
    jx = JExec(jcfg(), params, jlm.layer_kinds(jcfg()))
    tx = TExec(tcfg(), tparams, tlm.layer_kinds(tcfg()))
    pk, tk = _latent_pools(level)
    tv = torch.zeros((1,))
    rng = np.random.default_rng(level + 1)

    # 1. batched prefill: two prompts (20, 13 tokens) at Sp = 32
    toks = rng.integers(0, 512, (2, 32)).astype(np.int32)
    tables = np.array([[1, 2], [3, 4]], np.int32)
    lens = np.array([20, 13], np.int32)
    jv, _, _ = _placeholders()
    jl, jk, _ = jx.prefill_batch(jll, jnp.asarray(toks), jnp.asarray(pk), jv,
                                 jnp.asarray(tables), jnp.asarray(lens))
    tl = tx.prefill_batch(tll, torch.from_numpy(toks), tk, tv,
                          torch.from_numpy(tables), torch.from_numpy(lens))
    np.testing.assert_allclose(to_np(tl), np.asarray(jl), **STEP_TOL)
    np.testing.assert_allclose(to_np(tk), np.asarray(jk), **STEP_TOL)

    # 2. one decode step: slots 0 and 1 live, slots 2-3 idle (scratch 0)
    tokens = np.array([[7], [9], [0], [0]], np.int32)
    pos = np.array([20, 13, 0, 0], np.int32)
    dtab = np.array([[1, 2, 5, 0], [3, 4, 0, 0], [0] * 4, [0] * 4],
                    np.int32)
    jl, jk, _, _, _ = jx.decode(jll, jnp.asarray(tokens), jnp.asarray(pos),
                                jk, *_placeholders()[:1],
                                jnp.asarray(dtab), *_placeholders()[1:])
    tl = tx.decode(tll, torch.from_numpy(tokens), torch.from_numpy(pos), tk,
                   tv, torch.from_numpy(dtab))
    np.testing.assert_allclose(to_np(tl)[:2], np.asarray(jl)[:2], **STEP_TOL)
    live = [1, 2, 3, 4, 5]
    np.testing.assert_allclose(to_np(tk)[:, live], np.asarray(jk)[:, live],
                               **STEP_TOL)

    # 3. one chunk of 11 tokens (padded to 16) at pos0 = 21 for slot 0
    chunk = np.zeros((1, 16), np.int32)
    chunk[0, :11] = rng.integers(0, 512, 11)
    ctab = np.array([1, 2, 5, 6], np.int32)
    with pallas_interpret():
        jl, jk, _ = jx.prefill_chunk(jll, jnp.asarray(chunk), jnp.int32(21),
                                     jk, _placeholders()[0],
                                     jnp.asarray(ctab))
    tl = tx.prefill_chunk(tll, torch.from_numpy(chunk), 21, tk, tv,
                          torch.from_numpy(ctab))
    np.testing.assert_allclose(to_np(tl)[:11], np.asarray(jl)[:11],
                               **STEP_TOL)
    live = [1, 2, 3, 4, 5, 6]
    np.testing.assert_allclose(to_np(tk)[:, live], np.asarray(jk)[:, live],
                               **STEP_TOL)
    assert tuple(tv.shape) == (1,) and float(tv[0]) == 0.0   # never touched


def test_single_prefill_matches_jax():
    """Whole-prompt prefill of one request (the non-batched path): logits
    and the latent rows scattered into its blocks."""
    params, _, tparams = mla_params()
    jll, tll = _layer_lists(1)
    jx = JExec(jcfg(), params, jlm.layer_kinds(jcfg()))
    tx = TExec(tcfg(), tparams, tlm.layer_kinds(tcfg()))
    pk, tk = _latent_pools(9)
    toks = np.random.default_rng(9).integers(0, 512, (1, 30)).astype(
        np.int32)
    ids = np.array([6, 2], np.int32)
    jl, jk, _, _, _ = jx.prefill(jll, jnp.asarray(toks), jnp.asarray(pk),
                                 *_placeholders()[:1], jnp.asarray(ids),
                                 *_placeholders()[1:], 0)
    tl = tx.prefill(tll, torch.from_numpy(toks), tk, torch.zeros((1,)),
                    torch.from_numpy(ids))
    np.testing.assert_allclose(to_np(tl), np.asarray(jl), **STEP_TOL)
    np.testing.assert_allclose(to_np(tk), np.asarray(jk), **STEP_TOL)


# ---------------------------------------------------------------------------
# the latent pool
# ---------------------------------------------------------------------------
def test_latent_pool_matches_jax():
    """Capacity buckets, resize within and across buckets, move_block and
    block export/import give the JAX latent pool's contents and
    bookkeeping; the value pool stays the (1,) placeholder, export carries
    ``v = None``, and the bridge copies the pool across."""
    W, _ = _width()
    jp = JPool(jcfg(), 5, BS)
    tp = TPool(tcfg(), 5, BS, device="cpu")
    assert tuple(tp.k.shape) == tuple(jp.k.shape) == (3, 8, BS, 1, W)
    assert tuple(tp.v.shape) == tuple(jp.v.shape) == (1,)
    payload = np.random.default_rng(4).standard_normal(
        (3, 3, BS, 1, W)).astype(np.float32)
    for p in (jp, tp):
        p.scatter_blocks([1, 3, 4], payload, payload * 2)   # v is ignored
        assert p.resize(7) and p.capacity == 8       # within the bucket
        p.move_block(3, 6)
        assert p.resize(12) and p.capacity == 16     # across: one copy
        p.alloc.alloc(5)
        assert not p.resize(3)                       # live tail: refused
    assert (jp.copies, jp.num_blocks) == (tp.copies, tp.num_blocks)
    assert same_free_ids(jp.alloc, tp.alloc)
    assert tuple(tp.v.shape) == (1,)
    jk, jv = jp.gather_blocks([1, 4, 6])
    tk, tv = tp.gather_blocks([1, 4, 6])
    assert jv is None and tv is None
    np.testing.assert_array_equal(jk, tk)
    np.testing.assert_array_equal(np.asarray(jp.k), to_np(tp.k))
    tp.move_blocks([6, 4], [2, 5])
    np.testing.assert_array_equal(to_np(tp.k)[:, [2, 5]], tk[:, [2, 1]])
    assert tp.resize(9) and tp.resize(7) and tp.capacity == 8
    other = TPool(tcfg(), 16, BS, device="cpu")
    bridge.copy_pool_state(jp, other)
    np.testing.assert_array_equal(to_np(other.k), np.asarray(jp.k))
    with pytest.raises(ValueError, match="keeps fp blocks"):
        tp.quantize_blocks([1], bits=8)


# ---------------------------------------------------------------------------
# the morphing substrate and the engine
# ---------------------------------------------------------------------------
def test_lis_order_matches_jax():
    params, _, tparams = mla_params()
    calib = np.random.default_rng(1).integers(0, 512, (2, 32)).astype(
        np.int32)
    pj = j_profile(jcfg(), params, calib, bits=4)
    pt = t_profile(tcfg(), tparams, torch.from_numpy(calib).long(), bits=4)
    assert pj.order == pt.order
    np.testing.assert_allclose(pj.lis, pt.lis, rtol=1e-5)
    np.testing.assert_allclose(pj.lts, pt.lts, rtol=1e-5)
    np.testing.assert_allclose(pj.lrs, pt.lrs, rtol=1e-5)
    assert j_tree_bytes(params) == t_tree_bytes(tparams)


def _serving(cls, blocks=8):
    """A tight budget: the weights + ``blocks`` float32 latent blocks."""
    params, _, _ = mla_params()
    wb = j_tree_bytes(params)
    bb = kv_block_bytes(jcfg(), 16, 4)
    return cls(hbm_budget_bytes=int((wb + blocks * bb) / 0.95) + 2 * bb,
               kv_block_size=16, max_batch_slots=4, max_seq_len=256,
               swap_levels=(0, 1, 2, 3), mode="performance",
               kv_resize_step_frac=0.25)


def test_swap_variants_of_an_mla_layer_match_jax():
    """``quantize_tree`` on an MLA layer: the same leaves are quantized
    (every projection and MLP weight at this ``min_size``; the q/kv norms
    stay dense and shared) with the same int4 payload, and an AWQ variant
    of ``w_dkv`` calibrated on the same activations equalizes alike."""
    from repro.quant import awq as j_awq
    from repro_torch.quant import awq as t_awq
    params, _, tparams = mla_params()
    jlayer = jlm.params_to_layer_list(jcfg(), params)[2][1]
    tlayer = tlm.params_to_layer_list(tcfg(), tparams)[2][1]
    acts = (np.random.default_rng(5).standard_normal((64, 128))
            * np.linspace(0.2, 3, 128)).astype(np.float32)
    jq = j_awq.quantize_tree(jlayer, bits=4, group=32, min_size=1 << 12,
                             calib_acts={"attn/w_dkv": jnp.asarray(acts)})
    tq = t_awq.quantize_tree(tlayer, bits=4, group=32, min_size=1 << 12,
                             calib_acts={"attn/w_dkv": torch.from_numpy(acts)})
    for sub in ("attn", "mlp"):
        for k, j in jq[sub].items():
            t = tq[sub][k]
            assert hasattr(j, "packed") == hasattr(t, "packed"), (sub, k)
            if not hasattr(j, "packed"):
                continue
            assert (j.bits, j.group, j.K, j.N) == (t.bits, t.group, t.K, t.N)
            np.testing.assert_array_equal(np.asarray(j.packed),
                                          to_np(t.packed))
            np.testing.assert_allclose(to_np(t.scales), np.asarray(j.scales),
                                       rtol=1e-6)
            assert (j.inv_act is None) == (t.inv_act is None) == \
                (k != "w_dkv"), k
    np.testing.assert_allclose(to_np(tq["attn"]["w_dkv"].inv_act),
                               np.asarray(jq["attn"]["w_dkv"].inv_act),
                               rtol=1e-5)
    for norm in ("q_norm", "kv_norm"):
        assert tq["attn"][norm]["scale"] is tlayer["attn"][norm]["scale"]


def test_sim_report_matches_jax():
    """Sim compute: the same host logic on the same trace gives the same
    ServingReport, streams and morph logs, exactly."""
    params, _, tparams = mla_params()
    kw = dict(duration_s=6.0, base_rps=3.0, seed=3, prompt_mean=60,
              gen_mean=16, prompt_max=200, gen_max=32)
    ecfg = dict(policy="morph", compute="sim", max_tokens_per_step=64,
                prefix_caching=True)
    je = JEngine(jcfg(), params, _serving(JSC), JEC(**ecfg),
                 swap_order=ORDER)
    te = TEngine(tcfg(), tparams, _serving(TSC), TEC(**ecfg),
                 swap_order=ORDER, device="cpu")
    rj = je.run_trace(j_azure(**kw))
    rt = te.run_trace(t_azure(**kw))
    assert dataclasses.asdict(rj) == dataclasses.asdict(rt)
    assert [r.generated for r in je.all_requests] == \
        [r.generated for r in te.all_requests]
    assert je.actuator.swap_log == te.actuator.swap_log
    assert je.resize_log == te.resize_log
    assert je.chunk_log == te.chunk_log


def test_real_engine_matches_jax():
    """Real compute, int4 layers through the wNa16 route: five requests in
    two bursts. A slow virtual hardware profile stretches the steps so the
    controller swaps layers and resizes the latent pool within the trace; a
    32-token budget chunks every prompt, so chunks run the latent mode
    (the JAX engine under pallas_interpret). Streams and morph logs equal
    the JAX engine's, and a request's latent blocks export with v None."""
    params, _, tparams = mla_params()
    spec = [(0.0, 36, 6), (0.01, 40, 6), (0.02, 28, 5), (0.3, 33, 6),
            (0.35, 24, 5)]
    ecfg = dict(policy="morph", compute="real", use_quant_kernel=True,
                max_tokens_per_step=32, seed=10)
    je = JEngine(jcfg(), params, _serving(JSC), JEC(
        hw=JHW("slow", 1e9, 1e7, 2**30), **ecfg), swap_order=ORDER)
    te = TEngine(tcfg(), tparams, _serving(TSC), TEC(
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
    assert len(te.actuator.swap_log) > 0 and len(te.resize_log) > 0
    assert sum(r.prefill_chunks for r in te.all_requests) > 5
    assert dataclasses.asdict(rj) == dataclasses.asdict(rt)


def test_export_import_mid_decode_continues_the_stream():
    """An MLA request exported mid-decode carries its latent blocks (and
    ``v = None``); imported into a second engine it finishes with the
    stream of an undisturbed run."""
    from repro_torch.engine.request import RState
    _, _, tparams = mla_params()
    tokens = tuple(int(t) for t in
                   np.random.default_rng(3).integers(1, 512, 40))

    def engine():
        return TEngine(tcfg(), tparams, _serving(TSC, blocks=64),
                       TEC(compute="real", seed=0), swap_order=ORDER,
                       device="cpu")

    ref_e = engine()
    want = ref_e.submit(TTR(0.0, len(tokens), 10, tokens))
    while want.state != RState.FINISHED:
        ref_e.step()
    src = engine()
    r = src.submit(TTR(0.0, len(tokens), 10, tokens))
    while len(r.generated) < 4:
        src.step()
    st = src.export_request_state(r)
    W, _ = _width()
    assert st.v is None and st.k.shape == (3, st.n_blocks, BS, 1, W)
    src.detach_request(r)
    dst = engine()
    r2 = dst.import_request_state(st)
    while r2.state != RState.FINISHED:
        dst.step()
    assert list(r2.generated) == list(want.generated)


@pytest.mark.cuda
def test_cuda_latent_chunk_matches_plain():
    """K3-mla against its plain version on the card at the latent width it
    is built for (few heads; chip_smoke.py runs H = 128)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode")
    q, new, pool, tables = (torch.from_numpy(a).cuda() for a in
                            _latent_case(5, 1, 16, 4, 576, 16, 13))
    for fused in (True, False):
        kw = dict(scale=192 ** -0.5, fused_new=fused)
        a = paged_chunk_mla(q, new, pool, tables, 13, dv=512, **kw)
        b = ref.paged_chunk_ref(q, new, new, pool, pool, tables, 13, dv=512,
                                **kw)
        torch.testing.assert_close(a, b, **TOL)
