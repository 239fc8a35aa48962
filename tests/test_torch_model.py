"""The port's dense model and paged data plane against the JAX package on
the reduced Llama-2 (4 layers, d 128, 4 heads, 2 kv heads, float32).

Tolerance: float32 end to end, but torch and XLA reduce every matmul and
softmax in their own order, and the differences compound through four
layers: logits and pool contents must agree to 1e-4 (relative and
absolute; logits are O(1)), far inside what a wrong mask, position or
dequant would move.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import jcfg, llama_params, same_free_ids, tcfg, to_np

from repro.core.swap_plan import build_swap_plan as j_build_plan
from repro.engine.kv_cache import PagedKVPool as JPool
from repro.engine.model_exec import ModelExec as JExec
from repro.models import lm as jlm
from repro_torch import bridge
from repro_torch.engine.kv_cache import PagedKVPool as TPool
from repro_torch.engine.model_exec import ModelExec as TExec
from repro_torch.models import lm as tlm

TOL = dict(rtol=1e-4, atol=1e-4)
BS, CAP = 16, 12


def test_forward_logits_match_jax():
    params, _, tparams = llama_params()
    toks = np.random.default_rng(0).integers(0, 512, (2, 24)).astype(
        np.int32)
    want = jlm.forward(jcfg(), params, jnp.asarray(toks))
    got = tlm.forward(tcfg(), tparams, torch.from_numpy(toks).long())
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)


def test_init_params_tree_matches_jax_structure():
    """The port's own init draws a tree of the JAX package's shape, on the
    generator's device, and round-trips through the layer list."""
    _, np_params, _ = llama_params()
    t = tlm.init_params(tcfg(), torch.Generator().manual_seed(0))
    shapes = jax.tree.map(lambda a: tuple(a.shape), np_params)
    tshapes = jax.tree.map(lambda a: tuple(a.shape), t,
                           is_leaf=lambda x: isinstance(x, torch.Tensor))
    assert shapes == tshapes
    ll = tlm.params_to_layer_list(tcfg(), t)
    back = tlm.layer_list_to_params(tcfg(), ll, t)
    assert torch.equal(back["segments"][0][0]["attn"]["wq"],
                       t["segments"][0][0]["attn"]["wq"])


def _layer_lists(level):
    """The same layer list at ``level`` for both packages: the JAX plan's
    int4 layers (kernel-flagged) carried across by the bridge."""
    params, _, _ = llama_params()
    plan = j_build_plan(jcfg(), params, [2, 0, 3, 1], bits=4,
                        use_kernel=True)
    jll = plan.layer_list(level)
    tll = [(k, bridge.to_torch(jax.tree.map(np.asarray, lp), "cpu"))
           for k, lp in jll]
    assert sum(1 for _, lp in tll
               if hasattr(lp["attn"]["wq"], "packed")) == level
    return jll, tll


def _no_ssm():
    """The JAX steps' (empty) SSM state operands; distinct buffers, since
    its jitted steps donate them."""
    return jnp.zeros((0,), jnp.float32), jnp.zeros((0,), jnp.float32)


def _pools(seed):
    cfg = jcfg()
    shape = (cfg.n_layers, CAP, BS, cfg.n_kv_heads, cfg.resolved_head_dim)
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("level", [0, 2])
def test_model_exec_steps_match_jax(level):
    """Batched prefill, then a decode step, then a chunk step — logits and
    the in-place pool updates equal the JAX ModelExec's, with int4 layers
    (at level 2) routed through the wNa16 plain version."""
    params, _, tparams = llama_params()
    jll, tll = _layer_lists(level)
    jx = JExec(jcfg(), params, jlm.layer_kinds(jcfg()))
    tx = TExec(tcfg(), tparams, tlm.layer_kinds(tcfg()))
    pk, pv = _pools(level)
    tk, tv = torch.from_numpy(pk.copy()), torch.from_numpy(pv.copy())
    rng = np.random.default_rng(level + 1)

    # 1. batched prefill: two prompts (20, 13 tokens) at Sp = 32
    toks = rng.integers(0, 512, (2, 32)).astype(np.int32)
    tables = np.array([[1, 2], [3, 4]], np.int32)
    lens = np.array([20, 13], np.int32)
    jl, jk, jv = jx.prefill_batch(jll, jnp.asarray(toks), jnp.asarray(pk),
                                  jnp.asarray(pv), jnp.asarray(tables),
                                  jnp.asarray(lens))
    tl = tx.prefill_batch(tll, torch.from_numpy(toks), tk, tv,
                          torch.from_numpy(tables), torch.from_numpy(lens))
    np.testing.assert_allclose(to_np(tl), np.asarray(jl), **TOL)
    np.testing.assert_allclose(to_np(tk), np.asarray(jk), **TOL)

    # 2. one decode step: slots 0 and 1 live, slots 2-3 idle (scratch 0)
    tokens = np.array([[7], [9], [0], [0]], np.int32)
    pos = np.array([20, 13, 0, 0], np.int32)
    dtab = np.array([[1, 2, 5, 0], [3, 4, 0, 0], [0] * 4, [0] * 4],
                    np.int32)
    jl, jk, jv, _, _ = jx.decode(jll, jnp.asarray(tokens), jnp.asarray(pos),
                                 jk, jv, jnp.asarray(dtab), *_no_ssm())
    tl = tx.decode(tll, torch.from_numpy(tokens), torch.from_numpy(pos), tk,
                   tv, torch.from_numpy(dtab))
    np.testing.assert_allclose(to_np(tl)[:2], np.asarray(jl)[:2], **TOL)
    live = [1, 2, 3, 4, 5]
    np.testing.assert_allclose(to_np(tk)[:, live], np.asarray(jk)[:, live],
                               **TOL)
    np.testing.assert_allclose(to_np(tv)[:, live], np.asarray(jv)[:, live],
                               **TOL)

    # 3. one chunk of 11 tokens (padded to 16) at pos0 = 21 for slot 0
    chunk = np.zeros((1, 16), np.int32)
    chunk[0, :11] = rng.integers(0, 512, 11)
    ctab = np.array([1, 2, 5, 6], np.int32)
    jl, jk, jv = jx.prefill_chunk(jll, jnp.asarray(chunk), jnp.int32(21),
                                  jk, jv, jnp.asarray(ctab))
    tl = tx.prefill_chunk(tll, torch.from_numpy(chunk), 21, tk, tv,
                          torch.from_numpy(ctab))
    np.testing.assert_allclose(to_np(tl)[:11], np.asarray(jl)[:11], **TOL)
    np.testing.assert_allclose(to_np(tk)[:, live], np.asarray(jk)[:, live],
                               **TOL)


def test_single_prefill_matches_jax():
    """Whole-prompt prefill of one request (the non-batched path)."""
    params, _, tparams = llama_params()
    jll, tll = _layer_lists(1)
    jx = JExec(jcfg(), params, jlm.layer_kinds(jcfg()))
    tx = TExec(tcfg(), tparams, tlm.layer_kinds(tcfg()))
    pk, pv = _pools(9)
    tk, tv = torch.from_numpy(pk.copy()), torch.from_numpy(pv.copy())
    toks = np.random.default_rng(9).integers(0, 512, (1, 32)).astype(
        np.int32)
    ids = np.array([6, 2], np.int32)
    jl, jk, _, _, _ = jx.prefill(jll, jnp.asarray(toks), jnp.asarray(pk),
                                 jnp.asarray(pv), jnp.asarray(ids),
                                 *_no_ssm(), 0)
    tl = tx.prefill(tll, torch.from_numpy(toks), tk, tv,
                    torch.from_numpy(ids))
    np.testing.assert_allclose(to_np(tl), np.asarray(jl), **TOL)
    np.testing.assert_allclose(to_np(tk), np.asarray(jk), **TOL)


def test_paged_pool_matches_jax():
    """Capacity buckets, resize within and across buckets, move_block and
    block gather/scatter give the JAX pool's contents and bookkeeping."""
    jp = JPool(jcfg(), 5, BS)
    tp = TPool(tcfg(), 5, BS, device="cpu")
    rng = np.random.default_rng(4)
    payload = rng.standard_normal((jcfg().n_layers, 3, BS, 2, 32)).astype(
        np.float32)
    for p in (jp, tp):
        p.scatter_blocks([1, 3, 4], payload, payload * 2)
        assert p.resize(7) and p.capacity == 8       # within the bucket
        p.move_block(3, 6)
        assert p.resize(12) and p.capacity == 16     # across: one copy
        p.alloc.alloc(5)
        assert not p.resize(3)                       # live tail: refused
    assert (jp.copies, jp.num_blocks) == (tp.copies, tp.num_blocks)
    assert same_free_ids(jp.alloc, tp.alloc)
    jk, jv = jp.gather_blocks([1, 4, 6])
    tk, tv = tp.gather_blocks([1, 4, 6])
    np.testing.assert_array_equal(jk, tk)
    np.testing.assert_array_equal(jv, tv)
    np.testing.assert_array_equal(np.asarray(jp.k), to_np(tp.k))
