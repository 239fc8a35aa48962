"""The port's quantized-KV relief tier against the JAX package: the pool's
int8 sidecar (quantize / dequantize, clear, move, transfer, resize), the
plain versions of the kernels' kv_quant lane (K2-q, K3-q), one decode and
one chunk step of ``ModelExec`` over a partly quantized pool, and the
serving engine with ``KVQuantConfig(enabled=True)`` in real compute.

Tolerances: the codec's int8 payload, scales and zeros are compared
exactly — both packages round half to even and divide in float32 in the
same order, and no one-LSB flip was seen on these inputs. Attention outputs
are float32 with sums reduced in another order by torch and XLA:
rtol = atol = 2e-5 (the JAX package's own kernel tolerance); model-step
logits compound that through four layers: 1e-4. Greedy token streams are
compared exactly on setups checked free of near-ties (``MIN_GAP``).
"""
import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import (MIN_GAP, ORDER, jcfg, llama_params, record_gaps,
                          serving, tcfg, to_np)

from repro.configs import ServingConfig as JSC
from repro.core import kv_codec as j_codec
from repro.core.swap_plan import build_swap_plan as j_build_plan
from repro.engine import EngineConfig as JEC
from repro.engine import KVQuantConfig as JKQ
from repro.engine import MorphServeEngine as JEngine
from repro.engine.cost_model import HardwareProfile as JHW
from repro.engine.kv_cache import PagedKVPool as JPool
from repro.engine.model_exec import ModelExec as JExec
from repro.engine.traces import TraceRequest as JTR
from repro.kernels import paged_attention as jpa
from repro.models import lm as jlm
from repro_torch import bridge
from repro_torch.configs import ServingConfig as TSC
from repro_torch.engine import EngineConfig as TEC
from repro_torch.engine import KVQuantConfig as TKQ
from repro_torch.engine import MorphServeEngine as TEngine
from repro_torch.engine.cost_model import HardwareProfile as THW
from repro_torch.engine.kv_cache import PagedKVPool as TPool
from repro_torch.engine.model_exec import ModelExec as TExec
from repro_torch.engine.traces import TraceRequest as TTR
from repro_torch.kernels import ops, ref
from repro_torch.kernels.paged_attention import paged_chunk, paged_decode
from repro_torch.models import lm as tlm

TOL = dict(rtol=2e-5, atol=2e-5)
STEP_TOL = dict(rtol=1e-4, atol=1e-4)
BS = 16
SIDECAR = ("qk", "qv", "k_scale", "v_scale", "k_zero", "v_zero")


# ---------------------------------------------------------------------------
# the pool's sidecar
# ---------------------------------------------------------------------------
def _pool_pair(n=8, ids=(1, 2, 3), seed=0):
    """A JAX pool and a port pool holding the same random fp content in
    ``ids``."""
    jp, tp = JPool(jcfg(), n, BS), TPool(tcfg(), n, BS, device="cpu")
    rng = np.random.default_rng(seed)
    shape = (jcfg().n_layers, len(ids), BS, jp.kvh, jp.dh)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    jp.scatter_blocks(list(ids), jnp.asarray(k), jnp.asarray(v))
    tp.scatter_blocks(list(ids), k, v)
    return jp, tp, k, v


def _assert_same_state(jp, tp):
    """Pools, sidecar and quant map equal, exactly."""
    assert dict(jp.qbits) == dict(tp.qbits)
    np.testing.assert_array_equal(np.asarray(jp.k), to_np(tp.k))
    np.testing.assert_array_equal(np.asarray(jp.v), to_np(tp.v))
    assert (jp.qk is None) == (tp.qk is None)
    if jp.qk is not None:
        for name in SIDECAR:
            np.testing.assert_array_equal(
                np.asarray(getattr(jp, name)), to_np(getattr(tp, name)),
                err_msg=name)


@pytest.mark.parametrize("bits", [8, 4])
def test_pool_quantize_dequantize_matches_jax(bits):
    """Quantize, a skipped re-quantize and dequantize in place: payload,
    scale, zero, zeroed fp slots and the restored fp content equal the JAX
    pool's exactly, and the round trip is within half a step of the
    codec."""
    jp, tp, k0, v0 = _pool_pair()
    assert tp.kv_quant_bundle() is None and tp.qk is None
    for p in (jp, tp):
        assert p.quantize_blocks([1, 2], bits=bits) == [1, 2]
        assert p.quantize_blocks([1], bits=bits) == []
    _assert_same_state(jp, tp)
    assert tp.qbits == {1: bits, 2: bits}
    assert not torch.any(tp.k[:, [1, 2]]) and torch.any(tp.qk[:, [1, 2]])
    assert int(tp.qk.abs().max()) <= (1 << (bits - 1)) - 1
    bundle = tp.kv_quant_bundle()
    assert [t.dtype for t in bundle] == [torch.int8] * 2 + [torch.float32] * 4
    step = float(max(tp.k_scale.max(), tp.v_scale.max()))
    for p in (jp, tp):
        assert p.dequantize_blocks([1, 2, 3]) == [1, 2]
    _assert_same_state(jp, tp)
    assert tp.kv_quant_bundle() is None
    np.testing.assert_allclose(to_np(tp.k[:, [1, 2, 3]]), k0,
                               atol=0.51 * step)
    np.testing.assert_allclose(to_np(tp.v[:, [1, 2, 3]]), v0,
                               atol=0.51 * step)
    assert not torch.any(tp.k_scale) and not torch.any(tp.v_zero)


def test_pool_clear_quant_leaves_stale_payload_inert():
    """clear_quant (the block-free choke point) zeroes only the scale/zero
    rows: a re-allocated block reads exactly its new fp content through the
    kernels' FMA although the stale int8 payload is still in the mirror."""
    jp, tp, _, _ = _pool_pair(ids=(1, 2))
    for p in (jp, tp):
        p.quantize_blocks([1, 2], bits=8)
        assert p.clear_quant([1, 5]) == [1]
    _assert_same_state(jp, tp)
    assert tp.qbits == {2: 8} and torch.any(tp.qk[:, 1])
    k1 = np.random.default_rng(9).standard_normal(
        (jcfg().n_layers, 1, BS, tp.kvh, tp.dh)).astype(np.float32)
    tp.scatter_blocks([1], k1, k1)
    fma = (tp.k[:, 1] + tp.qk[:, 1].float()
           * tp.k_scale[:, 1, None, None, None]
           + tp.k_zero[:, 1, None, None, None])
    np.testing.assert_array_equal(to_np(fma), k1[:, 0])


@pytest.mark.parametrize("how", ["move_block", "move_blocks"])
def test_pool_move_carries_sidecar(how):
    """A block move (tail compaction) carries the fp slot, the int8 payload
    and the scale/zero rows, and zeroes the vacated rows' scale/zero: the
    same state as the JAX pool's ``move_block`` (and its engine's inline
    compaction, which ``move_blocks`` replaces)."""
    jp, tp, _, _ = _pool_pair(ids=(1, 2, 3))
    for p in (jp, tp):
        p.quantize_blocks([1, 2], bits=8)
    moves = [(1, 5), (3, 6), (2, 7)]           # block 3 stays fp
    for s, d in moves:
        jp.move_block(s, d)
    if how == "move_block":
        for s, d in moves:
            tp.move_block(s, d)
    else:
        tp.move_blocks([s for s, _ in moves], [d for _, d in moves])
        for s, d in moves:                     # the engine keeps the map
            if s in tp.qbits:
                tp.qbits[d] = tp.qbits.pop(s)
    # the JAX pool leaves the vacated fp slots as they were, like the port
    _assert_same_state(jp, tp)
    assert tp.qbits == {5: 8, 7: 8}
    for s, _ in moves:
        assert not torch.any(tp.k_scale[:, s]) and not torch.any(
            tp.v_zero[:, s])


def test_pool_quant_gather_scatter_round_trip():
    """gather_quant_blocks → scatter_quant_blocks moves compressed blocks
    between pools as they are (the migration wire path); the payload equals
    the JAX pool's and the destination dequantizes to the source's
    content."""
    jp, tp, _, _ = _pool_pair(ids=(1, 2))
    for p in (jp, tp):
        p.quantize_blocks([1, 2], bits=4)
    pj, pt = jp.gather_quant_blocks([2, 1]), tp.gather_quant_blocks([2, 1])
    for a, b in zip(pj, pt):
        np.testing.assert_array_equal(np.asarray(a), b)
    with pytest.raises(ValueError, match="non-quantized"):
        tp.gather_quant_blocks([3])
    jd, td = JPool(jcfg(), 8, BS), TPool(tcfg(), 8, BS, device="cpu")
    jd.scatter_quant_blocks([4, 6], pj, bits=4)
    td.scatter_quant_blocks([4, 6], pt, bits=4)
    _assert_same_state(jd, td)
    for p in (jp, jd, tp, td):
        p.dequantize_blocks(list(p.qbits))
    np.testing.assert_array_equal(to_np(td.k[:, [4, 6]]),
                                  to_np(tp.k[:, [2, 1]]))
    _assert_same_state(jd, td)


def test_pool_resize_preserves_sidecar_across_bucket_crossing():
    """A grow and a shrink across capacity buckets pad / slice the sidecar
    with the pools (one copy each way), as the JAX pool does."""
    jp, tp, _, _ = _pool_pair(ids=(1, 3))
    for p in (jp, tp):
        p.quantize_blocks([1, 3], bits=8)
        assert p.resize(20) and p.capacity == 32
    _assert_same_state(jp, tp)
    assert tuple(tp.k_scale.shape) == (jcfg().n_layers, 32)
    for p in (jp, tp):
        p.clear_quant([3])
        assert p.resize(6) and p.capacity == 8
        p.dequantize_blocks([1])
    _assert_same_state(jp, tp)
    assert tp.copies == jp.copies == 2


def test_bridge_copies_a_quantized_pool():
    jp, tp, _, _ = _pool_pair(ids=(1, 2))
    jp.quantize_blocks([2], bits=8)
    dst = TPool(tcfg(), 8, BS, device="cpu")
    bridge.copy_pool_state(jp, dst)
    _assert_same_state(jp, dst)
    assert dst.kv_quant_bundle() is not None
    with pytest.raises(ValueError, match="pool shapes differ"):
        bridge.copy_pool_state(jp, TPool(tcfg(), 20, BS, device="cpu"))


# ---------------------------------------------------------------------------
# the kv_quant lane of the plain kernel versions
# ---------------------------------------------------------------------------
def _quantize_subset(kp, vp, qids, bits):
    """Quantize pool blocks ``qids`` as ``PagedKVPool.quantize_blocks``
    does, through the JAX package's codec: int8 mirrors, one (scale, zero)
    per block, fp slots zeroed; other blocks keep zero sidecar rows.
    Returns (k_fp, v_fp, bundle) as numpy arrays."""
    out = []
    for p in (kp, vp):
        q, s, z = j_codec.affine_quantize_np(p[None], bits=bits)
        qm = np.zeros(p.shape, np.int8)
        sc = np.zeros(p.shape[0], np.float32)
        zp = np.zeros(p.shape[0], np.float32)
        fp = p.copy()
        for b in qids:
            qm[b], sc[b], zp[b], fp[b] = q[0, b], s[0, b], z[0, b], 0.0
        out.append((fp, qm, sc, zp))
    (kf, qk, ks, kz), (vf, qv, vs, vz) = out
    return kf, vf, (qk, qv, ks, vs, kz, vz)


def _pools(rng, lens, KVH, Dh, bs, nb):
    """Random pools and tables whose live ids are globally distinct (the
    engine's ownership contract); padding entries are scratch 0."""
    need = [-(-int(n) // bs) for n in lens]
    cap = sum(need) + 2
    kp = rng.standard_normal((cap, bs, KVH, Dh)).astype(np.float32)
    vp = rng.standard_normal((cap, bs, KVH, Dh)).astype(np.float32)
    perm = rng.permutation(np.arange(1, cap))
    tables = np.zeros((len(lens), nb), np.int32)
    o = 0
    for b, n in enumerate(need):
        tables[b, :n] = perm[o:o + n]
        o += n
    return kp, vp, tables


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _decode_case(seed, H, KVH, bits, bs=8, nb=4, Dh=32):
    """Three ragged sequences; every block but the one holding a sequence's
    newest position is quantized (the engine's keep-tail rule)."""
    rng = np.random.default_rng(seed)
    lens = np.array([nb * bs - 1, nb * bs - 9, 11], np.int32)
    kp, vp, tables = _pools(rng, lens + 1, KVH, Dh, bs, nb)
    tail = {int(tables[b, n // bs]) for b, n in enumerate(lens)} | {
        int(tables[b, (n - 1) // bs]) for b, n in enumerate(lens)}
    qids = sorted(set(range(1, kp.shape[0])) - tail)
    kf, vf, kvq = _quantize_subset(kp, vp, qids, bits)
    q = rng.standard_normal((3, H, Dh)).astype(np.float32)
    kn = rng.standard_normal((3, KVH, Dh)).astype(np.float32)
    vn = rng.standard_normal((3, KVH, Dh)).astype(np.float32)
    return q, kn, vn, kf, vf, tables, lens, kvq


VARIANTS = [dict(H=4, KVH=4, window=0, softcap=0.0, scale=None),
            dict(H=4, KVH=2, window=9, softcap=20.0, scale=0.3)]


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("var", [0, 1])
def test_plain_decode_kv_quant_matches_jax(bits, fused, var):
    """The plain decode with a bundle against the JAX Pallas decode kernel
    in interpret mode (in-kernel FMA) and against the explicit-dequant
    oracle (``_dequant_pools`` + the gather), for MHA and GQA with window,
    softcap and an explicit scale."""
    v = VARIANTS[var]
    q, kn, vn, kf, vf, tables, lens, kvq = _decode_case(
        31 * bits + 7 * var + fused, v["H"], v["KVH"], bits)
    spec = ops.AttentionSpec(window=v["window"], softcap=v["softcap"],
                             scale=v["scale"], kv_quant=True)
    kw = dict(window=v["window"], softcap=v["softcap"], scale=v["scale"],
              interpret=True, kv_quant=tuple(map(jnp.asarray, kvq)))
    tq, tkn, tvn, tkf, tvf, ttab, tlens = _t(q, kn, vn, kf, vf, tables, lens)
    tkvq = tuple(_t(*kvq))
    if fused:
        got = ops.paged_decode_attention(tq, tkn, tvn, tkf, tvf, ttab, tlens,
                                         spec, kv_quant=tkvq)
        want = jpa.paged_attention_fused(q, kn, vn, kf, vf, tables, lens,
                                         **kw)
    else:
        got = ops.paged_attention(tq, tkf, tvf, ttab, tlens, spec,
                                  kv_quant=tkvq)
        want = jpa.paged_attention(q, kf, vf, tables, lens, **kw)
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)
    if v["scale"] is None:        # the gather oracle has no scale argument
        dk, dv = jpa._dequant_pools(kf, vf, kvq)
        dk, dv = np.array(dk), np.array(dv)
        pos = lens if fused else lens - 1
        if fused:                  # the caller's append, for the gather
            for b, n in enumerate(lens):
                dk[tables[b, n // 8], n % 8] = kn[b]
                dv[tables[b, n // 8], n % 8] = vn[b]
        oracle = jpa.paged_gather_attention(q, dk, dv, tables, pos,
                                            window=v["window"],
                                            softcap=v["softcap"])
        np.testing.assert_allclose(to_np(got), np.asarray(oracle), **TOL)
    # the bundle really changed what was read
    plain = ops.paged_attention(tq, tkf, tvf, ttab, tlens, spec)
    assert not torch.allclose(plain, got, atol=1e-3)


def _chunk_case(seed, C, H, KVH, pos0, bits, bs=8, Dh=32):
    """One sequence; the chunk's KV is scattered at ``pos0``; every
    context block wholly below the chunk is quantized."""
    rng = np.random.default_rng(seed)
    nb = 1 << (-(-(pos0 + C) // bs) - 1).bit_length()
    kp, vp, tables = _pools(rng, [pos0 + C], KVH, Dh, bs, nb)
    q = rng.standard_normal((1, C, H, Dh)).astype(np.float32)
    kn = rng.standard_normal((1, C, KVH, Dh)).astype(np.float32)
    vn = rng.standard_normal((1, C, KVH, Dh)).astype(np.float32)
    pos = pos0 + np.arange(C)
    kp[tables[0, pos // bs], pos % bs] = kn[0]
    vp[tables[0, pos // bs], pos % bs] = vn[0]
    qids = [int(b) for b in tables[0, :pos0 // bs]]
    kf, vf, kvq = _quantize_subset(kp, vp, qids, bits)
    return q, kn, vn, kf, vf, tables, kvq


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("var", [0, 1])
def test_plain_chunk_kv_quant_matches_jax(bits, fused, var):
    """The plain chunk prefill with a bundle against the JAX Pallas chunk
    kernel in interpret mode and against the explicit-dequant gather
    oracle, at an unaligned offset; the chunk's own KV stays fp."""
    v = VARIANTS[var]
    pos0 = 21
    q, kn, vn, kf, vf, tables, kvq = _chunk_case(
        17 * bits + 5 * var + fused, 8, v["H"], v["KVH"], pos0, bits)
    spec = ops.AttentionSpec(window=v["window"], softcap=v["softcap"],
                             scale=v["scale"], kv_quant=True)
    kw = dict(window=v["window"], softcap=v["softcap"], scale=v["scale"],
              interpret=True, kv_quant=tuple(map(jnp.asarray, kvq)))
    if fused:
        want = jpa.paged_chunk_attention_fused(q, kn, vn, kf, vf, tables,
                                               pos0, **kw)
    else:
        want = jpa.paged_chunk_attention(q, kf, vf, tables, pos0, **kw)
    tq, tkn, tvn, tkf, tvf, ttab = _t(q, kn, vn, kf, vf, tables)
    got = ops.paged_prefill_attention(
        tq, tkf, tvf, ttab, pos0, spec, k_new=tkn if fused else None,
        v_new=tvn if fused else None, kv_quant=tuple(_t(*kvq)))
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)
    oracle = jpa.paged_chunk_gather_attention(
        q, kf, vf, tables, pos0, window=v["window"], softcap=v["softcap"],
        scale=v["scale"], kv_quant=tuple(map(jnp.asarray, kvq)))
    np.testing.assert_allclose(to_np(got), np.asarray(oracle), **TOL)


@pytest.mark.parametrize("route", ["decode", "chunk"])
def test_noop_bundle_is_exact(route):
    """An all-fp pool with a zeroed sidecar gives exactly the no-bundle
    result: the FMA is exact when scale == zero == 0."""
    if route == "decode":
        q, kn, vn, kf, vf, tables, lens, kvq = _decode_case(3, 4, 2, 8)
    else:
        q, kn, vn, kf, vf, tables, kvq = _chunk_case(3, 8, 4, 2, 21, 8)
    zero = tuple(np.zeros_like(a) for a in kvq)
    tq, tkn, tvn, tkf, tvf, ttab = _t(q, kn, vn, kf, vf, tables)
    spec = ops.AttentionSpec(kv_quant=True)
    if route == "decode":
        tl = torch.from_numpy(lens)
        a = ops.paged_decode_attention(tq, tkn, tvn, tkf, tvf, ttab, tl)
        b = ops.paged_decode_attention(tq, tkn, tvn, tkf, tvf, ttab, tl,
                                       spec, kv_quant=tuple(_t(*zero)))
    else:
        a = ops.paged_prefill_attention(tq, tkf, tvf, ttab, 21, k_new=tkn,
                                        v_new=tvn)
        b = ops.paged_prefill_attention(tq, tkf, tvf, ttab, 21, spec,
                                        k_new=tkn, v_new=tvn,
                                        kv_quant=tuple(_t(*zero)))
    assert torch.equal(a, b)


@pytest.mark.parametrize("route", ["context", "decode", "chunk"])
def test_routes_refuse_a_bundle_without_kv_quant(route):
    """A bundle reaching a layer whose spec was built with the tier off
    raises on every attention route (on the CPU as on the card); with
    ``kv_quant=True`` the same call runs."""
    q, kn, vn, kf, vf, tables, lens, kvq = _decode_case(7, 4, 2, 8)
    tq, tkn, tvn, tkf, tvf, ttab, tl = _t(q, kn, vn, kf, vf, tables, lens)
    bundle = tuple(_t(*kvq))
    calls = {
        "context": lambda sp: ops.paged_attention(
            tq, tkf, tvf, ttab, tl, sp, kv_quant=bundle),
        "decode": lambda sp: ops.paged_decode_attention(
            tq, tkn, tvn, tkf, tvf, ttab, tl, sp, kv_quant=bundle),
        "chunk": lambda sp: ops.paged_prefill_attention(
            tq[:1, None], tkf, tvf, ttab[:1], 5, sp, k_new=tkn[:1, None],
            v_new=tvn[:1, None], kv_quant=bundle)}
    for spec in (None, ops.AttentionSpec(window=4)):
        with pytest.raises(ValueError, match="kv_quant=False"):
            calls[route](spec)
    assert torch.isfinite(calls[route](ops.AttentionSpec(kv_quant=True))).all()


def test_wrappers_check_the_bundle():
    """The CUDA wrappers check the six sidecar operands before launching
    (dtype, shape, contiguity) and raise on a CPU tensor."""
    q, kn, vn, kf, vf, tables, lens, kvq = _decode_case(5, 4, 2, 8)
    tq, tkn, tvn, tkf, tvf, ttab, tl = _t(q, kn, vn, kf, vf, tables, lens)
    good = list(_t(*kvq))
    kw = dict(scale=1.0, fused_new=True)
    for i, bad, msg in [(0, good[0].float(), "qk must be torch.int8"),
                        (3, good[3][:-1], "v_scale must be torch.float32"),
                        (1, good[1].transpose(1, 2), "qv must be torch.int8")]:
        kvq_bad = list(good)
        kvq_bad[i] = bad
        with pytest.raises(ValueError, match=msg):
            paged_decode(tq, tkn, tvn, tkf, tvf, ttab, tl,
                         kv_quant=tuple(kvq_bad), **kw)
    qt = torch.zeros(good[0].shape, dtype=torch.int8).transpose(
        0, 1).contiguous().transpose(0, 1)
    with pytest.raises(ValueError, match="qk must be contiguous"):
        paged_decode(tq, tkn, tvn, tkf, tvf, ttab, tl,
                     kv_quant=(qt,) + tuple(good[1:]), **kw)
    with pytest.raises(ValueError, match="kv_quant is"):
        paged_decode(tq, tkn, tvn, tkf, tvf, ttab, tl,
                     kv_quant=tuple(good[:5]), **kw)
    with pytest.raises(ValueError, match="CUDA tensor"):
        paged_decode(tq, tkn, tvn, tkf, tvf, ttab, tl, kv_quant=tuple(good),
                     **kw)
    with pytest.raises(ValueError, match="CUDA tensor"):
        paged_chunk(tq[None], None, None, tkf, tvf, ttab[:1], 0, scale=1.0,
                    fused_new=False, kv_quant=tuple(good))


# ---------------------------------------------------------------------------
# ModelExec steps over a partly quantized pool
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("bits", [8, 4])
def test_model_exec_steps_with_bundle_match_jax(bits):
    """A batched prefill, then half of the written blocks quantized in
    both pools, then one decode step and one chunk step with the pools'
    bundles (int4 layers at level 2 through the wNa16 plain version):
    logits and the in-place pool updates equal the JAX ModelExec's."""
    params, _, tparams = llama_params()
    plan = j_build_plan(jcfg(), params, ORDER, bits=4, use_kernel=True)
    jll = plan.layer_list(2)
    tll = [(k, bridge.to_torch(jax.tree.map(np.asarray, lp), "cpu"))
           for k, lp in jll]
    jx = JExec(jcfg(), params, jlm.layer_kinds(jcfg()), kv_quant=True)
    tx = TExec(tcfg(), tparams, tlm.layer_kinds(tcfg()), kv_quant=True)
    assert all(s.kv_quant for s in tx.specs)
    assert not any(s.kv_quant for s in TExec(
        tcfg(), tparams, tlm.layer_kinds(tcfg())).specs)
    jp, tp = JPool(jcfg(), 12, BS), TPool(tcfg(), 12, BS, device="cpu")
    rng = np.random.default_rng(bits)
    toks = rng.integers(0, 512, (2, 48)).astype(np.int32)
    tables = np.array([[1, 2, 3], [4, 5, 6]], np.int32)
    lens = np.array([45, 38], np.int32)
    jl, jp.k, jp.v = jx.prefill_batch(jll, jnp.asarray(toks), jp.k, jp.v,
                                      jnp.asarray(tables), jnp.asarray(lens))
    tl = tx.prefill_batch(tll, torch.from_numpy(toks), tp.k, tp.v,
                          torch.from_numpy(tables), torch.from_numpy(lens))
    np.testing.assert_allclose(to_np(tl), np.asarray(jl), **STEP_TOL)
    np.testing.assert_allclose(to_np(tp.k), np.asarray(jp.k), **STEP_TOL)
    # quantize the cold blocks (never a tail) in both pools, then start the
    # steps from one state: the JAX pool's, carried across exactly
    tp.quantize_blocks([1, 4], bits=bits)
    jp.quantize_blocks([1, 4], bits=bits)
    np.testing.assert_allclose(to_np(tp.k_zero), np.asarray(jp.k_zero),
                               **STEP_TOL)
    bridge.copy_pool_state(jp, tp)

    tokens = np.array([[7], [9], [0], [0]], np.int32)
    pos = np.array([45, 38, 0, 0], np.int32)
    dtab = np.array([[1, 2, 3, 0], [4, 5, 6, 0], [0] * 4, [0] * 4], np.int32)
    z = (jnp.zeros((0,), jnp.float32), jnp.zeros((0,), jnp.float32))
    jl, jp.k, jp.v, _, _ = jx.decode(
        jll, jnp.asarray(tokens), jnp.asarray(pos), jp.k, jp.v,
        jnp.asarray(dtab), *z, jp.kv_quant_bundle())
    tl = tx.decode(tll, torch.from_numpy(tokens), torch.from_numpy(pos),
                   tp.k, tp.v, torch.from_numpy(dtab),
                   kvq=tp.kv_quant_bundle())
    np.testing.assert_allclose(to_np(tl)[:2], np.asarray(jl)[:2], **STEP_TOL)
    live = [1, 2, 3, 4, 5, 6]
    np.testing.assert_allclose(to_np(tp.k)[:, live],
                               np.asarray(jp.k)[:, live], **STEP_TOL)

    chunk = np.zeros((1, 16), np.int32)
    chunk[0, :10] = rng.integers(0, 512, 10)
    ctab = np.array([1, 2, 3, 7], np.int32)
    jl, jp.k, jp.v = jx.prefill_chunk(jll, jnp.asarray(chunk), jnp.int32(46),
                                      jp.k, jp.v, jnp.asarray(ctab),
                                      jp.kv_quant_bundle())
    tl = tx.prefill_chunk(tll, torch.from_numpy(chunk), 46, tp.k, tp.v,
                          torch.from_numpy(ctab), tp.kv_quant_bundle())
    np.testing.assert_allclose(to_np(tl)[:10], np.asarray(jl)[:10],
                               **STEP_TOL)
    np.testing.assert_allclose(to_np(tp.v)[:, live + [7]],
                               np.asarray(jp.v)[:, live + [7]], **STEP_TOL)
    # the bundle was read: without it the chunk's logits move
    tl0 = tx.prefill_chunk(tll, torch.from_numpy(chunk), 46, tp.k.clone(),
                           tp.v.clone(), torch.from_numpy(ctab))
    assert not torch.allclose(tl0[:10], tl[:10], atol=1e-3)


# ---------------------------------------------------------------------------
# the serving engine with the tier on
# ---------------------------------------------------------------------------
def _ecfg(EC, KQ, HW, mode, **kw):
    return EC(policy="morph", compute="real", use_quant_kernel=True,
              max_tokens_per_step=32, seed=10, prefix_caching=True,
              hw=HW("slow", 1e9, 1e7, 2**30),
              kv_quant=KQ(enabled=True, batch_blocks=1,
                          cross_level_mode=mode), **kw)


def _morph_to(eng, level):
    """Land a swap to ``level`` at once (manual level control)."""
    eng.actuator.issue(level, eng.now)
    eng.actuator.poll(eng.now + 1e9)
    eng.controller.commit(level)
    eng.ledger.set_weights(eng.actuator.weight_bytes())


def _serve_two_phases(eng, TR, seed=31, pl=32):
    """Phase 1: four short prompts with long generations in a burst; their
    decode-grown blocks fill the pool, so the tier quantizes cold blocks
    and the ladder swaps and resizes. No prompt has a full block, so
    nothing is published to the prefix cache. Phase 2: a 32-token prefix
    is published at the level the engine is at, the level is moved to 2,
    and two requests hit the prefix across levels (adopt or requantize).
    Returns the four runs' reports. Trace seed 31: every argmax of the
    port's run wins by > 3e-3 in both modes (seeds 10-39 were tried; most
    have a gap under ``MIN_GAP`` somewhere in their ~200 decisions)."""
    rng = np.random.default_rng(seed)
    pre = [int(x) for x in rng.integers(0, 512, pl)]

    def body(n):
        return [int(x) for x in rng.integers(0, 512, n)]
    spec = [(t, body(15), g) for t, g in
            zip((0.0, 0.01, 0.02, 0.03), (40, 40, 48, 40))]
    reports = [eng.run_trace([TR(t, len(p), g, tuple(p))
                              for t, p, g in spec]),
               eng.run_trace([TR(eng.now, pl + 9, 6, tuple(pre + body(9)))])]
    _morph_to(eng, 2)
    for n in (13, 5):
        reports.append(eng.run_trace(
            [TR(eng.now, pl + n, 8, tuple(pre + body(n)))]))
    return reports


@pytest.mark.parametrize("mode", ["adopt", "requant"])
def test_real_engine_kv_quant_matches_jax(mode):
    """Real compute with the tier on: the token streams, the quantize /
    dequantize events, the swap and resize logs, the prefix cache's
    cross-level counters and the report equal the JAX engine's. The trace
    quantizes cold blocks under pressure (so decode and chunk steps run
    over quantized blocks), dequantizes them on calm, swaps and resizes,
    and hits a published prefix across swap levels."""
    params, _, tparams = llama_params()
    je = JEngine(jcfg(), params, serving(params, JSC),
                 _ecfg(JEC, JKQ, JHW, mode), swap_order=ORDER)
    te = TEngine(tcfg(), tparams, serving(params, TSC),
                 _ecfg(TEC, TKQ, THW, mode), swap_order=ORDER, device="cpu")
    gaps = record_gaps(te)
    rj = _serve_two_phases(je, JTR)
    rt = _serve_two_phases(te, TTR)
    assert min(gaps) > MIN_GAP, f"near-tie in the trace: {min(gaps)}"
    assert [r.generated for r in je.all_requests] == \
        [r.generated for r in te.all_requests]
    assert all(r.state.value == "finished" for r in te.all_requests)
    assert je.kv_quant_events == te.kv_quant_events
    assert je.actuator.swap_log == te.actuator.swap_log
    assert je.resize_log == te.resize_log
    kinds = collections.Counter(k for _, k, _ in te.kv_quant_events)
    assert kinds["quantize"] > 0 and kinds["dequantize"] > 0
    assert len(te.actuator.swap_log) > 1 and len(te.resize_log) > 0
    jc, tc = je.prefix_cache, te.prefix_cache
    assert (jc.cross_level_hits, jc.requant_hits) == \
        (tc.cross_level_hits, tc.requant_hits)
    assert tc.cross_level_hits > 0
    assert (tc.requant_hits > 0) == (mode == "requant")
    assert je.ledger.kv_quant_blocks == te.ledger.kv_quant_blocks
    assert not te.watchdog_trips
    assert [dataclasses.asdict(r) for r in rj] == \
        [dataclasses.asdict(r) for r in rt]


def _eviction_trace(TR):
    """A shared prefix under pressure: quantized blocks are published to
    the prefix cache and later evicted by its tier-0 relief."""
    rng = np.random.default_rng(10)
    pre = [int(x) for x in rng.integers(0, 512, 32)]

    def body(n):
        return [int(x) for x in rng.integers(0, 512, n)]
    spec = [(0.0, pre + body(20), 8), (0.01, body(56), 8),
            (0.02, body(60), 10), (0.03, pre + body(16), 8),
            (0.3, pre + body(18), 8), (0.35, pre + body(10), 7)]
    return [TR(t, len(p), g, tuple(p)) for t, p, g in spec]


def _stale_allocations(eng):
    """Record each block the engine's allocator hands out while the pool
    still holds it quantized, with whether its k scale row is nonzero
    there (a stale payload the kernels' FMA would add)."""
    stale, alloc = [], eng.pool.alloc.alloc

    def run(n):
        got = alloc(n)
        for b in got or []:
            if b in eng.pool.qbits:
                stale.append((b, bool(np.asarray(eng.pool.k_scale[:, b])
                                      .any())))
        return got
    eng.pool.alloc.alloc = run
    return stale


def test_no_kv_write_lands_in_a_quantized_block():
    """Every KV write of the engine (whole-prompt prefill, chunk, decode
    append) lands in a block that is not held quantized, so the kernels'
    FMA never adds a stale payload to fresh KV. The trace takes the path
    where the JAX engine hands a quantized block out again without
    clearing it (``test_jax_engine_reallocates_a_quantized_block``); the
    port's allocator never does."""
    params, _, tparams = llama_params()
    te = TEngine(tcfg(), tparams, serving(params, TSC),
                 _ecfg(TEC, TKQ, THW, "requant"), swap_order=ORDER,
                 device="cpu")
    writes, evicted_quantized = [], []
    ex, pool = te.exec, te.pool
    stale = _stale_allocations(te)

    def check(name, blocks):
        held = [int(b) for b in blocks if int(b) in te.pool.qbits]
        writes.append(len(blocks))
        assert not held, f"{name} writes into quantized blocks {held}"

    def wrap(name, fn, blocks_of):
        def run(*a, **kw):
            check(name, blocks_of(*a))
            return fn(*a, **kw)
        setattr(ex, name, run)

    bs = pool.block_size
    wrap("decode", ex.decode,
         lambda ll, tok, pos, k, v, tab, *r: tab.long().gather(
             1, (pos.long() // bs)[:, None])[:, 0].tolist())
    wrap("prefill_chunk", ex.prefill_chunk,
         lambda ll, tok, p0, k, v, tab, *r: tab.long()[
             (p0 + torch.arange(tok.shape[1])) // bs].tolist())
    wrap("prefill", ex.prefill, lambda ll, tok, k, v, ids, *r: ids.tolist())
    wrap("prefill_batch", ex.prefill_batch,
         lambda ll, tok, k, v, tab, *r: tab.flatten().tolist())
    evict = te.prefix_cache.evict_lru

    def evict_lru(n):
        out = evict(n)
        evicted_quantized.extend(b for b in out if b in te.pool.qbits)
        return out
    te.prefix_cache.evict_lru = evict_lru

    rep = te.run_trace(_eviction_trace(TTR))
    assert rep.n_finished == rep.n_requests == 6
    assert evicted_quantized, "the trace never evicted a quantized block"
    assert not stale, f"allocated while held quantized: {stale}"
    assert sum(writes) > 0 and te.kv_quant_events
    assert te.ledger.kv_quant_blocks == len(te.pool.qbits)


def test_jax_engine_reallocates_a_quantized_block():
    """The reference side of the port's deliberate difference: on the same
    trace the JAX engine's tier-0 prefix-cache eviction releases quantized
    blocks without ``clear_quant``, so its allocator hands out a block
    still listed in ``qbits`` with a nonzero scale row."""
    params, _, _ = llama_params()
    je = JEngine(jcfg(), params, serving(params, JSC),
                 _ecfg(JEC, JKQ, JHW, "requant"), swap_order=ORDER)
    stale = _stale_allocations(je)
    je.run_trace(_eviction_trace(JTR))
    assert any(nonzero for _, nonzero in stale), stale


def test_sim_engine_kv_quant_matches_jax():
    """Sim compute with the tier on, at chip_smoke.py's kv-quant engine
    phase: Llama-2-7B width cut to 8 layers, a budget of the weights plus
    16 float32 KV blocks, the H100 cost profile and the quickstart trace.
    The tier engages (the trace quantizes cold blocks) and the report, the
    quantize events and the morph logs equal the JAX engine's."""
    from repro.configs import MORPH_LLAMA2_7B as J_LLAMA
    from repro.core.swap_plan import build_sim_swap_plan
    from repro.engine.kv_cache import kv_block_bytes
    from repro.engine.traces import azure_like as j_azure
    from repro_torch.configs import MORPH_LLAMA2_7B as T_LLAMA
    from repro_torch.engine import NVIDIA_H100_SXM
    from repro_torch.engine.traces import azure_like as t_azure
    jc, tc = J_LLAMA.replace(n_layers=8), T_LLAMA.replace(n_layers=8)
    order = list(range(8))
    wb = (build_sim_swap_plan(jc, order, bits=4).weight_bytes(0)
          + 2 * jc.vocab * jc.d_model * 2)
    bb = kv_block_bytes(jc, 16, 4)
    sc = dict(hbm_budget_bytes=int((wb + 16 * bb) / 0.95) + 2 * bb,
              kv_block_size=16, max_batch_slots=8, max_seq_len=1024,
              swap_levels=(0, 1, 2, 4), mode="performance",
              kv_resize_step_frac=0.25)
    h100 = NVIDIA_H100_SXM
    ec = dict(policy="morph", compute="sim")
    je = JEngine(jc, None, JSC(**sc),
                 JEC(hw=JHW(h100.name, h100.flops, h100.hbm_bw,
                            h100.hbm_bytes),
                     kv_quant=JKQ(enabled=True), **ec), swap_order=order)
    te = TEngine(tc, None, TSC(**sc),
                 TEC(hw=h100, kv_quant=TKQ(enabled=True), **ec),
                 swap_order=order, device="cpu")
    kw = dict(duration_s=4.0, base_rps=2.0, seed=3, prompt_mean=160,
              gen_mean=24, prompt_max=512, gen_max=48)
    rj, rt = je.run_trace(j_azure(**kw)), te.run_trace(t_azure(**kw))
    assert dataclasses.asdict(rj) == dataclasses.asdict(rt)
    assert je.kv_quant_events == te.kv_quant_events
    assert any(k == "quantize" for _, k, _ in te.kv_quant_events)
    assert je.actuator.swap_log == te.actuator.swap_log
    assert je.resize_log == te.resize_log
    assert rt.n_finished == rt.n_requests
    assert not te.watchdog_trips


@pytest.mark.cuda
def test_cuda_kv_quant_lane_matches_plain():
    """K2-q and K3-q against their plain versions on the card (small
    shapes; chip_smoke.py runs the main path's), and a zeroed bundle
    exactly equal to the no-bundle kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode")
    def cuda(case):
        *arrays, kvq = case
        return ([t.cuda() for t in _t(*arrays)],
                tuple(t.cuda() for t in _t(*kvq)))

    for bits in (8, 4):
        (q, kn, vn, kf, vf, tables, lens), kvq = cuda(
            _decode_case(5, 4, 2, bits))
        for fused in (True, False):
            kw = dict(scale=0.2, window=7, softcap=20.0, fused_new=fused,
                      kv_quant=kvq)
            a = paged_decode(q, kn if fused else None, vn if fused else None,
                             kf, vf, tables, lens, **kw)
            b = ref.paged_decode_ref(q, kn, vn, kf, vf, tables, lens, **kw)
            torch.testing.assert_close(a, b, **TOL)
        zero = tuple(torch.zeros_like(t) for t in kvq)
        kw = dict(scale=0.2, window=7, softcap=20.0, fused_new=True)
        assert torch.equal(
            paged_decode(q, kn, vn, kf, vf, tables, lens, **kw),
            paged_decode(q, kn, vn, kf, vf, tables, lens, kv_quant=zero,
                         **kw))
        (q, kn, vn, kf, vf, tables), kvq = cuda(
            _chunk_case(6, 16, 4, 2, 21, bits))
        for fused in (True, False):
            kw = dict(scale=0.2, window=9, softcap=20.0, fused_new=fused,
                      kv_quant=kvq)
            a = paged_chunk(q, kn if fused else None, vn if fused else None,
                            kf, vf, tables, 21, **kw)
            b = ref.paged_chunk_ref(q, kn, vn, kf, vf, tables, 21, **kw)
            torch.testing.assert_close(a, b, **TOL)
