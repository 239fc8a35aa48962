"""The port's quantization (pack, QTensor, quantize_tree, AWQ, plain wNa16)
held against the JAX package on the same numpy inputs.

Tolerances: packed bytes must be equal; scales and zeros within 1 ulp
(``(hi - lo) / qmax`` and the divisions may round differently in XLA and
torch). Float32 matmuls are reduced in a different order by torch and XLA,
so products agree to ~1e-6 relative, not bit for bit: 2e-5 (the JAX
package's own kernel tolerance) is used.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import jcfg, llama_params, to_np

from repro.kernels import ops as jops
from repro.models import lm as jlm
from repro.quant import awq as jawq
from repro.quant import qlinear as jql
from repro.core import kv_codec as j_codec
from repro_torch import bridge
from repro_torch.core import kv_codec
from repro_torch.kernels import ops
from repro_torch.quant import awq, pack, qlinear


def _w(seed, K, N, scale=0.05):
    return (np.random.default_rng(seed).standard_normal((K, N)) * scale
            ).astype(np.float32)


def _assert_qt_equal(jq, tq):
    assert (jq.bits, jq.group, jq.K, jq.N) == (tq.bits, tq.group, tq.K,
                                                tq.N)
    jp = np.asarray(jq.packed)
    if jq.bits == 3:
        jp = jp.view(np.int32)
    np.testing.assert_array_equal(jp, to_np(tq.packed))
    np.testing.assert_array_max_ulp(np.asarray(jq.scales), to_np(tq.scales),
                                    maxulp=1)
    np.testing.assert_array_max_ulp(np.asarray(jq.zeros), to_np(tq.zeros),
                                    maxulp=1)


@pytest.mark.parametrize("bits", [4, 8, 3])
@pytest.mark.parametrize("K,N,group", [(256, 128, 64), (192, 64, 128),
                                       (96, 40, 128)])
def test_quantize_tensor_matches_jax(bits, K, N, group):
    """Same packed bytes, scales, zeros and (halved) group as the JAX
    package, and the same dequantized weight."""
    w = _w(K * N + bits, K, N)
    jq = jql.quantize_tensor(jnp.asarray(w), bits=bits, group=group)
    tq = qlinear.quantize_tensor(torch.from_numpy(w), bits=bits, group=group)
    _assert_qt_equal(jq, tq)
    np.testing.assert_allclose(np.asarray(jq.dequantize(jnp.float32)),
                               to_np(tq.dequantize(torch.float32)),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("bits", [4, 8, 3])
def test_pack_unpack_roundtrip(bits):
    q = torch.from_numpy(np.random.default_rng(bits).integers(
        0, 2 ** bits, (64, 24)).astype(np.uint8))
    packed = pack.pack(q, bits)
    assert torch.equal(pack.unpack(packed, bits, 64), q)
    assert packed.numel() * packed.element_size() + 2 * 2 * 24 * 4 == \
        pack.packed_nbytes(64, 24, bits, 32)


def test_quantize_tree_leaves_match_jax():
    """A Llama layer's param tree: the same leaves are quantized, with the
    same bytes; norms stay dense and shared."""
    params, np_params, tparams = llama_params()
    jlayer = jlm.params_to_layer_list(jcfg(), params)[1][1]
    from repro_torch.models import lm as tlm
    from torch_parity import tcfg
    tlayer = tlm.params_to_layer_list(tcfg(), tparams)[1][1]
    jq = jawq.quantize_tree(jlayer, bits=4, group=128, min_size=1 << 12)
    tq = awq.quantize_tree(tlayer, bits=4, group=128, min_size=1 << 12)
    for sub in ("attn", "mlp"):
        for k in jq[sub]:
            assert jql.is_quantized(jq[sub][k]) == qlinear.is_quantized(
                tq[sub][k]), (sub, k)
            if jql.is_quantized(jq[sub][k]):
                _assert_qt_equal(jq[sub][k], tq[sub][k])
    assert tq["ln1"]["scale"] is tlayer["ln1"]["scale"]


def test_awq_search_matches_jax():
    """The AWQ alpha grid search sees the same errors and picks the same
    alpha whenever its best two candidates are apart."""
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((64, 128)) * np.linspace(0.1, 4, 128)
         ).astype(np.float32)
    w = _w(8, 128, 64)
    js, ja, jerrs = jawq.search_awq_scale(jnp.asarray(x), jnp.asarray(w),
                                          bits=4, group=64)
    ts, ta, terrs = awq.search_awq_scale(torch.from_numpy(x),
                                         torch.from_numpy(w), bits=4,
                                         group=64)
    np.testing.assert_allclose(jerrs, terrs, rtol=1e-4)
    best2 = sorted(jerrs)[:2]
    if best2[1] - best2[0] > 1e-3 * best2[0]:
        assert ja == ta
    if js is not None and ja == ta:
        np.testing.assert_allclose(np.asarray(js), to_np(ts), rtol=1e-5)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("awq_scale,with_bias", [(False, False),
                                                  (True, True)])
def test_plain_wna16_matches_jax(bits, awq_scale, with_bias):
    """Plain wNa16 (the CPU lane of ops.wna16_matmul) against the JAX xla
    lane and the JAX Pallas kernel in interpret mode, with the AWQ
    inv_act and bias epilogue."""
    rng = np.random.default_rng(bits * 10 + awq_scale)
    M, K, N = 5, 256, 128
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = _w(3, K, N)
    s = (rng.uniform(0.5, 2.0, K).astype(np.float32) if awq_scale else None)
    b = rng.standard_normal(N).astype(np.float32) if with_bias else None
    jq = jql.quantize_tensor(jnp.asarray(w), bits=bits, group=64,
                             act_scale=None if s is None else jnp.asarray(s))
    tq = bridge.to_torch(jq, "cpu")
    got = ops.wna16_matmul(torch.from_numpy(x), tq,
                           bias=None if b is None else torch.from_numpy(b))
    for mode in ("xla", "pallas_interpret"):
        prev = jops.set_quant_kernel_mode(mode)
        try:
            want = jops.wna16_matmul(jnp.asarray(x), jq,
                                     bias=None if b is None
                                     else jnp.asarray(b))
        finally:
            jops.set_quant_kernel_mode(prev)
        np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=2e-5,
                                   atol=2e-5)


def test_qlinear_matmul_routes_flagged_weights_to_wna16():
    """A kernel-flagged QTensor goes through ops.wna16_matmul (the plain
    version on a CPU tensor) and equals the dequantize-then-matmul path."""
    w = torch.from_numpy(_w(5, 128, 64))
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 3, 128)).astype(np.float32))
    qt = qlinear.quantize_tensor(w, bits=4, group=32)
    a = qlinear.matmul(x, qt.with_use_kernel(True))
    b = qlinear.matmul(x, qt)
    assert a.shape == (2, 3, 64)
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bits", [8, 4])
def test_kv_codec_torch_twin_matches_jax(bits):
    """The KV codec's torch twin against the JAX package's numpy and jnp
    codecs on the same (L, n, bs, KVH, Dh) blocks."""
    x = np.random.default_rng(bits).standard_normal((2, 3, 4, 2, 8)).astype(
        np.float32)
    q, s, z = kv_codec.affine_quantize_torch(torch.from_numpy(x), bits)
    qn, sn, zn = j_codec.affine_quantize_np(x, bits)
    qj, _, _ = j_codec.affine_quantize_jnp(jnp.asarray(x), bits)
    np.testing.assert_array_equal(to_np(q), qn)
    np.testing.assert_array_equal(to_np(q), np.asarray(qj))
    np.testing.assert_array_max_ulp(to_np(s), sn, maxulp=1)
    np.testing.assert_array_max_ulp(to_np(z), zn, maxulp=1)
    np.testing.assert_allclose(
        to_np(kv_codec.affine_dequantize_torch(q, s, z)),
        j_codec.affine_dequantize_np(qn, sn, zn), rtol=1e-6, atol=1e-6)
