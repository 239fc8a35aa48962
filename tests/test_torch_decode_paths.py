"""The port's model API off the serving engine against the JAX package:
the contiguous-cache decode of every layer kind, the long-prompt
attention paths, and the registry.

- ``gqa_decode`` (self-attention with a window and a softcap, and
  cross-attention over given k/v), ``mla_decode`` (absorbed and expanded,
  with a dense and an int4 ``w_ukv``) and ``gqa_apply`` with ``cross_kv``
  and ``causal=False``, on reduced layers;
- ``lm.init_cache`` + ``lm.decode_step`` for twenty tokens from a JAX
  cache carried across by the bridge, for every family's reduced config
  (float32, d 128, vocab 512, 4 layers): the dense configs (Llama-2,
  OLMo's non-parametric LN, Qwen2's QKV bias and tied head, Nemotron's
  squared ReLU and partial rope, Command R+'s parallel block),
  ``mla_dense`` + ``mla_moe`` (DeepSeek-V3), ``dense`` + ``moe``
  (Maverick), ``mamba``, ``hybrid`` (a window of 16 but on layer 0, so
  the steps pass it) and the VLM's text decode; ``decode_step_unrolled``
  with layer 0 int4 (the JAX ``quantize_tree``, kernel-flagged: the JAX
  side runs its xla lane, the port K1's plain version);
- ``plain=`` handed to every call of K1's route by each entry of the
  model API, for eight decoder-only configs and Whisper's encoder-decoder;
- ``blockwise_attention``, ``windowed_attention`` and ``attention_core``
  at S = T = 4096 (B 1, 2 heads over 1 kv head of 16), where both long-
  prompt branches are taken, and the reduced ``gqa_prefill`` (full and
  windowed) and ``mla_prefill`` through ``attention_core`` at 4096
  tokens;
- ``get_model``, ``frontend_shape``, ``text_seq_len``, ``dummy_inputs``,
  ``count_params``, ``param_bytes`` and the ``init_cache`` tree for all
  eleven configs.

Tolerance: one layer's output, float32 in both, reduced in another order
by torch and XLA: rtol = atol = 2e-5; logits and caches through four
layers and twenty steps, and the long-prompt paths (a 4096-term softmax
summed in chunks): 1e-4 relative and absolute (values are O(1)).
"""
import functools
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import close, np_tree, rnd, trees_close

from repro.configs import archs as jarchs
from repro.configs import reduced as j_reduced
from repro.launch import knobs as jknobs
from repro.models import layers as jL
from repro.models import lm as jlm
from repro.models import registry as jreg
from repro.quant import awq as j_awq
from repro.quant import qlinear as jq
from repro_torch import bridge
from repro_torch.configs import archs as tarchs
from repro_torch.configs import reduced as t_reduced
from repro_torch.launch import knobs as tknobs
from repro_torch.models import layers as tL
from repro_torch.models import lm as tlm
from repro_torch.models import registry as treg

TOL = dict(rtol=2e-5, atol=2e-5)
STEP_TOL = dict(rtol=1e-4, atol=1e-4)

# config name of each family case of the decode tests
FAMILIES = {"dense": "morph-llama2-7b", "olmo": "olmo-1b",
            "qwen2": "qwen2-1.5b", "nemotron": "nemotron-4-15b",
            "command_r": "command-r-plus-104b",
            "mla_dense+mla_moe": "deepseek-v3-671b",
            "dense+moe": "llama4-maverick-400b-a17b", "mamba": "mamba2-780m",
            "hybrid": "hymba-1.5b", "vlm": "internvl2-1b"}


@pytest.fixture
def free_compiled():
    """The test's JAX executables go with it (each config and shape
    compiles its own), so the file stays within one worker's memory."""
    yield
    jax.clear_caches()
    gc.collect()


def cfgs(name):
    return (j_reduced(jarchs.get_config(name)),
            t_reduced(tarchs.get_config(name)))


@functools.lru_cache(maxsize=2)
def model(name):
    """(JAX config, port config, JAX params, port params on the CPU)."""
    jc, tc = cfgs(name)
    params = jlm.init_params(jc, jax.random.PRNGKey(0))
    return jc, tc, params, bridge.to_torch(np_tree(params), "cpu")


def layer0(name):
    jc, tc, params, _ = model(name)
    jp = jlm.params_to_layer_list(jc, params)[0][1]["attn"]
    return jc, tc, jp, bridge.to_torch(np_tree(jp), "cpu")


# ---------------------------------------------------------------------------
# the layers' decode paths
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (8, 0.0), (0, 30.0)])
def test_gqa_decode_matches_jax(window, softcap):
    """Self-attention decode over a dense cache: the new k/v written at
    each sequence's own position (0, 5, 23 of 24 rows), then a causal,
    windowed or soft-capped read."""
    jc, tc, jp, tp = layer0("morph-llama2-7b")
    jc, tc = (c.replace(logit_softcap=softcap) for c in (jc, tc))
    B, T, KVH, Dh = 3, 24, jc.n_kv_heads, jc.resolved_head_dim
    x = rnd((B, 1, jc.d_model), 1, 0.5)
    k, v = rnd((B, T, KVH, Dh), 2), rnd((B, T, KVH, Dh), 3)
    pos = np.array([0, 5, 23], np.int32)
    jy, jcache = jL.gqa_decode(jp, jc, jnp.asarray(x),
                               {"k": jnp.asarray(k), "v": jnp.asarray(v),
                                "pos": jnp.asarray(pos)}, window=window)
    tk, tv = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
    ty, tcache = tL.gqa_decode(tp, tc, torch.from_numpy(x),
                               {"k": tk, "v": tv,
                                "pos": torch.from_numpy(pos)},
                               window=window)
    close(ty, jy, TOL)
    trees_close(tcache, jcache, TOL)
    assert tcache["k"] is tk and tcache["v"] is tv   # written in place


def test_gqa_cross_attention_matches_jax():
    """Cross-attention: ``gqa_decode`` and ``gqa_apply`` over encoder k/v
    (no rope, no mask), and ``gqa_apply`` bidirectional
    (``causal=False``, the encoder's self-attention)."""
    jc, tc, jp, tp = layer0("whisper-small")
    B, T, KVH, Dh = 2, 40, jc.n_kv_heads, jc.resolved_head_dim
    kv = [rnd((B, T, KVH, Dh), s) for s in (4, 5)]
    x1, x7 = rnd((B, 1, jc.d_model), 6, 0.5), rnd((B, 7, jc.d_model), 7, 0.5)
    jkv = tuple(jnp.asarray(a) for a in kv)
    tkv = tuple(torch.from_numpy(a) for a in kv)
    pos = np.array([3, 9], np.int32)
    jy, jcache = jL.gqa_decode(jp, jc, jnp.asarray(x1),
                               {"pos": jnp.asarray(pos)}, cross_kv=jkv)
    ty, tcache = tL.gqa_decode(tp, tc, torch.from_numpy(x1),
                               {"pos": torch.from_numpy(pos)}, cross_kv=tkv)
    close(ty, jy, TOL)
    assert tcache["pos"].tolist() == [4, 10]
    close(tL.gqa_apply(tp, tc, torch.from_numpy(x7), cross_kv=tkv),
          jL.gqa_apply(jp, jc, jnp.asarray(x7), cross_kv=jkv), TOL)
    close(tL.gqa_apply(tp, tc, torch.from_numpy(x7), causal=False),
          jL.gqa_apply(jp, jc, jnp.asarray(x7), causal=False), TOL)


@pytest.mark.parametrize("absorbed", [True, False])
@pytest.mark.parametrize("w_ukv", ["fp", "int4"])
def test_mla_decode_matches_jax(absorbed, w_ukv):
    """MLA decode over the latent cache (3 sequences at 0, 6 and 19 of 20
    rows), absorbed and expanded, with ``w_ukv`` dense or int4 (the
    absorbed branch dequantizes it; the expanded one multiplies through
    the quantized route)."""
    jc, tc, jp, _ = layer0("deepseek-v3-671b")
    if w_ukv == "int4":
        jp = dict(jp, w_ukv=jq.quantize_tensor(jp["w_ukv"], bits=4,
                                               group=32, use_kernel=True))
    tp = bridge.to_torch(np_tree(jp), "cpu")
    m = jc.mla
    B, T = 3, 20
    x = rnd((B, 1, jc.d_model), 8, 0.5)
    lat = rnd((B, T, m.kv_lora_rank + m.qk_rope_head_dim), 9)
    pos = np.array([0, 6, 19], np.int32)
    jy, jcache = jL.mla_decode(jp, jc, jnp.asarray(x),
                               {"latent": jnp.asarray(lat),
                                "pos": jnp.asarray(pos)}, absorbed=absorbed)
    tlat = torch.from_numpy(lat.copy())
    ty, tcache = tL.mla_decode(tp, tc, torch.from_numpy(x),
                               {"latent": tlat,
                                "pos": torch.from_numpy(pos)},
                               absorbed=absorbed)
    close(ty, jy, TOL)
    trees_close(tcache, jcache, TOL)
    assert tcache["latent"] is tlat                  # written in place


# ---------------------------------------------------------------------------
# decode_step over the contiguous cache, every family
# ---------------------------------------------------------------------------
STEPS, MAX_SEQ = 20, 24


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.usefixtures("free_compiled")
def test_decode_step_matches_jax(family):
    """``lm.init_cache`` builds the JAX cache tree; twenty
    ``lm.decode_step`` calls from the bridged JAX cache give the JAX
    logits and caches at every step."""
    jc, tc, params, tparams = model(FAMILIES[family])
    B = 2
    jcache = jlm.init_cache(jc, B, MAX_SEQ)
    tcache = tlm.init_cache(tc, B, MAX_SEQ, device="cpu")
    assert jax.tree.map(lambda a: (a.shape, str(a.dtype)), jcache) == \
        jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)
                                .replace("torch.", "")), tcache,
                     is_leaf=lambda x: isinstance(x, torch.Tensor))
    tcache = bridge.to_torch(np_tree(jcache), "cpu")
    step = jax.jit(functools.partial(jlm.decode_step, jc))
    toks = np.random.default_rng(11).integers(0, jc.vocab, (STEPS, B, 1))
    for t in range(STEPS):
        jl, jcache = step(params, jcache, jnp.asarray(toks[t]))
        tl, tcache = tlm.decode_step(tc, tparams, tcache,
                                     torch.from_numpy(toks[t]))
        close(tl, jl, STEP_TOL)
    trees_close(tcache, jcache, STEP_TOL)


@pytest.mark.parametrize("family", ["dense", "mla_dense+mla_moe",
                                    "dense+moe", "mamba", "hybrid", "vlm"])
def test_decode_step_unrolled_matches_jax(family):
    """The per-layer decode with layer 0 int4 (kernel-flagged) and the
    rest fp, over per-layer caches: twelve steps."""
    jc, tc, params, tparams = model(FAMILIES[family])
    B = 2
    jlayers = jlm.params_to_layer_list(jc, params)
    kind0, lp0 = jlayers[0]
    jlayers[0] = (kind0, j_awq.quantize_tree(lp0, bits=4, use_kernel=True))
    tlayers = [(k, bridge.to_torch(np_tree(p), "cpu")) for k, p in jlayers]
    assert any(jq.is_quantized(x) for x in jax.tree.leaves(
        jlayers[0][1], is_leaf=jq.is_quantized))
    jcaches = [jlm._layer_cache(jc, k, B, MAX_SEQ, jnp.float32)
               for k in jlm.layer_kinds(jc)]
    tcaches = [bridge.to_torch(np_tree(c), "cpu") for c in jcaches]
    jpos, tpos = jnp.zeros((B,), jnp.int32), torch.zeros((B,),
                                                         dtype=torch.int32)
    toks = np.random.default_rng(12).integers(0, jc.vocab, (12, B, 1))
    for t in range(12):
        jl, jcaches = jlm.decode_step_unrolled(jc, params, jlayers, jcaches,
                                               jpos, jnp.asarray(toks[t]))
        tl, tcaches = tlm.decode_step_unrolled(tc, tparams, tlayers, tcaches,
                                               tpos, torch.from_numpy(toks[t]))
        close(tl, jl, STEP_TOL)
        jpos, tpos = jpos + 1, tpos + 1
    trees_close(tcaches, jcaches, STEP_TOL)


@pytest.mark.parametrize("family", ["dense", "qwen2", "command_r",
                                    "mla_dense+mla_moe", "dense+moe",
                                    "mamba", "hybrid", "vlm", "whisper"])
def test_plain_reaches_every_kernel_matmul(family, monkeypatch):
    """With every layer GEMM weight int4 and kernel-flagged, each entry of the
    model API (``forward``, ``prefill_collect``, ``init_cache`` +
    ``decode_step``, ``decode_step_unrolled``; for Whisper ``encode``,
    ``start_cache``, ``decode_step`` and ``decode_forward``) hands its
    ``plain`` to every call of K1's route and to no other value. On the
    card ``plain=True`` is the route its kernel is held against. No
    tolerance: a count of calls."""
    from repro_torch.kernels import ops
    from repro_torch.models import encdec as ted
    from repro_torch.quant import quantize_tree
    seen = []
    fn = ops.wna16_matmul
    monkeypatch.setattr(ops, "wna16_matmul", lambda *a, plain=False, **k:
                        seen.append(plain) or fn(*a, plain=plain, **k))
    q = functools.partial(quantize_tree, bits=4, group=32, use_kernel=True)
    name = "whisper-small" if family == "whisper" else FAMILIES[family]
    tc = cfgs(name)[1]
    gen = torch.Generator().manual_seed(0)
    api = treg.get_model(tc)
    params = api.init_params(tc, gen)
    B, S = 2, 8
    inputs = treg.dummy_inputs(tc, B, S + tc.n_image_tokens, gen=gen,
                               device="cpu")
    tokens, fe = inputs["tokens"], inputs.get("frontend")

    def calls(plain):
        seen.clear()
        if family == "whisper":
            qp = dict(params, **{
                k: tlm._stack([q(tlm._index(params[k], i)) for i in range(n)])
                for k, n in (("enc_blocks", tc.n_encoder_layers),
                             ("dec_blocks", tc.n_layers))})
            enc = ted.encode(tc, qp, fe, plain=plain)
            cache = ted.start_cache(tc, qp, enc, ted.init_cache(
                tc, B, 4, device="cpu"), plain=plain)
            for _ in range(2):
                _, cache = ted.decode_step(tc, qp, cache, tokens[:, :1],
                                           plain=plain)
            ted.decode_forward(tc, qp, tokens, enc, plain=plain)
            ted.forward(tc, qp, tokens, frontend=fe, plain=plain)
        else:
            layers = [(k, q(lp)) for k, lp in
                      tlm.params_to_layer_list(tc, params)]
            qp = tlm.layer_list_to_params(tc, layers, params)
            if "projector" in qp:
                qp = dict(qp, projector=dict(qp["projector"],
                                             w=q(qp["projector"]["w"])))
            tlm.forward(tc, qp, tokens, frontend=fe, plain=plain)
            tlm.prefill_collect(tc, qp, layers, tokens, frontend=fe,
                                plain=plain)
            cache = tlm.init_cache(tc, B, 4, device="cpu")
            for _ in range(2):
                _, cache = tlm.decode_step(tc, qp, cache, tokens[:, :1],
                                           plain=plain)
            caches = [tlm._layer_cache(tc, k, B, 4, torch.float32, "cpu")
                      for k, _ in layers]
            tlm.decode_step_unrolled(tc, qp, layers, caches,
                                     torch.zeros(B, dtype=torch.int32),
                                     tokens[:, :1], plain=plain)
        return list(seen)

    for plain in (True, False):
        got = calls(plain)
        assert len(got) > 0 and set(got) == {plain}, (plain, len(got))


# ---------------------------------------------------------------------------
# long prompts: the blockwise and windowed branches of attention_core
# ---------------------------------------------------------------------------
@pytest.fixture
def knobs_reset():
    yield
    jknobs.reset()
    tknobs.reset()


def _qkv(S=4096, H=2, KVH=1, D=16):
    return [rnd((1, S, h, D), s, 0.5) for s, h in ((21, H), (22, KVH),
                                                   (23, KVH))]


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (700, 0.0),
                                            (0, 5.0)])
def test_blockwise_attention_matches_jax(window, softcap):
    q, k, v = _qkv()
    close(tL.blockwise_attention(*map(torch.from_numpy, (q, k, v)),
                                 causal=True, window=window,
                                 softcap=softcap),
          jL.blockwise_attention(*map(jnp.asarray, (q, k, v)), causal=True,
                                 window=window, softcap=softcap), STEP_TOL)


@pytest.mark.parametrize("window", [512, 1000])
def test_windowed_attention_matches_jax(window):
    q, k, v = _qkv()
    close(tL.windowed_attention(*map(torch.from_numpy, (q, k, v)),
                                window=window),
          jL.windowed_attention(*map(jnp.asarray, (q, k, v)), window=window),
          STEP_TOL)


@pytest.mark.parametrize("S,window,windowed_knob,branch", [
    (4096, 0, True, "blockwise"), (4096, 512, True, "windowed"),
    (4096, 512, False, "blockwise"), (2048, 0, True, "naive"),
    (4096, 4000, True, "blockwise")])
def test_attention_core_branches_match_jax(S, window, windowed_knob, branch,
                                           monkeypatch, knobs_reset):
    """The branch ``attention_core`` takes (the JAX rule: at least
    2048·4096 scores, S % 1024, S >= 2·window, the ``windowed_attn``
    knob) and its output against the JAX ``attention_core``."""
    jknobs.set_knobs(windowed_attn=windowed_knob)
    tknobs.set_knobs(windowed_attn=windowed_knob)
    taken = []
    for name in ("naive_attention", "blockwise_attention",
                 "windowed_attention"):
        fn = getattr(tL, name)
        monkeypatch.setattr(tL, name, lambda *a, _fn=fn, _n=name, **k:
                            taken.append(_n) or _fn(*a, **k))
    q, k, v = _qkv(S)
    got = tL.attention_core(*map(torch.from_numpy, (q, k, v)), causal=True,
                            window=window)
    assert taken == [f"{branch}_attention"]
    close(got, jL.attention_core(*map(jnp.asarray, (q, k, v)), causal=True,
                                 window=window), STEP_TOL)


@pytest.mark.parametrize("name,window", [("morph-llama2-7b", 0),
                                         ("hymba-1.5b", 16),
                                         ("deepseek-v3-671b", 0)])
@pytest.mark.usefixtures("free_compiled")
def test_long_prefill_matches_jax(name, window):
    """The reduced ``gqa_prefill`` (full attention: blockwise; Hymba's
    window of 16: windowed) and ``mla_prefill`` (blockwise, q/k of 48
    lanes, v of 32) over a 4096-token prompt, output and cache payload."""
    jc, tc, jp, tp = layer0(name)
    x = rnd((1, 4096, jc.d_model), 24, 0.5)
    if jc.mla is not None:
        jy, jpay = jL.mla_prefill(jp, jc, jnp.asarray(x))
        ty, tpay = tL.mla_prefill(tp, tc, torch.from_numpy(x))
    else:
        jy, jpay = jL.gqa_prefill(jp, jc, jnp.asarray(x), window=window)
        ty, tpay = tL.gqa_prefill(tp, tc, torch.from_numpy(x), window=window)
    close(ty, jy, STEP_TOL)
    trees_close(tpay, jpay, STEP_TOL)


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(jarchs.ALL_CONFIGS))
def test_registry_matches_jax(name):
    """Every config's API (family routing, frontend, ``start_cache``), its
    frontend shape and text length, the shapes and dtypes of its dummy
    inputs, and, reduced, its parameter count and bytes and its
    ``init_cache`` tree."""
    jfull, tfull = jarchs.get_config(name), tarchs.get_config(name)
    ja, ta = jreg.get_model(jfull), treg.get_model(tfull)
    assert ja.needs_frontend == ta.needs_frontend
    assert (ja.start_cache is None) == (ta.start_cache is None)
    for B, S in ((1, 300), (4, 2048)):
        assert jreg.frontend_shape(jfull, B) == treg.frontend_shape(tfull, B)
        assert jreg.text_seq_len(jfull, S) == treg.text_seq_len(tfull, S)
    jc, tc = cfgs(name)
    ji = jreg.dummy_inputs(jc, 2, 24)
    ti = treg.dummy_inputs(tc, 2, 24, device="cpu")
    assert sorted(ji) == sorted(ti)
    for key in ji:
        assert tuple(ti[key].shape) == ji[key].shape
        assert ti[key].is_floating_point() == \
            jnp.issubdtype(ji[key].dtype, jnp.floating)
        assert ti[key].device.type == "cpu"
    jp = ja.init_params(jc, jax.random.PRNGKey(0))
    tp = ta.init_params(tc, torch.Generator().manual_seed(0))
    assert treg.count_params(tp) == jreg.count_params(jp)
    assert treg.param_bytes(tp) == jreg.param_bytes(jp)
    shapes = jax.tree.map(lambda a: tuple(a.shape), jp)
    assert shapes == jax.tree.map(
        lambda a: tuple(a.shape), tp,
        is_leaf=lambda x: isinstance(x, torch.Tensor))
    jcache = ja.init_cache(jc, 2, 16)
    tcache = ta.init_cache(tc, 2, 16, device="cpu")
    assert jax.tree.map(lambda a: a.shape, jcache) == jax.tree.map(
        lambda a: tuple(a.shape), tcache,
        is_leaf=lambda x: isinstance(x, torch.Tensor))


def test_device_defaults_to_the_card():
    """``init_cache`` and ``dummy_inputs`` put their tensors on the device
    they are given, the card by default (which this CPU-only build
    refuses)."""
    for name in ("whisper-small", "internvl2-1b"):
        tc = cfgs(name)[1]
        api = treg.get_model(tc)
        with pytest.raises((AssertionError, RuntimeError)):
            api.init_cache(tc, 1, 8)
        with pytest.raises((AssertionError, RuntimeError)):
            treg.dummy_inputs(tc, 1, 8)
        leaves = jax.tree.leaves(api.init_cache(tc, 1, 8, device="cpu"))
        assert {t.device.type for t in leaves} == {"cpu"}
