"""Decoder-only LM: the DENSE family (the paper's Llama-2 evaluation
models), the MOE family (DeepSeek-V3's ``mla_dense`` and ``mla_moe``
layers, Llama-4 Maverick's alternating ``dense`` and ``moe`` layers), the
SSM family (Mamba-2's ``mamba`` layers: a norm and the SSD mixer of
``models/mamba.py``) and the HYBRID family (Hymba's ``hybrid`` layers:
attention and the SSD mixer side by side on the same normed input, their
outputs normed and mixed as ``0.5 (beta_a rms(a) + beta_s rms(s))``, then
an MLP; every layer but the config's global ones attends within its
sliding window).

Parameters keep the JAX package's tree: ``{"embed", "final_norm",
"lm_head", "segments"}``, where ``segments`` holds one entry per maximal
run of a layer kind (or alternating pair of kinds) and each entry is a
tuple of per-offset param dicts, stacked with a leading repeat dim when
the run repeats. An MoE layer holds ``moe`` (``models/moe.py``) where a
dense one holds ``mlp``. The serving engine works on the **unrolled**
per-layer list (``params_to_layer_list``), where each layer may
independently be dense or quantized.

Every family builds here. A VLM (InternVL2) is the DENSE decoder with a
``projector`` ({"w", "b"}) that maps the caller's image patch embeddings
(``frontend``, (B, n_image_tokens, frontend_dim)) to ``n_image_tokens``
embeddings put before the text tokens; ``embed_tokens`` refuses a VLM call
without them. For an ENCDEC config (Whisper) this module gives what the
JAX ``lm`` gives, ``dense`` x ``n_layers``: the decoder-only plan that both
serving engines run; the encoder-decoder itself is ``models/encdec.py``.

Beside the engine's paged steps, the model API decodes over a contiguous
cache: ``init_cache`` builds the JAX tree ``{"segments", "pos"}`` (per
segment a tuple of per-offset caches, stacked when the run repeats: k/v
(B, Tmax, KVH, Dh), an MLA latent (B, Tmax, r + rope), an SSM state) and
``decode_step`` / ``decode_step_unrolled`` advance it by one token,
writing each layer's new row or state into it in place (as the JAX
package's jitted ``dynamic_update_slice`` does), so a step moves one row a
layer and not the cache. Every function that multiplies takes
``plain=True`` to ask each kernel route for its plain version.
``forward`` also trains: ``remat=True`` makes each repetition of a
segment's pattern one checkpoint (``launch.knobs.KNOBS.remat_policy``),
as each JAX scan step is one, and ``collect_aux=True`` returns the MoE
layers' expert loads.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Tuple

import torch
from torch.utils import checkpoint as ck

from repro_torch.configs.base import (DENSE, ENCDEC, HYBRID, MOE, SSM, VLM,
                                      ModelConfig)
from repro_torch.launch import knobs
from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models import moe as MO
from repro_torch.quant import qlinear

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name) -> torch.dtype:
    """The torch dtype of a config dtype name ("bfloat16", "float32")."""
    return name if isinstance(name, torch.dtype) else _DTYPES[str(name)]


_MOE_KINDS = ("moe", "mla_moe")


def _kinds(cfg: ModelConfig) -> List[str]:
    """The JAX package's layer-kind plan."""
    if cfg.family in (SSM, HYBRID):
        return ["mamba" if cfg.family == SSM else "hybrid"] * cfg.n_layers
    kinds = []
    for i in range(cfg.n_layers):
        if cfg.moe is not None:
            m = cfg.moe
            if i >= m.first_k_dense and \
                    (i - m.first_k_dense) % m.moe_layer_step \
                    == m.moe_layer_step - 1:
                kinds.append("mla_moe" if cfg.mla else "moe")
                continue
        kinds.append("mla_dense" if cfg.mla else "dense")
    return kinds


FAMILIES = (DENSE, MOE, SSM, HYBRID, ENCDEC, VLM)


def check_family(cfg: ModelConfig) -> None:
    """Every family of the config module builds; an unknown one raises."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}")


# ---------------------------------------------------------------------------
# Layer-kind plan
# ---------------------------------------------------------------------------
def layer_kinds(cfg: ModelConfig) -> List[str]:
    check_family(cfg)
    return _kinds(cfg)


def layer_window(cfg: ModelConfig, i: int, seq_hint: int = 0) -> int:
    """Sliding window for layer i (0 = full attention)."""
    if cfg.sliding_window and i not in cfg.global_attn_layers:
        return cfg.sliding_window
    return 0


def segment_plan(cfg: ModelConfig) -> List[Tuple[Tuple[str, ...], int]]:
    """[(pattern, repeats)]; segments split on (kind, window), as in the
    JAX package, so the param tree has the same shape there and here."""
    kinds = layer_kinds(cfg)
    n = len(kinds)
    keys = [(kinds[i], layer_window(cfg, i)) for i in range(n)]
    segs: List[Tuple[Tuple[str, ...], int]] = []
    i = 0
    while i < n:
        # longest run of a single (kind, window)
        j = i
        while j < n and keys[j] == keys[i]:
            j += 1
        run = j - i
        # alternating pattern (a, b, a, b, ...) from i
        if run == 1 and i + 1 < n and keys[i + 1] != keys[i]:
            a, b = keys[i], keys[i + 1]
            k = i
            while k + 1 < n and keys[k] == a and keys[k + 1] == b:
                k += 2
            pairs = (k - i) // 2
            if pairs >= 2:
                segs.append(((a[0], b[0]), pairs))
                i = i + 2 * pairs
                continue
        segs.append(((kinds[i],), run))
        i = j
    return segs


# ---------------------------------------------------------------------------
# Block init / apply
# ---------------------------------------------------------------------------
def _attn_init(gen, cfg, dtype):
    if cfg.mla is not None:
        return L.mla_init(gen, cfg, dtype)
    return L.gqa_init(gen, cfg, dtype)


def _attn_apply(p, cfg, x, *, window, plain=False, ctx=L.NO_SHARD):
    if cfg.mla is not None:
        return L.mla_apply(p, cfg, x, plain=plain, ctx=ctx)
    return L.gqa_apply(p, cfg, x, window=window, plain=plain, ctx=ctx)


def block_init(kind: str, gen: torch.Generator, cfg: ModelConfig, dtype):
    dev = gen.device
    if kind == "mamba":
        return {"norm": L.norm_init(cfg.norm, cfg.d_model, dtype, dev),
                "mixer": M.mamba_init(gen, cfg, dtype)}
    if kind == "hybrid":
        return {"ln1": L.norm_init(cfg.norm, cfg.d_model, dtype, dev),
                "attn": L.gqa_init(gen, cfg, dtype),
                "ssm": M.mamba_init(gen, cfg, dtype),
                "norm_a": L.norm_init("rmsnorm", cfg.d_model, dtype, dev),
                "norm_s": L.norm_init("rmsnorm", cfg.d_model, dtype, dev),
                "beta_a": torch.ones((), dtype=torch.float32, device=dev),
                "beta_s": torch.ones((), dtype=torch.float32, device=dev),
                "ln2": L.norm_init(cfg.norm, cfg.d_model, dtype, dev),
                "mlp": L.mlp_init(gen, cfg, dtype=dtype)}
    p = {"ln1": L.norm_init(cfg.norm, cfg.d_model, dtype, gen.device),
         "attn": _attn_init(gen, cfg, dtype)}
    if not cfg.parallel_block:
        p["ln2"] = L.norm_init(cfg.norm, cfg.d_model, dtype, gen.device)
    if kind in _MOE_KINDS:
        p["moe"] = MO.moe_init(gen, cfg, dtype)
    else:
        p["mlp"] = L.mlp_init(gen, cfg, dtype=dtype)
    return p


def block_apply(kind: str, p, cfg: ModelConfig, x, *, window: int = 0,
                moe_cf: float = 1.25, plain: bool = False,
                ctx: L.ShardCtx = L.NO_SHARD):
    """Full-sequence block. Returns (x, aux); aux carries the MoE layer's
    statistics and is empty without one. ``ctx`` carries the sharding
    hints."""
    if kind == "mamba":
        h = L.apply_norm(cfg.norm, p["norm"], x)
        return x + M.mamba_apply(p["mixer"], cfg, h, plain=plain), {}
    if kind == "hybrid":
        h = L.apply_norm(cfg.norm, p["ln1"], x)
        a = L.gqa_apply(p["attn"], cfg, h, window=window, plain=plain,
                        ctx=ctx)
        s = M.mamba_apply(p["ssm"], cfg, h, plain=plain)
        return hybrid_ffn(p, cfg, x, a, s, plain=plain), {}
    h = L.apply_norm(cfg.norm, p["ln1"], x)
    attn_out = _attn_apply(p["attn"], cfg, h, window=window, plain=plain,
                           ctx=ctx)
    if cfg.parallel_block:
        return x + attn_out + L.mlp_apply(p["mlp"], cfg, h, plain=plain), {}
    x = x + attn_out
    h2 = L.apply_norm(cfg.norm, p["ln2"], x)
    y, aux = ffn_apply(kind, p, cfg, h2, moe_cf=moe_cf, plain=plain,
                       ctx=ctx)
    return x + y, aux


def block_prefill(kind: str, p, cfg: ModelConfig, x, *, window: int = 0,
                  plain: bool = False):
    """Full-seq block that also returns this layer's cache payload: GQA →
    {"k", "v"}, MLA → {"latent"}, Mamba → its final state {"ssm_conv",
    "ssm_ssm"}, hybrid → both {"k", "v"} and the state."""
    if kind == "mamba":
        h = L.apply_norm(cfg.norm, p["norm"], x)
        y, st = M.mamba_apply(p["mixer"], cfg, h, return_state=True,
                              plain=plain)
        return x + y, {"ssm_conv": st["conv"], "ssm_ssm": st["ssm"]}
    if kind == "hybrid":
        h = L.apply_norm(cfg.norm, p["ln1"], x)
        a, (k, v) = L.gqa_prefill(p["attn"], cfg, h, window=window,
                                  plain=plain)
        s, st = M.mamba_apply(p["ssm"], cfg, h, return_state=True,
                              plain=plain)
        return hybrid_ffn(p, cfg, x, a, s, plain=plain), \
            {"k": k, "v": v, "ssm_conv": st["conv"], "ssm_ssm": st["ssm"]}
    h = L.apply_norm(cfg.norm, p["ln1"], x)
    if cfg.mla is not None:
        attn_out, latent = L.mla_prefill(p["attn"], cfg, h, plain=plain)
        payload = {"latent": latent}
    else:
        attn_out, (k, v) = L.gqa_prefill(p["attn"], cfg, h, window=window,
                                         plain=plain)
        payload = {"k": k, "v": v}
    if cfg.parallel_block:
        y = L.mlp_apply(p["mlp"], cfg, h, plain=plain)
        return x + attn_out + y, payload
    x = x + attn_out
    h2 = L.apply_norm(cfg.norm, p["ln2"], x)
    return x + ffn_apply(kind, p, cfg, h2, plain=plain)[0], payload


def hybrid_ffn(p, cfg: ModelConfig, x, a, s, *, plain: bool = False):
    """A hybrid block past its two mixers: the attention output ``a`` and
    the SSM output ``s`` each rms-normed, weighted by the float32
    ``beta_a``/``beta_s`` and averaged in float32 into the residual, then
    the MLP."""
    mixed = 0.5 * (p["beta_a"] * L.apply_norm("rmsnorm", p["norm_a"],
                                               a).float()
                   + p["beta_s"] * L.apply_norm("rmsnorm", p["norm_s"],
                                                s).float())
    x = x + mixed.to(x.dtype)
    h2 = L.apply_norm(cfg.norm, p["ln2"], x)
    return x + L.mlp_apply(p["mlp"], cfg, h2, plain=plain)


def ffn_apply(kind: str, p, cfg: ModelConfig, h, *, moe_cf: float = -1.0,
              plain: bool = False, ctx: L.ShardCtx = L.NO_SHARD):
    """A block's FFN: the MoE layer at capacity factor ``moe_cf`` (<= 0:
    no drop, as every serving path of the JAX package runs it), else the
    MLP. Returns (y, aux); aux is empty without MoE."""
    if kind in _MOE_KINDS:
        return MO.moe_apply(p["moe"], cfg, h, capacity_factor=moe_cf,
                            plain=plain, ctx=ctx)
    return L.mlp_apply(p["mlp"], cfg, h, plain=plain), {}


# ---------------------------------------------------------------------------
# Model init / forward
# ---------------------------------------------------------------------------
def _stack(trees):
    """One tree from same-structured trees, stacked along a new leading
    dim: tensors by ``torch.stack``, QTensors field by field into one
    stacked QTensor (read back per entry through ``QTensor.expert``)."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: _stack([t[k] for t in trees]) for k in t0}
    if qlinear.is_quantized(t0):
        return qlinear.QTensor(
            *(torch.stack([getattr(t, f) for t in trees])
              for f in ("packed", "scales", "zeros")),
            bits=t0.bits, group=t0.group, K=t0.K, N=t0.N,
            out_dtype=t0.out_dtype, use_kernel=t0.use_kernel,
            inv_act=None if t0.inv_act is None
            else torch.stack([t.inv_act for t in trees]))
    return torch.stack(trees)


def init_params(cfg: ModelConfig, gen: torch.Generator) -> Dict[str, Any]:
    """Random parameters drawn from ``gen`` on ``gen.device`` in the config
    dtype. Layer draws come first, then the embedding and the head."""
    dtype = torch_dtype(cfg.dtype)
    seg_params = []
    for pattern, reps in segment_plan(cfg):
        stacked = [tuple(block_init(kind, gen, cfg, dtype) for kind in pattern)
                   for _ in range(reps)]
        if reps > 1:
            seg_params.append(tuple(_stack([s[o] for s in stacked])
                                    for o in range(len(pattern))))
        else:
            seg_params.append(stacked[0])
    params = {
        "embed": L.embed_init(gen, (cfg.vocab, cfg.d_model), dtype),
        "final_norm": L.norm_init(cfg.norm, cfg.d_model, dtype, gen.device),
        "segments": seg_params,
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(gen, (cfg.d_model, cfg.vocab),
                                         dtype=dtype)
    if cfg.family == VLM:
        params["projector"] = {
            "w": L.dense_init(gen, (cfg.frontend_dim, cfg.d_model),
                              dtype=dtype),
            "b": torch.zeros((cfg.d_model,), dtype=dtype, device=gen.device)}
    return params


def embed_tokens(cfg, params, tokens, frontend=None, plain: bool = False):
    """Token embeddings (B, S, D); a VLM puts its projected image patch
    embeddings ``frontend`` (B, n_image_tokens, frontend_dim) first."""
    emb = params["embed"][tokens]
    if cfg.family == VLM:
        if frontend is None:
            raise ValueError("vlm needs patch embeddings (frontend=)")
        pe = qlinear.matmul(frontend, params["projector"]["w"],
                            bias=params["projector"]["b"], plain=plain)
        emb = torch.cat([pe.to(emb.dtype), emb], dim=1)
    return emb


def unembed(cfg, params, x, plain: bool = False):
    x = L.apply_norm(cfg.norm, params["final_norm"], x)
    if cfg.tie_embeddings:
        return torch.matmul(x, params["embed"].T.to(x.dtype))
    return qlinear.matmul(x, params["lm_head"], plain=plain)


def forward(cfg: ModelConfig, params, tokens, *, frontend=None,
            moe_cf: float = 1.25, remat: bool = False,
            collect_aux: bool = False, plain: bool = False,
            ctx: L.ShardCtx = L.NO_SHARD):
    """Full-sequence logits (train / prefill). tokens: (B, S_text);
    ``frontend``: a VLM's patch embeddings. ``moe_cf``: the MoE layers'
    capacity factor (<= 0: no drop). ``remat=True`` recomputes each
    repetition of a segment's pattern (the JAX package's scan step) in the
    backward pass, by ``knobs.KNOBS.remat_policy``. ``collect_aux=True``
    returns (logits, per segment its stacked ``expert_load``, as the JAX
    ``forward`` does). ``plain=True`` asks every kernel route for its
    plain version. ``ctx`` carries the sharding hints."""
    return forward_unrolled(cfg, params, params_to_layer_list(cfg, params),
                            tokens, frontend=frontend, moe_cf=moe_cf,
                            remat=remat, collect_aux=collect_aux,
                            plain=plain, ctx=ctx)


_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    """The selective checkpoint's counterpart of JAX's ``dots_saveable``:
    keep every matmul's output, recompute the rest."""
    return (ck.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else ck.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(step, x):
    """``step(x)`` under the ``knobs.KNOBS.remat_policy`` checkpoint:
    "full" keeps only its input, "dots" its matmul outputs too, "none"
    everything."""
    policy = knobs.KNOBS.remat_policy
    if policy == "none":
        return step(x)
    if policy == "dots":
        return ck.checkpoint(step, x, use_reentrant=False,
                             context_fn=functools.partial(
                                 ck.create_selective_checkpoint_contexts,
                                 _save_dots))
    return ck.checkpoint(step, x, use_reentrant=False)


# ---------------------------------------------------------------------------
# Unrolled (per-layer list) path — used by the serving engine for morphing
# ---------------------------------------------------------------------------
def _index(tree, r):
    """Entry ``r`` of a stacked tree: tensors indexed, a stacked QTensor
    through its 2-D view ``expert(r)``."""
    return {k: (_index(v, r) if isinstance(v, dict) else
                v.expert(r) if qlinear.is_quantized(v) else v[r])
            for k, v in tree.items()}


def _unstack(tree, reps: int) -> List:
    """The ``reps`` entries of a stacked tree: each tensor unbound once
    (one backward node a leaf, where indexing would add one a layer), a
    stacked QTensor through ``expert(r)``."""
    if isinstance(tree, dict):
        per = {k: _unstack(v, reps) for k, v in tree.items()}
        return [{k: per[k][r] for k in tree} for r in range(reps)]
    if qlinear.is_quantized(tree):
        return [tree.expert(r) for r in range(reps)]
    return list(tree.unbind(0))


def params_to_layer_list(cfg: ModelConfig, params) -> List[Tuple[str, Any]]:
    """Flatten segment params into [(kind, layer_params)] of length L
    (stacked tensors are unbound, so layer params are views)."""
    out = []
    for (pattern, reps), seg_p in zip(segment_plan(cfg), params["segments"]):
        per_off = [_unstack(seg_p[o], reps) if reps > 1 else [seg_p[o]]
                   for o in range(len(pattern))]
        for r in range(reps):
            for o, kind in enumerate(pattern):
                out.append((kind, per_off[o][r]))
    return out


def layer_list_to_params(cfg: ModelConfig, layer_list, params) -> Dict:
    """Inverse of params_to_layer_list (restacks; needs homogeneous
    precision within a segment)."""
    seg_params = []
    li = 0
    for pattern, reps in segment_plan(cfg):
        stacked = [tuple(layer_list[li + r * len(pattern) + o][1]
                         for o in range(len(pattern))) for r in range(reps)]
        if reps > 1:
            seg_params.append(tuple(_stack([s[o] for s in stacked])
                                    for o in range(len(pattern))))
        else:
            seg_params.append(stacked[0])
        li += len(pattern) * reps
    return dict(params, segments=seg_params)


def forward_unrolled(cfg: ModelConfig, params, layer_list, tokens, *,
                     frontend=None, moe_cf: float = 1.25,
                     remat: bool = False, collect_aux: bool = False,
                     plain: bool = False, ctx: L.ShardCtx = L.NO_SHARD):
    """:func:`forward` over a per-layer list of possibly mixed-precision
    layers, in the segment plan's order; its steps (one repetition of a
    segment's pattern) are what ``remat`` checkpoints and what
    ``collect_aux`` stacks."""
    if len(layer_list) != cfg.n_layers:
        raise ValueError(f"{len(layer_list)} layers for a config of "
                         f"{cfg.n_layers}")
    x = embed_tokens(cfg, params, tokens, frontend, plain=plain)
    x = ctx.constrain(x, (ctx.data_axis, None, None), "lm.forward")
    aux_acc, li = [], 0
    for pattern, reps in segment_plan(cfg):
        loads = []
        for _ in range(reps):
            def step(x, _li=li, _n=len(pattern)):
                out = []
                for i in range(_li, _li + _n):
                    kind, lp = layer_list[i]
                    x, aux = block_apply(kind, lp, cfg, x,
                                         window=layer_window(cfg, i),
                                         moe_cf=moe_cf, plain=plain,
                                         ctx=ctx)
                    if "expert_load" in aux:
                        out.append(aux["expert_load"])
                return x, (torch.stack(out) if out else
                           torch.zeros((1,), device=x.device))
            x, load = _remat(step, x) if remat else step(x)
            loads.append(load)
            li += len(pattern)
        aux_acc.append(torch.stack(loads) if reps > 1 else loads[0])
    logits = unembed(cfg, params, x, plain=plain)
    return (logits, aux_acc) if collect_aux else logits


def prefill_collect(cfg: ModelConfig, params, layer_list, tokens, *,
                    frontend=None, plain: bool = False):
    """Unrolled prefill returning (logits, [per-layer cache payload])."""
    x = embed_tokens(cfg, params, tokens, frontend, plain=plain)
    payloads = []
    for i, (kind, lp) in enumerate(layer_list):
        x, payload = block_prefill(kind, lp, cfg, x,
                                   window=layer_window(cfg, i), plain=plain)
        payloads.append(payload)
    return unembed(cfg, params, x, plain=plain), payloads


# ---------------------------------------------------------------------------
# Decode over a contiguous cache (the model API's decode path)
# ---------------------------------------------------------------------------
def _layer_cache(cfg, kind, batch, max_seq, dtype, device):
    Dh = cfg.resolved_head_dim
    if kind == "mamba":
        return M.mamba_init_state(cfg, batch, torch.float32, device=device)
    kv = (batch, max_seq, cfg.n_kv_heads, Dh)
    if kind == "hybrid":
        st = M.mamba_init_state(cfg, batch, torch.float32, device=device)
        return {"k": torch.zeros(kv, dtype=dtype, device=device),
                "v": torch.zeros(kv, dtype=dtype, device=device),
                **{f"ssm_{k}": v for k, v in st.items()}}
    if cfg.mla is not None:
        m = cfg.mla
        return {"latent": torch.zeros(
            (batch, max_seq, m.kv_lora_rank + m.qk_rope_head_dim),
            dtype=dtype, device=device)}
    return {"k": torch.zeros(kv, dtype=dtype, device=device),
            "v": torch.zeros(kv, dtype=dtype, device=device)}


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None, *,
               device="cuda") -> Dict[str, Any]:
    """The JAX package's decode cache on ``device``: {"segments": per
    segment a tuple of per-offset layer caches (stacked with a leading
    repeat dim when the run repeats), "pos": (batch,) int32 zeros}. KV and
    latent rows are ``dtype`` (the config's by default); SSM states are
    float32."""
    dtype = torch_dtype(dtype or cfg.dtype)
    caches = [_layer_cache(cfg, kind, batch, max_seq, dtype, device)
              for kind in layer_kinds(cfg)]
    out, li = [], 0
    for pattern, reps in segment_plan(cfg):
        per_off = [[caches[li + r * len(pattern) + o] for r in range(reps)]
                   for o in range(len(pattern))]
        out.append(tuple(_stack(c) if reps > 1 else c[0] for c in per_off))
        li += len(pattern) * reps
    return {"segments": out,
            "pos": torch.zeros((batch,), dtype=torch.int32, device=device)}


def _update(cache, state, prefix=""):
    """Copy the SSM ``state`` {"conv", "ssm"} into ``cache`` in place."""
    for k, v in state.items():
        cache[prefix + k].copy_(v)


def block_decode(kind: str, p, cfg: ModelConfig, x, cache, pos, *,
                 window: int = 0, plain: bool = False):
    """Single-token decode for one block. x: (B, 1, D); pos: (B,). The
    layer's cache is updated in place: the new token's k/v or latent row
    written at ``pos``, an SSM state overwritten. Returns (x, cache)."""
    if kind == "mamba":
        h = L.apply_norm(cfg.norm, p["norm"], x)
        y, st = M.mamba_decode(p["mixer"], cfg, h, cache, plain=plain)
        _update(cache, st)
        return x + y, cache
    if kind == "hybrid":
        h = L.apply_norm(cfg.norm, p["ln1"], x)
        a, _ = L.gqa_decode(p["attn"], cfg, h,
                            {"k": cache["k"], "v": cache["v"], "pos": pos},
                            window=window, plain=plain)
        s, st = M.mamba_decode(p["ssm"], cfg, h, {"conv": cache["ssm_conv"],
                                                  "ssm": cache["ssm_ssm"]},
                               plain=plain)
        _update(cache, st, "ssm_")
        return hybrid_ffn(p, cfg, x, a, s, plain=plain), cache
    h = L.apply_norm(cfg.norm, p["ln1"], x)
    if cfg.mla is not None:
        attn_out, _ = L.mla_decode(p["attn"], cfg, h,
                                   {"latent": cache["latent"], "pos": pos},
                                   plain=plain)
    else:
        attn_out, _ = L.gqa_decode(p["attn"], cfg, h,
                                   {"k": cache["k"], "v": cache["v"],
                                    "pos": pos}, window=window, plain=plain)
    if cfg.parallel_block:
        return x + attn_out + L.mlp_apply(p["mlp"], cfg, h,
                                          plain=plain), cache
    x = x + attn_out
    h2 = L.apply_norm(cfg.norm, p["ln2"], x)
    return x + ffn_apply(kind, p, cfg, h2, plain=plain)[0], cache


def decode_step(cfg: ModelConfig, params, cache, tokens, *,
                plain: bool = False):
    """One decode step over the whole stack. tokens: (B, 1) (text tokens:
    a VLM's image tokens went in at prefill). The layer caches are
    updated in place (a stacked segment through its per-layer views).
    Returns (logits (B, 1, V), the cache with ``pos + 1``)."""
    x = params["embed"][tokens]
    pos = cache["pos"]
    li = 0
    for (pattern, reps), seg_p, seg_c in zip(segment_plan(cfg),
                                             params["segments"],
                                             cache["segments"]):
        for r in range(reps):
            for o, kind in enumerate(pattern):
                lp, lc = ((_index(seg_p[o], r), _index(seg_c[o], r))
                          if reps > 1 else (seg_p[o], seg_c[o]))
                x, _ = block_decode(kind, lp, cfg, x, lc, pos,
                                    window=layer_window(cfg, li),
                                    plain=plain)
                li += 1
    return unembed(cfg, params, x, plain=plain), dict(cache, pos=pos + 1)


def decode_step_unrolled(cfg: ModelConfig, params, layer_list, layer_caches,
                         pos, tokens, *, plain: bool = False):
    """Decode over a per-layer list of possibly mixed-precision layers.
    layer_caches: one cache dict a layer, updated in place; pos: (B,).
    Returns (logits, the layer caches)."""
    x = params["embed"][tokens]
    for i, (kind, lp) in enumerate(layer_list):
        x, _ = block_decode(kind, lp, cfg, x, layer_caches[i], pos,
                            window=layer_window(cfg, i), plain=plain)
    return unembed(cfg, params, x, plain=plain), layer_caches
