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

The enc-dec and VLM families are not ported yet; they raise
``NotImplementedError`` naming their ROADMAP queue 1 item.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from repro_torch.configs.base import DENSE, HYBRID, MOE, SSM, ModelConfig
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


def check_family(cfg: ModelConfig) -> None:
    if cfg.family in (DENSE, MOE, SSM, HYBRID):
        return
    raise NotImplementedError(
        f"{cfg.name}: family {cfg.family!r} is not ported to torch yet "
        f"— ROADMAP.md queue 1, item 8, 'Encoder-decoder and VLM'")


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


def _attn_apply(p, cfg, x, *, window):
    if cfg.mla is not None:
        return L.mla_apply(p, cfg, x)
    return L.gqa_apply(p, cfg, x, window=window)


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
                moe_cf: float = 1.25):
    """Full-sequence block. Returns (x, aux); aux carries the MoE layer's
    statistics and is empty without one."""
    if kind == "mamba":
        h = L.apply_norm(cfg.norm, p["norm"], x)
        return x + M.mamba_apply(p["mixer"], cfg, h), {}
    if kind == "hybrid":
        h = L.apply_norm(cfg.norm, p["ln1"], x)
        a = L.gqa_apply(p["attn"], cfg, h, window=window)
        s = M.mamba_apply(p["ssm"], cfg, h)
        return hybrid_ffn(p, cfg, x, a, s), {}
    h = L.apply_norm(cfg.norm, p["ln1"], x)
    attn_out = _attn_apply(p["attn"], cfg, h, window=window)
    if cfg.parallel_block:
        return x + attn_out + L.mlp_apply(p["mlp"], cfg, h), {}
    x = x + attn_out
    h2 = L.apply_norm(cfg.norm, p["ln2"], x)
    y, aux = ffn_apply(kind, p, cfg, h2, moe_cf=moe_cf)
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
              plain: bool = False):
    """A block's FFN: the MoE layer at capacity factor ``moe_cf`` (<= 0:
    no drop, as every serving path of the JAX package runs it), else the
    MLP. Returns (y, aux); aux is empty without MoE."""
    if kind in _MOE_KINDS:
        return MO.moe_apply(p["moe"], cfg, h, capacity_factor=moe_cf,
                            plain=plain)
    return L.mlp_apply(p["mlp"], cfg, h, plain=plain), {}


# ---------------------------------------------------------------------------
# Model init / forward
# ---------------------------------------------------------------------------
def _stack(dicts):
    return {k: (_stack([d[k] for d in dicts]) if isinstance(dicts[0][k], dict)
                else torch.stack([d[k] for d in dicts]))
            for k in dicts[0]}


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
    return params


def embed_tokens(cfg, params, tokens):
    return params["embed"][tokens]


def unembed(cfg, params, x):
    x = L.apply_norm(cfg.norm, params["final_norm"], x)
    if cfg.tie_embeddings:
        return torch.matmul(x, params["embed"].T.to(x.dtype))
    return qlinear.matmul(x, params["lm_head"])


def forward(cfg: ModelConfig, params, tokens, *, moe_cf: float = 1.25):
    """Full-sequence logits. tokens: (B, S). ``moe_cf``: the MoE layers'
    capacity factor (<= 0: no drop)."""
    return forward_unrolled(cfg, params, params_to_layer_list(cfg, params),
                            tokens, moe_cf=moe_cf)


# ---------------------------------------------------------------------------
# Unrolled (per-layer list) path — used by the serving engine for morphing
# ---------------------------------------------------------------------------
def _index(tree, r):
    return {k: (_index(v, r) if isinstance(v, dict) else v[r])
            for k, v in tree.items()}


def params_to_layer_list(cfg: ModelConfig, params) -> List[Tuple[str, Any]]:
    """Flatten segment params into [(kind, layer_params)] of length L
    (stacked tensors are indexed, so layer params are views)."""
    out = []
    for (pattern, reps), seg_p in zip(segment_plan(cfg), params["segments"]):
        for r in range(reps):
            for o, kind in enumerate(pattern):
                out.append((kind, _index(seg_p[o], r) if reps > 1
                            else seg_p[o]))
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
                     moe_cf: float = 1.25):
    x = embed_tokens(cfg, params, tokens)
    for i, (kind, lp) in enumerate(layer_list):
        x, _ = block_apply(kind, lp, cfg, x, window=layer_window(cfg, i),
                           moe_cf=moe_cf)
    return unembed(cfg, params, x)


def prefill_collect(cfg: ModelConfig, params, layer_list, tokens, *,
                    plain: bool = False):
    """Unrolled prefill returning (logits, [per-layer cache payload])."""
    x = embed_tokens(cfg, params, tokens)
    payloads = []
    for i, (kind, lp) in enumerate(layer_list):
        x, payload = block_prefill(kind, lp, cfg, x,
                                   window=layer_window(cfg, i), plain=plain)
        payloads.append(payload)
    return unembed(cfg, params, x), payloads
