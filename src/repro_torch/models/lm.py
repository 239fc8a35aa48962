"""Decoder-only LM, DENSE family (the paper's Llama-2 evaluation models).

Parameters keep the JAX package's tree: ``{"embed", "final_norm",
"lm_head", "segments"}``, where ``segments`` holds one entry per maximal
run of a layer kind and each entry is a tuple of per-offset param dicts,
stacked with a leading repeat dim when the run repeats. The serving engine
works on the **unrolled** per-layer list (``params_to_layer_list``), where
each layer may independently be dense or quantized.

The other families (MoE, MLA, SSM/hybrid, enc-dec, VLM) are not ported
yet; they raise ``NotImplementedError`` naming ROADMAP queue 1.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from repro_torch.configs.base import DENSE, ModelConfig
from repro_torch.models import layers as L
from repro_torch.quant import qlinear

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name) -> torch.dtype:
    """The torch dtype of a config dtype name ("bfloat16", "float32")."""
    return name if isinstance(name, torch.dtype) else _DTYPES[str(name)]


def check_family(cfg: ModelConfig) -> None:
    if cfg.family != DENSE or cfg.mla is not None or cfg.moe is not None:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} (mla={cfg.mla is not None}, "
            f"moe={cfg.moe is not None}) is not ported to torch yet — "
            "ROADMAP.md queue 1, 'Other model families'")


# ---------------------------------------------------------------------------
# Layer-kind plan
# ---------------------------------------------------------------------------
def layer_kinds(cfg: ModelConfig) -> List[str]:
    check_family(cfg)
    return ["dense"] * cfg.n_layers


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
def block_init(kind: str, gen: torch.Generator, cfg: ModelConfig, dtype):
    p = {"ln1": L.norm_init(cfg.norm, cfg.d_model, dtype, gen.device),
         "attn": L.gqa_init(gen, cfg, dtype)}
    if not cfg.parallel_block:
        p["ln2"] = L.norm_init(cfg.norm, cfg.d_model, dtype, gen.device)
    p["mlp"] = L.mlp_init(gen, cfg, dtype=dtype)
    return p


def block_apply(kind: str, p, cfg: ModelConfig, x, *, window: int = 0,
                moe_cf: float = 1.25):
    """Full-sequence block. Returns (x, aux); aux is empty for DENSE."""
    h = L.apply_norm(cfg.norm, p["ln1"], x)
    attn_out = L.gqa_apply(p["attn"], cfg, h, window=window)
    if cfg.parallel_block:
        return x + attn_out + L.mlp_apply(p["mlp"], cfg, h), {}
    x = x + attn_out
    h2 = L.apply_norm(cfg.norm, p["ln2"], x)
    return x + L.mlp_apply(p["mlp"], cfg, h2), {}


def block_prefill(kind: str, p, cfg: ModelConfig, x, *, window: int = 0,
                  plain: bool = False):
    """Full-seq block that also returns this layer's {"k", "v"} payload."""
    h = L.apply_norm(cfg.norm, p["ln1"], x)
    attn_out, (k, v) = L.gqa_prefill(p["attn"], cfg, h, window=window,
                                     plain=plain)
    if cfg.parallel_block:
        y = L.mlp_apply(p["mlp"], cfg, h, plain=plain)
        return x + attn_out + y, {"k": k, "v": v}
    x = x + attn_out
    h2 = L.apply_norm(cfg.norm, p["ln2"], x)
    return x + L.mlp_apply(p["mlp"], cfg, h2, plain=plain), {"k": k, "v": v}


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


def forward(cfg: ModelConfig, params, tokens):
    """Full-sequence logits. tokens: (B, S)."""
    return forward_unrolled(cfg, params, params_to_layer_list(cfg, params),
                            tokens)


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


def forward_unrolled(cfg: ModelConfig, params, layer_list, tokens):
    x = embed_tokens(cfg, params, tokens)
    for i, (kind, lp) in enumerate(layer_list):
        x, _ = block_apply(kind, lp, cfg, x, window=layer_window(cfg, i))
    return unembed(cfg, params, x)


def prefill_collect(cfg: ModelConfig, params, layer_list, tokens, *,
                    plain: bool = False):
    """Unrolled prefill returning (logits, [per-layer {"k", "v"}])."""
    x = embed_tokens(cfg, params, tokens)
    payloads = []
    for i, (kind, lp) in enumerate(layer_list):
        x, payload = block_prefill(kind, lp, cfg, x,
                                   window=layer_window(cfg, i), plain=plain)
        payloads.append(payload)
    return unembed(cfg, params, x), payloads
