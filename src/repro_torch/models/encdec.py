"""Whisper-style encoder-decoder backbone (audio frontend stubbed), in
torch.

The conv frontend is a stub: the caller passes precomputed frame
embeddings (B, n_frames, frontend_dim), and a linear adapter maps them into
the encoder. Encoder: bidirectional pre-LN transformer blocks over the
adapter's output plus sinusoidal positions. Decoder: causal self-attention,
cross-attention to the encoder states, then a GELU MLP (Whisper,
arXiv:2212.04356).

The parameter tree is the JAX package's, so the bridge carries it as it
is: {"adapter", "enc_blocks", "enc_norm", "embed", "dec_blocks",
"final_norm"}, the blocks stacked with a leading layer dim. The loops run
in Python over the stacked layers, reading a stacked QTensor per layer
through its 2-D view (``QTensor.expert``), so a kernel-flagged int4
decoder weight reaches the wNa16 route (``plain=True`` asks each such
matmul for its plain version). ``decode_step`` writes the new token's k/v
into the cache in place. The JAX package's choices stay, as
they are the reference: the encoder's self-attention applies rope on top
of the sinusoids, the decoder's positions are sinusoidal (not learned),
GELU is the tanh approximation, the cross-attention keys and values carry
no bias, and the head is tied to the embedding.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.lm import _index, _stack, torch_dtype
from repro_torch.quant import qlinear


def sinusoids(length: int, channels: int, device="cpu") -> torch.Tensor:
    """(length, channels) float32: sin then cos of each position over
    ``channels // 2`` geometric timescales from 1 to 10000."""
    f32 = dict(dtype=torch.float32, device=device)
    log_timescale = torch.log(torch.tensor(10000.0, **f32)) / \
        (channels // 2 - 1)
    inv = torch.exp(-log_timescale * torch.arange(channels // 2, **f32))
    ang = torch.arange(length, dtype=torch.float32,
                       device=device)[:, None] * inv[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=1)


def _enc_block_init(gen, cfg, dtype):
    dev = gen.device
    return {"ln1": L.norm_init(cfg.norm, cfg.d_model, dtype, dev),
            "attn": L.gqa_init(gen, cfg, dtype),
            "ln2": L.norm_init(cfg.norm, cfg.d_model, dtype, dev),
            "mlp": L.mlp_init(gen, cfg, dtype=dtype)}


def _dec_block_init(gen, cfg, dtype):
    dev = gen.device
    return {"ln1": L.norm_init(cfg.norm, cfg.d_model, dtype, dev),
            "self_attn": L.gqa_init(gen, cfg, dtype),
            "ln_x": L.norm_init(cfg.norm, cfg.d_model, dtype, dev),
            "cross_attn": L.gqa_init(gen, cfg, dtype),
            "ln2": L.norm_init(cfg.norm, cfg.d_model, dtype, dev),
            "mlp": L.mlp_init(gen, cfg, dtype=dtype)}


def init_params(cfg: ModelConfig, gen: torch.Generator) -> Dict[str, Any]:
    """Random parameters drawn from ``gen`` on ``gen.device`` in the config
    dtype: the encoder blocks, the decoder blocks, then the adapter and
    the embedding."""
    dtype = torch_dtype(cfg.dtype)
    enc = _stack([_enc_block_init(gen, cfg, dtype)
                  for _ in range(cfg.n_encoder_layers)])
    dec = _stack([_dec_block_init(gen, cfg, dtype)
                  for _ in range(cfg.n_layers)])
    dev = gen.device
    return {
        "adapter": {"w": L.dense_init(gen, (cfg.frontend_dim, cfg.d_model),
                                      dtype=dtype),
                    "b": torch.zeros((cfg.d_model,), dtype=dtype,
                                     device=dev)},
        "enc_blocks": enc,
        "enc_norm": L.norm_init(cfg.norm, cfg.d_model, dtype, dev),
        "embed": L.embed_init(gen, (cfg.vocab, cfg.d_model), dtype),
        "dec_blocks": dec,
        "final_norm": L.norm_init(cfg.norm, cfg.d_model, dtype, dev),
    }


def _layers(stacked, n: int):
    """The ``n`` per-layer trees of a stacked block tree."""
    return [_index(stacked, i) for i in range(n)]


def encode(cfg: ModelConfig, params, frames, *, plain: bool = False,
           ctx: L.ShardCtx = L.NO_SHARD):
    """frames: (B, n_frames, frontend_dim) → encoder states (B, T, D).
    ``ctx`` carries the attention layers' sharding hints."""
    x = qlinear.matmul(frames, params["adapter"]["w"],
                       bias=params["adapter"]["b"], plain=plain)
    x = x + sinusoids(x.shape[1], cfg.d_model, x.device).to(x.dtype)[None]
    for blk in _layers(params["enc_blocks"], cfg.n_encoder_layers):
        h = L.apply_norm(cfg.norm, blk["ln1"], x)
        x = x + L.gqa_apply(blk["attn"], cfg, h, causal=False, plain=plain,
                            ctx=ctx)
        h2 = L.apply_norm(cfg.norm, blk["ln2"], x)
        x = x + L.mlp_apply(blk["mlp"], cfg, h2, plain=plain)
    return L.apply_norm(cfg.norm, params["enc_norm"], x)


def _dec_cross_kv(cfg, blk, enc_states, plain: bool = False):
    """One decoder layer's cross-attention (k, v), (B, T, KVH, Dh) each,
    from the encoder states (no bias, as in the JAX package)."""
    B, T, _ = enc_states.shape
    KVH, Dh = cfg.n_kv_heads, cfg.resolved_head_dim
    k = qlinear.matmul(enc_states, blk["cross_attn"]["wk"], plain=plain)
    v = qlinear.matmul(enc_states, blk["cross_attn"]["wv"], plain=plain)
    return k.reshape(B, T, KVH, Dh), v.reshape(B, T, KVH, Dh)


def _tied_head(cfg, params, x):
    x = L.apply_norm(cfg.norm, params["final_norm"], x)
    return torch.matmul(x, params["embed"].T.to(x.dtype))


def decode_forward(cfg: ModelConfig, params, tokens, enc_states, *,
                   plain: bool = False, ctx: L.ShardCtx = L.NO_SHARD):
    """Teacher-forced decoder pass. tokens: (B, S) → logits (B, S, V)."""
    S = tokens.shape[1]
    x = params["embed"][tokens]
    x = x + sinusoids(S, cfg.d_model, x.device).to(x.dtype)[None]
    for blk in _layers(params["dec_blocks"], cfg.n_layers):
        h = L.apply_norm(cfg.norm, blk["ln1"], x)
        x = x + L.gqa_apply(blk["self_attn"], cfg, h, plain=plain, ctx=ctx)
        hx = L.apply_norm(cfg.norm, blk["ln_x"], x)
        x = x + L.gqa_apply(blk["cross_attn"], cfg, hx, plain=plain,
                            cross_kv=_dec_cross_kv(cfg, blk, enc_states,
                                                   plain), ctx=ctx)
        h2 = L.apply_norm(cfg.norm, blk["ln2"], x)
        x = x + L.mlp_apply(blk["mlp"], cfg, h2, plain=plain)
    return _tied_head(cfg, params, x)


def forward(cfg: ModelConfig, params, tokens, *, frontend=None,
            remat: bool = False, collect_aux: bool = False,
            plain: bool = False, ctx: L.ShardCtx = L.NO_SHARD):
    """Encode the frames ``frontend``, then the teacher-forced decoder.
    ``remat`` is taken and ignored, as the JAX package's ``forward``
    ignores it; ``collect_aux=True`` returns (logits, []) (no MoE)."""
    logits = decode_forward(cfg, params, tokens,
                            encode(cfg, params, frontend, plain=plain,
                                   ctx=ctx),
                            plain=plain, ctx=ctx)
    return (logits, []) if collect_aux else logits


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None, *,
               device="cuda"):
    """The decoder's cache on ``device``: self-attention k/v (L, B,
    max_seq, KVH, Dh), cross-attention k/v (L, B, encoder_seq, KVH, Dh)
    (zeros until ``start_cache``), and "pos" (B,) int32."""
    dtype = torch_dtype(dtype or cfg.dtype)
    Dh, KVH, L_ = cfg.resolved_head_dim, cfg.n_kv_heads, cfg.n_layers

    def zeros(T):
        return torch.zeros((L_, batch, T, KVH, Dh), dtype=dtype,
                           device=device)
    return {"self_k": zeros(max_seq), "self_v": zeros(max_seq),
            "cross_k": zeros(cfg.encoder_seq),
            "cross_v": zeros(cfg.encoder_seq),
            "pos": torch.zeros((batch,), dtype=torch.int32, device=device)}


def start_cache(cfg: ModelConfig, params, enc_states, cache, *,
                plain: bool = False):
    """Write every decoder layer's cross-attention k/v, computed from the
    encoder states, into the cache in place; returns the cache."""
    for i, blk in enumerate(_layers(params["dec_blocks"], cfg.n_layers)):
        k, v = _dec_cross_kv(cfg, blk, enc_states, plain)
        cache["cross_k"][i] = k
        cache["cross_v"][i] = v
    return cache


def decode_step(cfg: ModelConfig, params, cache, tokens, *,
                plain: bool = False):
    """Single-token decoder step. tokens: (B, 1). Each layer's new
    self-attention k/v row is written into the cache in place (through
    the layer's view of the stacked tensors). Returns (logits (B, 1, V),
    the cache with ``pos + 1``)."""
    pos = cache["pos"]
    x = params["embed"][tokens]
    # the position embedding at each sequence's own position
    tbl = sinusoids(cache["self_k"].shape[2], cfg.d_model, x.device)
    x = x + tbl[pos.long()][:, None].to(x.dtype)
    for i, blk in enumerate(_layers(params["dec_blocks"], cfg.n_layers)):
        h = L.apply_norm(cfg.norm, blk["ln1"], x)
        a, _ = L.gqa_decode(blk["self_attn"], cfg, h,
                            {"k": cache["self_k"][i],
                             "v": cache["self_v"][i], "pos": pos},
                            plain=plain)
        x = x + a
        hx = L.apply_norm(cfg.norm, blk["ln_x"], x)
        c, _ = L.gqa_decode(blk["cross_attn"], cfg, hx, {"pos": pos},
                            cross_kv=(cache["cross_k"][i],
                                      cache["cross_v"][i]), plain=plain)
        x = x + c
        h2 = L.apply_norm(cfg.norm, blk["ln2"], x)
        x = x + L.mlp_apply(blk["mlp"], cfg, h2, plain=plain)
    return _tied_head(cfg, params, x), dict(cache, pos=pos + 1)
