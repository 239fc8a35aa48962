"""Shared layer primitives of the model zoo (GQA, DeepSeek's MLA, the
MLPs), in torch.

Every matmul goes through :func:`repro_torch.quant.qlinear.matmul`, so a
layer executes the same way whether its weights are dense or
MorphServe-swapped QTensors. Layouts follow the JAX package: weights are
(K, N) and used as ``x @ W``; attention tensors are (B, S, H, Dh).

Full-sequence attention goes through :func:`attention_core`, which picks
the materialized, the blockwise (flash-style, online softmax) or the
windowed path by the JAX package's rule and knobs
(``repro_torch.launch.knobs``). ``gqa_decode`` and ``mla_decode`` are the
single-token steps over a contiguous (B, Tmax, ...) cache, which they
write in place, that the model API's ``decode_step`` runs; the serving
engine decodes over its paged pool instead (``engine/model_exec.py``).
All of it is plain torch, as it is plain JAX in the reference; a layer's
``plain=True`` asks each quantized matmul for its kernel's plain version.

Sharding: model code is mesh-agnostic. A :class:`ShardCtx` carries the
JAX package's ``with_sharding_constraint`` hints at the same call sites
(the embedding output, the attention outputs, the MoE dispatch buffers,
the train loss's logits). Without mesh axes (one card, the CPU) a hint
returns its tensor untouched; under the dry run it is handed to the
analysis, which records it and reshards in its model of the mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.nn.functional as F

from repro_torch.launch import knobs
from repro_torch.quant import qlinear


# ---------------------------------------------------------------------------
# Sharding context
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """The mesh axes a hint names. ``sink`` is the dry run's analysis
    (``launch.step_analysis``): ``sink.constrain(x, spec, site)`` records
    the hint and returns ``x``. A context without axes, or without a sink,
    leaves every tensor as it is."""
    data_axis: Optional[str] = None
    model_axis: Optional[str] = None
    sink: Any = dataclasses.field(default=None, compare=False, repr=False)

    def constrain(self, x, spec, site: str = ""):
        """``x``, laid out as ``spec`` (per dim an axis name, a tuple of
        names or None) on the mesh; ``site`` names the call site."""
        if self.data_axis is None and self.model_axis is None:
            return x
        if self.sink is None:
            return x
        return self.sink.constrain(x, tuple(spec), site)

    def ax(self, name):
        return {"data": self.data_axis, "model": self.model_axis}[name]


NO_SHARD = ShardCtx()


# ---------------------------------------------------------------------------
# Init helpers (every draw comes from the caller's generator, on its device)
# ---------------------------------------------------------------------------
def dense_init(gen: torch.Generator, shape, scale=None,
               dtype=torch.float32) -> torch.Tensor:
    fan_in = shape[-2] if len(shape) >= 2 else shape[0]
    scale = scale if scale is not None else fan_in ** -0.5
    w = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (w * scale).to(dtype)


def embed_init(gen: torch.Generator, shape, dtype=torch.float32):
    w = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (w * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
def norm_init(kind: str, dim: int, dtype=torch.float32, device="cpu"):
    if kind == "rmsnorm":
        return {"scale": torch.ones((dim,), dtype=dtype, device=device)}
    if kind == "layernorm":
        return {"scale": torch.ones((dim,), dtype=dtype, device=device),
                "bias": torch.zeros((dim,), dtype=dtype, device=device)}
    if kind == "nonparam_ln":           # OLMo: LN without affine params
        return {}
    raise ValueError(kind)


def apply_norm(kind: str, params, x: torch.Tensor, eps: float = 1e-5):
    xf = x.to(torch.float32)
    if kind == "rmsnorm":
        y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
        return (y * params["scale"].to(torch.float32)).to(x.dtype)
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mean) ** 2, dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    if kind == "layernorm":
        y = (y * params["scale"].to(torch.float32)
             + params["bias"].to(torch.float32))
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope_freqs(dim: int, theta: float, device="cpu"):
    ar = torch.arange(0, dim, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (ar / dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0, fraction: float = 1.0):
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    D = x.shape[-1]
    rot = int(D * fraction) // 2 * 2
    if rot == 0:
        return x
    xr, xp = x[..., :rot], x[..., rot:]
    freqs = rope_freqs(rot, theta, x.device)                 # (rot/2,)
    ang = positions[..., None].to(torch.float32) * freqs     # (..., S, rot/2)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(xr.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return torch.cat([out.to(x.dtype), xp], dim=-1)


# ---------------------------------------------------------------------------
# Attention cores
# ---------------------------------------------------------------------------
def _softcap(scores, cap):
    if cap:
        return torch.tanh(scores / cap) * cap
    return scores


def naive_attention(q, k, v, *, causal: bool, q_offset=0, window: int = 0,
                    kv_len=None, softcap: float = 0.0, scale: float = None):
    """Materialized-score attention.

    q: (B, S, H, D); k, v: (B, T, KVH, D). GQA via head grouping.
    ``q_offset``: absolute position of q[0] (int or (B,) tensor).
    ``kv_len``: (B,) valid kv length. ``window``: sliding window (0 = full).
    ``scale`` overrides the default ``D ** -0.5``.
    """
    B, S, H, D = q.shape
    T, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    dev = q.device
    qg = q.reshape(B, S, KVH, G, D).to(torch.float32)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k.to(torch.float32))
    scores = scores * (D ** -0.5 if scale is None else scale)
    scores = _softcap(scores, softcap)
    q_offset = torch.as_tensor(q_offset, device=dev).reshape(-1)  # (1|B,)
    qpos = q_offset[:, None] + torch.arange(S, device=dev)[None, :]
    kpos = torch.arange(T, device=dev)
    mask = torch.ones((qpos.shape[0], S, T), dtype=torch.bool, device=dev)
    if causal:
        mask = mask & (kpos[None, None, :] <= qpos[:, :, None])
    if window > 0:
        mask = mask & (kpos[None, None, :] > qpos[:, :, None] - window)
    if kv_len is not None:                  # (B,): broadcasts a (1, S, T) mask
        mask = mask & (kpos[None, None, :] < kv_len[:, None, None])
    mask = mask[:, None, None]                           # (B|1,1,1,S,T)
    scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v.to(torch.float32))
    return out.to(q.dtype).reshape(B, S, H, v.shape[-1])


def blockwise_attention(q, k, v, *, causal: bool, window: int = 0,
                        q_chunk: int = None, kv_chunk: int = None,
                        softcap: float = 0.0):
    """Flash-style blockwise attention: never materializes (S, T); peak
    activation is (B, KVH, G, q_chunk, kv_chunk). Online softmax over KV
    chunks in float32, as the JAX package's ``lax.scan`` does. The chunks
    default to ``knobs.KNOBS.q_chunk`` / ``kv_chunk`` and must divide S
    and T."""
    B, S, H, D = q.shape
    T, KVH = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    G = H // KVH
    q_chunk = min(q_chunk or knobs.KNOBS.q_chunk, S)
    kv_chunk = min(kv_chunk or knobs.KNOBS.kv_chunk, T)
    assert S % q_chunk == 0 and T % kv_chunk == 0
    f32, dev = torch.float32, q.device
    scale = D ** -0.5
    qg = q.reshape(B, S // q_chunk, q_chunk, KVH, G, D)
    kc = k.reshape(B, T // kv_chunk, kv_chunk, KVH, D)
    vc = v.reshape(B, T // kv_chunk, kv_chunk, KVH, Dv)
    outs = []
    for qi in range(S // q_chunk):
        qblk = qg[:, qi].to(f32)
        qpos = qi * q_chunk + torch.arange(q_chunk, device=dev)
        m = torch.full((B, KVH, G, q_chunk), -torch.inf, dtype=f32,
                       device=dev)
        l = torch.zeros((B, KVH, G, q_chunk), dtype=f32, device=dev)
        acc = torch.zeros((B, KVH, G, q_chunk, Dv), dtype=f32, device=dev)
        for ki in range(T // kv_chunk):
            kpos = ki * kv_chunk + torch.arange(kv_chunk, device=dev)
            s = torch.einsum("bqkgd,btkd->bkgqt", qblk,
                             kc[:, ki].to(f32)) * scale
            s = _softcap(s, softcap)
            msk = torch.ones((q_chunk, kv_chunk), dtype=torch.bool,
                             device=dev)
            if causal:
                msk &= kpos[None, :] <= qpos[:, None]
            if window > 0:
                msk &= kpos[None, :] > qpos[:, None] - window
            s = torch.where(msk, s, torch.full_like(s, -1e30))
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqt,btkd->bkgqd", p, vc[:, ki].to(f32))
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out.permute(0, 3, 1, 2, 4))          # (B, qc, KVH, G, Dv)
    return torch.cat(outs, dim=1).reshape(B, S, H, Dv).to(q.dtype)


def windowed_attention(q, k, v, *, window: int, q_chunk: int = 1024,
                       softcap: float = 0.0):
    """Sliding-window causal self-attention that only touches in-window
    KV: K and V are left-padded with ``window`` zero rows and each query
    chunk reads a (window + q_chunk) strip, so the work is proportional to
    S·(window + q_chunk) instead of S². As in the JAX package, the
    probabilities are cast to ``v.dtype`` before P·V."""
    B, S, H, D = q.shape
    T, KVH = k.shape[1], k.shape[2]
    assert S == T, "windowed path is for self-attention prefill"
    Dv = v.shape[-1]
    G = H // KVH
    q_chunk = min(q_chunk, S)
    while S % q_chunk:
        q_chunk //= 2
    strip = window + q_chunk
    kp = F.pad(k, (0, 0, 0, 0, window, 0))
    vp = F.pad(v, (0, 0, 0, 0, window, 0))
    dev = q.device
    # query i sits at strip position window + i; key strip position j maps
    # to the original position qs - window + j (padding where that is < 0)
    i = torch.arange(q_chunk, device=dev)[:, None]
    j = torch.arange(strip, device=dev)[None, :]
    causal_win = (j <= window + i) & (j > i)
    outs = []
    for qs in range(0, S, q_chunk):
        qgk = q[:, qs:qs + q_chunk].reshape(B, q_chunk, KVH, G, D)
        kblk, vblk = kp[:, qs:qs + strip], vp[:, qs:qs + strip]
        s = torch.einsum("bqkgd,btkd->bkgqt", qgk.to(torch.float32),
                         kblk.to(torch.float32)) * (D ** -0.5)
        s = _softcap(s, softcap)
        msk = causal_win & (j >= max(window - qs, 0))
        s = torch.where(msk, s, torch.full_like(s, -1e30))
        p = torch.softmax(s, dim=-1)
        out = torch.einsum("bkgqt,btkd->bqkgd", p.to(v.dtype), vblk)
        outs.append(out.reshape(B, q_chunk, H, Dv))
    return torch.cat(outs, dim=1).to(q.dtype)


def attention_core(q, k, v, *, causal: bool, q_offset=0, window: int = 0,
                   kv_len=None, softcap: float = 0.0):
    """The JAX package's choice of the materialized, blockwise or windowed
    path: windowed for a windowed self-attention of at least 2048·4096
    scores and S >= 2·window (``knobs.KNOBS.windowed_attn``), blockwise
    for at least 2048·4096 scores with S and T multiples of 1024, else
    materialized."""
    S, T = q.shape[1], k.shape[1]
    long = kv_len is None and S * T >= 2048 * 4096
    if (knobs.KNOBS.windowed_attn and window > 0 and long and S == T
            and S >= 2 * window):
        return windowed_attention(q, k, v, window=window, softcap=softcap)
    if long and S % 1024 == 0 and T % 1024 == 0:
        return blockwise_attention(q, k, v, causal=causal, window=window,
                                   softcap=softcap)
    return naive_attention(q, k, v, causal=causal, q_offset=q_offset,
                           window=window, kv_len=kv_len, softcap=softcap)


def _write_rows(cache, new, pos):
    """Set row ``pos[b]`` of each sequence b of ``cache`` (B, Tmax, ...) to
    ``new[b, 0]`` in place, the write index clamped into the cache as
    ``lax.dynamic_update_slice`` clamps it; returns ``cache``."""
    rows = torch.arange(cache.shape[0], device=cache.device)
    at = torch.clamp(pos.long(), 0, cache.shape[1] - 1)
    cache[rows, at] = new[:, 0].to(cache.dtype)
    return cache


# ---------------------------------------------------------------------------
# GQA attention layer
# ---------------------------------------------------------------------------
def gqa_init(gen, cfg, dtype):
    D, H, KVH = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    Dh = cfg.resolved_head_dim
    p = {
        "wq": dense_init(gen, (D, H * Dh), dtype=dtype),
        "wk": dense_init(gen, (D, KVH * Dh), dtype=dtype),
        "wv": dense_init(gen, (D, KVH * Dh), dtype=dtype),
        "wo": dense_init(gen, (H * Dh, D), dtype=dtype),
    }
    z = dict(dtype=dtype, device=gen.device)
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((H * Dh,), **z)
        p["bk"] = torch.zeros((KVH * Dh,), **z)
        p["bv"] = torch.zeros((KVH * Dh,), **z)
    if cfg.attn_out_bias:
        p["bo"] = torch.zeros((D,), **z)
    return p


def gqa_project_qkv(p, cfg, x, positions, plain: bool = False):
    B, S, _ = x.shape
    H, KVH, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    # qkv biases ride the matmul epilogue (fused into the wNa16 kernel on
    # the quantized path)
    mm = (lambda w, b: qlinear.matmul(x, p[w], bias=p.get(b), plain=plain))
    q = mm("wq", "bq").reshape(B, S, H, Dh)
    k = mm("wk", "bk").reshape(B, S, KVH, Dh)
    v = mm("wv", "bv").reshape(B, S, KVH, Dh)
    q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_fraction)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.rope_fraction)
    return q, k, v


def gqa_prefill(p, cfg, x, *, window: int = 0, causal: bool = True,
                plain: bool = False):
    """Full-sequence GQA attention through :func:`attention_core` that
    also returns (k, v) for KV-cache capture."""
    B, S, _ = x.shape
    out, kv = _gqa_attend(p, cfg, x, window, causal, plain)
    y = qlinear.matmul(out.reshape(B, S, -1), p["wo"], bias=p.get("bo"),
                       plain=plain)
    return y, kv


def _gqa_attend(p, cfg, x, window, causal, plain):
    """Self-attention before the output projection: (out (B, S, H, Dh),
    (k, v))."""
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    q, k, v = gqa_project_qkv(p, cfg, x, positions, plain=plain)
    out = attention_core(q, k, v, causal=causal, window=window,
                         softcap=cfg.logit_softcap)
    return out, (k, v)


def _cross_q(p, cfg, x, plain: bool = False):
    """The query of a cross-attention: projected, no rope."""
    B, S, _ = x.shape
    q = qlinear.matmul(x, p["wq"], bias=p.get("bq"), plain=plain)
    return q.reshape(B, S, cfg.n_heads, cfg.resolved_head_dim)


def gqa_apply(p, cfg, x, *, window: int = 0, cross_kv=None,
              causal: bool = True, plain: bool = False,
              ctx: ShardCtx = NO_SHARD):
    """Full-sequence GQA attention (train / prefill). ``cross_kv``: (k, v)
    from an encoder for cross-attention (no rope, no mask). The attention
    output (B, S, H, Dh) is hinted batch over data, heads over model."""
    B, S, _ = x.shape
    if cross_kv is None:
        out, _ = _gqa_attend(p, cfg, x, window, causal, plain)
    else:
        k, v = cross_kv
        out = attention_core(_cross_q(p, cfg, x, plain), k, v, causal=False,
                             softcap=cfg.logit_softcap)
    out = ctx.constrain(out, (ctx.data_axis, None, ctx.model_axis, None),
                        "layers.gqa_apply")
    return qlinear.matmul(out.reshape(B, S, -1), p["wo"], bias=p.get("bo"),
                          plain=plain)


def gqa_decode(p, cfg, x, cache, *, window: int = 0, cross_kv=None,
               plain: bool = False):
    """Single-token decode over a contiguous KV cache.

    cache: {"k": (B, Tmax, KVH, Dh), "v": ..., "pos": (B,) int32}; x:
    (B, 1, D). Self-attention writes the new token's k/v at row ``pos``
    of the cache's own tensors (in place) and attends causally (within
    ``window``); with ``cross_kv`` = (k, v) the token attends to all of
    the encoder's keys and the cache keeps its k/v. Returns (y, the cache
    with ``pos + 1``)."""
    B, S, _ = x.shape
    assert S == 1
    pos = cache["pos"]
    if cross_kv is None:
        q, k, v = gqa_project_qkv(p, cfg, x, pos[:, None], plain=plain)
        ck = _write_rows(cache["k"], k, pos)
        cv = _write_rows(cache["v"], v, pos)
        out = naive_attention(q, ck, cv, causal=True, q_offset=pos,
                              window=window, softcap=cfg.logit_softcap)
    else:
        k, v = cross_kv
        out = naive_attention(_cross_q(p, cfg, x, plain), k, v,
                              causal=False, softcap=cfg.logit_softcap)
    return qlinear.matmul(out.reshape(B, 1, -1), p["wo"], bias=p.get("bo"),
                          plain=plain), dict(cache, pos=pos + 1)


# ---------------------------------------------------------------------------
# MLA attention (DeepSeek-V3)
# ---------------------------------------------------------------------------
def mla_init(gen, cfg, dtype):
    m = cfg.mla
    D, H = cfg.d_model, cfg.n_heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "w_dq": dense_init(gen, (D, m.q_lora_rank), dtype=dtype),
        "q_norm": norm_init("rmsnorm", m.q_lora_rank, dtype, gen.device),
        "w_uq": dense_init(gen, (m.q_lora_rank, H * qk), dtype=dtype),
        "w_dkv": dense_init(gen, (D, m.kv_lora_rank + m.qk_rope_head_dim),
                            dtype=dtype),
        "kv_norm": norm_init("rmsnorm", m.kv_lora_rank, dtype, gen.device),
        "w_ukv": dense_init(gen, (m.kv_lora_rank,
                                  H * (m.qk_nope_head_dim + m.v_head_dim)),
                            dtype=dtype),
        "wo": dense_init(gen, (H * m.v_head_dim, D), dtype=dtype),
    }


def _mla_qkv(p, cfg, x, positions, plain: bool = False):
    """x (B, S, D) → q_nope (B, S, H, nope), q_rope (B, S, H, rope), the
    normed latent c_kv (B, S, r) and the shared rotary key k_rope
    (B, S, 1, rope)."""
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.n_heads
    mm = (lambda a, w: qlinear.matmul(a, p[w], plain=plain))
    cq = apply_norm("rmsnorm", p["q_norm"], mm(x, "w_dq"))
    q = mm(cq, "w_uq").reshape(B, S, H,
                               m.qk_nope_head_dim + m.qk_rope_head_dim)
    q_nope, q_rope = torch.split(q, [m.qk_nope_head_dim,
                                     m.qk_rope_head_dim], dim=-1)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    c_kv, k_rope = torch.split(mm(x, "w_dkv"), [m.kv_lora_rank,
                                                m.qk_rope_head_dim], dim=-1)
    c_kv = apply_norm("rmsnorm", p["kv_norm"], c_kv)
    k_rope = apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)
    return q_nope, q_rope, c_kv, k_rope


def _mla_expand_kv(p, cfg, c_kv, plain: bool = False):
    """The latent c_kv (B, T, r) expanded to per-head (k_nope, v)."""
    m = cfg.mla
    B, T, _ = c_kv.shape
    kv = qlinear.matmul(c_kv, p["w_ukv"], plain=plain).reshape(
        B, T, cfg.n_heads, m.qk_nope_head_dim + m.v_head_dim)
    return torch.split(kv, [m.qk_nope_head_dim, m.v_head_dim], dim=-1)


def mla_prefill(p, cfg, x, *, plain: bool = False):
    """Full-sequence causal MLA attention (latent expanded to per-head K/V)
    that also returns the latent cache rows (B, S, r + rope)."""
    B, S, _ = x.shape
    out, c_kv, k_rope = _mla_attend(p, cfg, x, plain)
    y = qlinear.matmul(out.reshape(B, S, -1), p["wo"], plain=plain)
    return y, torch.cat([c_kv, k_rope[:, :, 0, :]], dim=-1)


def _mla_attend(p, cfg, x, plain):
    """Causal MLA attention before the output projection: (out (B, S, H,
    v_head_dim), the latent c_kv, the rotary key k_rope)."""
    m = cfg.mla
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None, :]
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(p, cfg, x, positions,
                                            plain=plain)
    k_nope, v = _mla_expand_kv(p, cfg, c_kv, plain=plain)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope.expand(B, S, cfg.n_heads,
                                         m.qk_rope_head_dim)], dim=-1)
    return attention_core(q, k, v, causal=True), c_kv, k_rope


def mla_apply(p, cfg, x, plain: bool = False, ctx: ShardCtx = NO_SHARD):
    """Full-sequence causal MLA attention (train / prefill), its attention
    output hinted as :func:`gqa_apply`'s."""
    B, S, _ = x.shape
    out = _mla_attend(p, cfg, x, plain)[0]
    out = ctx.constrain(out, (ctx.data_axis, None, ctx.model_axis, None),
                        "layers.mla_apply")
    return qlinear.matmul(out.reshape(B, S, -1), p["wo"], plain=plain)


def mla_decode(p, cfg, x, cache, *, absorbed: bool = True,
               plain: bool = False):
    """MLA decode over the contiguous latent cache {"latent": (B, Tmax,
    r + rope), "pos": (B,)}: the new latent row is written at ``pos`` (in
    place), then the token attends to the first ``pos + 1`` rows.
    ``absorbed`` scores against the latent through the absorbed weights
    (q_nope · W_uk, then W_uv on the context), in float32; otherwise the
    latent is expanded to per-head k/v. Returns (y, the cache with
    ``pos + 1``)."""
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.n_heads
    pos = cache["pos"]
    q_nope, q_rope, c_kv_new, k_rope_new = _mla_qkv(p, cfg, x, pos[:, None],
                                                    plain=plain)
    lat = _write_rows(cache["latent"],
                      torch.cat([c_kv_new, k_rope_new[:, :, 0, :]], dim=-1),
                      pos)
    cache = dict(cache, latent=lat, pos=pos + 1)
    c_kv, k_rope = torch.split(lat, [m.kv_lora_rank, m.qk_rope_head_dim],
                               dim=-1)
    T = c_kv.shape[1]
    kv_len = cache["pos"]
    f32 = torch.float32
    if absorbed:
        w = p["w_ukv"]
        w = (w.dequantize(f32) if qlinear.is_quantized(w) else w.to(f32))
        w = w.reshape(m.kv_lora_rank, H, m.qk_nope_head_dim + m.v_head_dim)
        wk, wv = w[..., :m.qk_nope_head_dim], w[..., m.qk_nope_head_dim:]
        q_abs = torch.einsum("bshd,rhd->bshr", q_nope.to(f32), wk)
        s = (torch.einsum("bshr,btr->bhst", q_abs, c_kv.to(f32))
             + torch.einsum("bshd,btd->bhst", q_rope.to(f32),
                            k_rope.to(f32)))
        s = s * (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
        live = torch.arange(T, device=x.device)[None, :] < kv_len[:, None]
        s = torch.where(live[:, None, None, :], s, torch.full_like(s, -1e30))
        ctx = torch.einsum("bhst,btr->bshr", torch.softmax(s, dim=-1),
                           c_kv.to(f32))
        out = torch.einsum("bshr,rhd->bshd", ctx, wv).to(x.dtype)
    else:
        k_nope, v = _mla_expand_kv(p, cfg, c_kv, plain=plain)
        q = torch.cat([q_nope, q_rope], dim=-1)
        k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
            B, T, H, m.qk_rope_head_dim)], dim=-1)
        out = naive_attention(q, k, v, causal=False, kv_len=kv_len)
    return qlinear.matmul(out.reshape(B, S, -1), p["wo"], plain=plain), cache


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------
_ACTS = {
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "sqrelu": lambda x: torch.square(F.relu(x)),
}


def mlp_init(gen, cfg, d_ff=None, dtype=torch.float32):
    D = cfg.d_model
    Fd = d_ff or cfg.d_ff
    p = {"w_up": dense_init(gen, (D, Fd), dtype=dtype),
         "w_down": dense_init(gen, (Fd, D), dtype=dtype)}
    if cfg.gated_mlp:
        p["w_gate"] = dense_init(gen, (D, Fd), dtype=dtype)
    if cfg.mlp_bias:
        p["b_up"] = torch.zeros((Fd,), dtype=dtype, device=gen.device)
        p["b_down"] = torch.zeros((D,), dtype=dtype, device=gen.device)
    return p


def mlp_apply(p, cfg, x, plain: bool = False):
    act = _ACTS[cfg.act]
    up = qlinear.matmul(x, p["w_up"], bias=p.get("b_up"), plain=plain)
    if "w_gate" in p:
        h = act(qlinear.matmul(x, p["w_gate"], plain=plain)) * up
    else:
        h = act(up)
    return qlinear.matmul(h, p["w_down"], bias=p.get("b_down"), plain=plain)
