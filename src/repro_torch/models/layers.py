"""Shared layer primitives of the dense decoders (GQA and DeepSeek's MLA),
in torch.

Every matmul goes through :func:`repro_torch.quant.qlinear.matmul`, so a
layer executes the same way whether its weights are dense or
MorphServe-swapped QTensors. Layouts follow the JAX package: weights are
(K, N) and used as ``x @ W``; attention tensors are (B, S, H, Dh).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.quant import qlinear


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
# Attention core
# ---------------------------------------------------------------------------
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
    if softcap:
        scores = torch.tanh(scores / softcap) * softcap
    q_offset = torch.as_tensor(q_offset, device=dev).reshape(-1)  # (1|B,)
    qpos = q_offset[:, None] + torch.arange(S, device=dev)[None, :]
    kpos = torch.arange(T, device=dev)
    mask = torch.ones((qpos.shape[0], S, T), dtype=torch.bool, device=dev)
    if causal:
        mask &= kpos[None, None, :] <= qpos[:, :, None]
    if window > 0:
        mask &= kpos[None, None, :] > qpos[:, :, None] - window
    if kv_len is not None:
        mask &= kpos[None, None, :] < kv_len[:, None, None]
    mask = mask[:, None, None]                           # (B|1,1,1,S,T)
    scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v.to(torch.float32))
    return out.to(q.dtype).reshape(B, S, H, v.shape[-1])


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


def gqa_prefill(p, cfg, x, *, window: int = 0, plain: bool = False):
    """Full-sequence causal GQA attention that also returns (k, v) for
    KV-cache capture. The JAX package switches to blockwise attention at
    S·T >= 2048·4096; the port keeps the materialized path, which computes
    the same function."""
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = gqa_project_qkv(p, cfg, x, positions, plain=plain)
    out = naive_attention(q, k, v, causal=True, window=window,
                          softcap=cfg.logit_softcap)
    y = qlinear.matmul(out.reshape(B, S, -1), p["wo"], bias=p.get("bo"),
                       plain=plain)
    return y, (k, v)


def gqa_apply(p, cfg, x, *, window: int = 0):
    """Full-sequence causal GQA attention (prefill)."""
    return gqa_prefill(p, cfg, x, window=window)[0]


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
    m = cfg.mla
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None, :]
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(p, cfg, x, positions,
                                            plain=plain)
    k_nope, v = _mla_expand_kv(p, cfg, c_kv, plain=plain)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope.expand(B, S, cfg.n_heads,
                                         m.qk_rope_head_dim)], dim=-1)
    out = naive_attention(q, k, v, causal=True)
    y = qlinear.matmul(out.reshape(B, S, -1), p["wo"], plain=plain)
    return y, torch.cat([c_kv, k_rope[:, :, 0, :]], dim=-1)


def mla_apply(p, cfg, x):
    """Full-sequence causal MLA attention (prefill)."""
    return mla_prefill(p, cfg, x)[0]


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
