"""Mamba-2 (SSD, state-space duality) block, in torch.

The JAX package's ``models/mamba.py``, function for function. The
full-sequence path is the chunked SSD algorithm (Dao & Gu,
arXiv:2405.21060 §6): a within-chunk quadratic term plus an inter-chunk
recurrence, here a Python loop over chunks where JAX has ``lax.scan``
(differentiable when a gradient is wanted). The
decode path is the O(1) recurrent update. Both share parameters.

Layout: ``in_proj`` emits [z, x, B, C, dt]; a depthwise causal conv over
(x, B, C); heads H = d_inner / head_dim; A is one scalar a head (the
Mamba-2 restriction). ``in_proj`` and ``out_proj`` go through
:func:`repro_torch.quant.qlinear.matmul`, so a swapped layer runs them on
the wNa16 kernel. The scan runs in float32, as in JAX: the conv's output
(x, B, C), dt, and the state. The conv is written as shifted sums in the
activation dtype, as JAX writes it, not as a cuDNN convolution (which
takes float32 inputs in TF32 by default).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import apply_norm, dense_init, norm_init
from repro_torch.quant import qlinear


def _dims(cfg):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.head_dim
    conv_ch = d_inner + 2 * s.n_groups * s.d_state
    return d_inner, n_heads, conv_ch


def mamba_init(gen: torch.Generator, cfg, dtype):
    """The JAX package's shapes and dtypes (``dt_bias``, ``A_log`` and
    ``D`` in float32), drawn from ``gen`` on its device."""
    s = cfg.ssm
    D = cfg.d_model
    d_inner, H, conv_ch = _dims(cfg)
    proj_out = 2 * d_inner + 2 * s.n_groups * s.d_state + H
    dev = gen.device
    in_proj = dense_init(gen, (D, proj_out), dtype=dtype)
    conv_w = dense_init(gen, (s.d_conv, conv_ch), scale=0.2, dtype=dtype)
    u = torch.rand((H,), generator=gen, device=dev, dtype=torch.float32)
    dt = torch.exp(math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3)))
    return {
        "in_proj": in_proj,
        "conv_w": conv_w,
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=dev),
        "dt_bias": dt + torch.log(-torch.expm1(-dt)),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, device=dev)),
        "D": torch.ones((H,), dtype=torch.float32, device=dev),
        "gnorm": norm_init("rmsnorm", d_inner, dtype, dev),
        "out_proj": dense_init(gen, (d_inner, D), dtype=dtype),
    }


def _split_proj(cfg, proj):
    s = cfg.ssm
    d_inner, H, _ = _dims(cfg)
    gN = s.n_groups * s.d_state
    return torch.split(proj, [d_inner, d_inner, gN, gN, H], dim=-1)


def _causal_conv(conv_w, conv_b, u):
    """Depthwise causal conv. u: (B, S, C); conv_w: (W, C)."""
    W, S = conv_w.shape[0], u.shape[1]
    pad = F.pad(u, (0, 0, W - 1, 0))
    out = pad[:, 0:S, :] * conv_w[0]
    for i in range(1, W):
        out = out + pad[:, i:i + S, :] * conv_w[i]
    return F.silu(out + conv_b)


def _heads(t, rep: int, dim: int):
    """Each group of ``t`` along ``dim`` repeated for its ``rep`` heads (the
    JAX ``jnp.repeat``), as a broadcast: ``torch.repeat_interleave`` would
    read its output size back from the device."""
    shape = list(t.shape)
    t = t.unsqueeze(dim + 1)
    grown = shape[:dim + 1] + [rep] + shape[dim + 1:]
    shape[dim] *= rep
    return t.expand(grown).reshape(shape)


def ssd_chunked(x, dt, A, Bm, Cm, *, chunk: int, init_state=None):
    """Chunked SSD scan.

    x: (b, s, h, p); dt: (b, s, h) (already softplus'd); A: (h,) negative;
    Bm, Cm: (b, s, g, n). Returns (y (b, s, h, p), final_state
    (b, h, p, n))."""
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    assert s % chunk == 0, (s, chunk)
    nc = s // chunk
    rep = h // g
    Bh = _heads(Bm, rep, 2)                               # (b, s, h, n)
    Ch = _heads(Cm, rep, 2)
    xc = x.reshape(b, nc, chunk, h, p)
    dtc = dt.reshape(b, nc, chunk, h)
    Bc = Bh.reshape(b, nc, chunk, h, n)
    Cc = Ch.reshape(b, nc, chunk, h, n)
    dA = dtc * A[None, None, None, :]                     # (b, nc, c, h) <= 0
    cum = torch.cumsum(dA, dim=2)                         # within a chunk

    # intra-chunk (quadratic) term: L[i, j] = exp(cum_i - cum_j), j <= i
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (b, nc, c, c, h)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=x.device))
    L = torch.where(mask[None, None, :, :, None], torch.exp(diff),
                    torch.zeros((), dtype=diff.dtype, device=x.device))
    scores = torch.einsum("bzihn,bzjhn->bzijh", Cc, Bc)
    M = scores * L
    y_intra = torch.einsum("bzijh,bzjhp->bzihp", M * dtc[:, :, None], xc)

    # chunk states and the inter-chunk recurrence
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)     # (b, nc, c, h)
    chunk_state = torch.einsum("bzchn,bzchp->bzhpn",
                               Bc * (dtc * decay_to_end)[..., None],
                               xc)                         # (b, nc, h, p, n)
    chunk_decay = torch.exp(torch.sum(dA, dim=2))         # (b, nc, h)
    # states[:, z]: the state entering chunk z; states[:, nc]: the final
    cs, cd = chunk_state.unbind(1), chunk_decay[..., None, None].unbind(1)
    s0 = (torch.zeros((b, h, p, n), dtype=x.dtype, device=x.device)
          if init_state is None else init_state)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, A, Bm, Cm, s0)):
        # autograd: each state a new tensor, stacked once
        st = [s0]
        for z in range(nc):
            st.append(torch.addcmul(cs[z], st[z], cd[z]))
        states = torch.stack(st, dim=1)
    else:
        # serving: written into one preallocated buffer (the same values)
        states = torch.empty((b, nc + 1, h, p, n), dtype=x.dtype,
                             device=x.device)
        states[:, 0] = s0
        st = states.unbind(1)
        for z in range(nc):
            torch.addcmul(cs[z], st[z], cd[z], out=st[z + 1])
    states_in, state = states[:, :nc], states[:, nc]

    y_inter = torch.einsum("bzchn,bzhpn->bzchp",
                           Cc * torch.exp(cum)[..., None], states_in)
    y = (y_intra + y_inter).reshape(b, s, h, p)
    return y, state


def ssd_chunk_len(cfg, S: int) -> int:
    """The scan's chunk for a sequence of S tokens (the JAX
    ``mamba_apply``'s rule): the config's chunk, or S if shorter, halved
    until it divides S, so an odd S past the chunk scans one token a
    chunk."""
    chunk = min(cfg.ssm.chunk_size, S)
    while S % chunk:
        chunk //= 2
    return chunk


def mamba_apply(p, cfg, x, *, init_state=None, return_state: bool = False,
                plain: bool = False):
    """Full-sequence Mamba-2 block. x: (B, S, D) -> (B, S, D); with
    ``return_state`` also {"conv": the last d_conv - 1 pre-conv inputs,
    "ssm": the final state}, both float32, for decode to continue from."""
    s = cfg.ssm
    B_, S, _ = x.shape
    d_inner, H, _ = _dims(cfg)
    gN = s.n_groups * s.d_state
    proj = qlinear.matmul(x, p["in_proj"], plain=plain)
    z, xin, Bc, Cc, dt = _split_proj(cfg, proj)
    conv_in = torch.cat([xin, Bc, Cc], dim=-1)
    conv_out = _causal_conv(p["conv_w"], p["conv_b"], conv_in)
    xin, Bc, Cc = torch.split(conv_out, [d_inner, gN, gN], dim=-1)
    f32 = torch.float32
    xh = xin.reshape(B_, S, H, s.head_dim).to(f32)
    Bm = Bc.reshape(B_, S, s.n_groups, s.d_state).to(f32)
    Cm = Cc.reshape(B_, S, s.n_groups, s.d_state).to(f32)
    dtv = F.softplus(dt.to(f32) + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    y, state = ssd_chunked(xh, dtv, A, Bm, Cm, chunk=ssd_chunk_len(cfg, S),
                           init_state=init_state)
    y = y + xh * p["D"][None, None, :, None]
    y = y.reshape(B_, S, d_inner).to(x.dtype)
    y = apply_norm("rmsnorm", p["gnorm"], y * F.silu(z))
    out = qlinear.matmul(y, p["out_proj"], plain=plain)
    if return_state:
        tail = conv_in[:, -(s.d_conv - 1):, :].to(f32)
        return out, {"conv": tail, "ssm": state}
    return out


def mamba_init_state(cfg, batch, dtype=torch.float32, device="cpu"):
    s = cfg.ssm
    _, H, conv_ch = _dims(cfg)
    return {
        "conv": torch.zeros((batch, s.d_conv - 1, conv_ch), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, H, s.head_dim, s.d_state), dtype=dtype,
                           device=device),
    }


def mamba_decode(p, cfg, x, state, *, plain: bool = False):
    """Single-token recurrent step. x: (B, 1, D); state: {"conv" (B,
    d_conv - 1, conv_ch), "ssm" (B, H, P, N)}, float32. Returns (out
    (B, 1, D), the new state)."""
    s = cfg.ssm
    B_, S, _ = x.shape
    assert S == 1
    d_inner, H, _ = _dims(cfg)
    gN = s.n_groups * s.d_state
    f32 = torch.float32
    proj = qlinear.matmul(x[:, 0], p["in_proj"], plain=plain)   # (B, proj)
    z, xin, Bc, Cc, dt = _split_proj(cfg, proj)
    conv_in = torch.cat([xin, Bc, Cc], dim=-1)                   # (B, conv_ch)
    conv_buf = torch.cat([state["conv"].to(f32),
                          conv_in[:, None].to(f32)], dim=1)
    conv_out = (conv_buf * p["conv_w"].to(f32)).sum(dim=1)
    conv_out = F.silu(conv_out + p["conv_b"].to(f32))
    xin, Bc, Cc = torch.split(conv_out, [d_inner, gN, gN], dim=-1)
    xh = xin.reshape(B_, H, s.head_dim)
    rep = H // s.n_groups
    Bm = _heads(Bc.reshape(B_, s.n_groups, s.d_state), rep, 1)
    Cm = _heads(Cc.reshape(B_, s.n_groups, s.d_state), rep, 1)
    dtv = F.softplus(dt.to(f32) + p["dt_bias"])                  # (B, H)
    A = -torch.exp(p["A_log"])
    dA = torch.exp(dtv * A[None, :])
    ssm = (state["ssm"] * dA[..., None, None]
           + (dtv[..., None] * xh)[..., None] * Bm[:, :, None, :])
    y = (ssm * Cm[:, :, None, :]).sum(-1)
    y = y + xh * p["D"][None, :, None]
    y = y.reshape(B_, d_inner).to(x.dtype)
    y = apply_norm("rmsnorm", p["gnorm"], y * F.silu(z))
    out = qlinear.matmul(y, p["out_proj"], plain=plain)[:, None]
    return out, {"conv": conv_buf[:, 1:], "ssm": ssm}
