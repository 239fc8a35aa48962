"""Plain torch versions of the three kernels: the same functions, written
as gathers, dense masked softmax and ``torch.matmul`` in float32.

They are what a kernel route runs on a CPU tensor, what the CPU tests hold
against the JAX package, and what ``chip_smoke.py`` holds each CUDA kernel
against on the card.
"""
from __future__ import annotations

import torch

from repro_torch.quant import pack as packing


def wna16_ref(x, packed, scales, zeros, inv_act=None, bias=None, *,
              bits: int, group: int) -> torch.Tensor:
    """cast((x * inv_act) @ dequant(packed) + bias) with the dequant, the
    product and the epilogue in float32 (the math of the JAX package's
    ``_xla_packed_matmul`` in float32). x: (M, K) → (M, N) in x's dtype."""
    K = x.shape[-1]
    w = packing.dequantize_groupwise(packing.unpack(packed, bits, K),
                                     scales, zeros, group, torch.float32)
    xf = x.to(torch.float32)
    if inv_act is not None:
        xf = xf * inv_act.to(torch.float32)
    y = torch.matmul(xf, w)
    if bias is not None:
        y = y + bias.to(torch.float32)
    return y.to(x.dtype)


def _gather(pool, tables):
    """(cap, bs, KVH, Dh) pool, (B, nb) tables → (B, nb * bs, KVH, Dh)."""
    g = pool[tables.long()]
    B, nb, bs = g.shape[:3]
    return g.reshape(B, nb * bs, *g.shape[3:])


def paged_decode_ref(q, k_new, v_new, k_pool, v_pool, tables, lens, *,
                     scale=None, window: int = 0, softcap: float = 0.0,
                     fused_new: bool = True) -> torch.Tensor:
    """Gather + dense masked softmax; the function of ``paged_decode``.

    ``lens[b]`` tokens live in the pool. With ``fused_new`` the token
    (k_new, v_new) (B, KVH, Dh) sits at position ``lens[b]`` and is the
    query; otherwise the query is the pool token at ``lens[b] - 1``.
    ``window`` anchors at the query position; ``scale`` defaults to
    ``Dh ** -0.5``."""
    B, H, Dh = q.shape
    KVH = k_pool.shape[2]
    G = H // KVH
    k = _gather(k_pool, tables)
    v = _gather(v_pool, tables)
    T = k.shape[1]
    lens = lens.to(torch.int64)
    kpos = torch.arange(T, device=q.device).expand(B, T)
    mask = kpos < lens[:, None]
    if fused_new:
        k = torch.cat([k, k_new[:, None].to(k.dtype)], dim=1)
        v = torch.cat([v, v_new[:, None].to(v.dtype)], dim=1)
        kpos = torch.cat([kpos, lens[:, None]], dim=1)
        mask = torch.cat([mask, torch.ones_like(mask[:, :1])], dim=1)
        qpos = lens
    else:
        qpos = lens - 1
    if window > 0:
        mask &= kpos > (qpos[:, None] - window)
    qg = q.reshape(B, KVH, G, Dh).to(torch.float32)
    s = torch.einsum("bkgd,btkd->bkgt", qg, k.to(torch.float32))
    s = s * (Dh ** -0.5 if scale is None else scale)
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    s = torch.where(mask[:, None, None, :], s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", p, v.to(torch.float32))
    return out.reshape(B, H, Dh).to(q.dtype)


def paged_chunk_ref(q, k_new, v_new, k_pool, v_pool, tables, pos0: int, *,
                    scale=None, window: int = 0, softcap: float = 0.0,
                    fused_new: bool = True) -> torch.Tensor:
    """Gather + ``naive_attention``; the function of ``paged_chunk``.

    q (B, C, H, Dh) at positions ``pos0 + i``. Without ``fused_new`` the
    pool already holds the chunk's KV and query i sees every pool position
    ``<= pos0 + i`` (the JAX package's ``paged_chunk_gather_attention``).
    With ``fused_new`` the pool is read only below ``pos0`` and the chunk's
    (k_new, v_new) (B, C, KVH, Dh) take positions ``pos0 ..``."""
    from repro_torch.models.layers import naive_attention
    pos0 = int(pos0)
    gk = _gather(k_pool, tables)
    gv = _gather(v_pool, tables)
    if fused_new:
        gk = torch.cat([gk[:, :pos0], k_new.to(gk.dtype)], dim=1)
        gv = torch.cat([gv[:, :pos0], v_new.to(gv.dtype)], dim=1)
    return naive_attention(q, gk, gv, causal=True, q_offset=pos0,
                           window=window, softcap=softcap, scale=scale)
