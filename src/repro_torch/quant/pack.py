"""Bit-packing for INT8 / INT4 / INT3 weight tensors (torch).

Layout convention (the same as the JAX package and the wNa16 kernel):
  * quantization is **asymmetric, per-group along K** (the contraction dim)
  * ``q = clip(round(w / s) + z, 0, 2**bits - 1)`` stored unsigned
  * int8: (K, N) uint8
  * int4: (K//2, N) uint8 — low nibble = even k, high nibble = odd k
  * int3: (K//8, N) int32 — eight 3-bit fields per word (bits [3j, 3j+3)).
    The JAX package stores the word as uint32; the fields use 24 bits, so
    the int32 word holds the same bits (torch has no bitwise ops on uint32).
  * scales/zeros: (K // group, N) float32
"""
from __future__ import annotations

import torch

SUPPORTED_BITS = (8, 4, 3)


def quantize_groupwise(w: torch.Tensor, bits: int, group: int):
    """Quantize ``w`` (K, N) → (q uint8 (K, N), scales (K//g, N), zeros
    (K//g, N)). Asymmetric min/max per (group, column); ``zeros`` is the
    integer zero point, stored as float for exact dequant math."""
    K, N = w.shape
    if K % group:
        raise ValueError(f"K={K} not divisible by group={group}")
    qmax = 2**bits - 1
    wg = w.reshape(K // group, group, N)
    lo = wg.amin(dim=1)
    hi = wg.amax(dim=1)
    scale = torch.clamp((hi - lo) / qmax, min=1e-8).to(torch.float32)
    zero = torch.round(-lo / scale).clamp(0, qmax)
    q = torch.round(wg / scale[:, None, :] + zero[:, None, :]).clamp(0, qmax)
    return (q.reshape(K, N).to(torch.uint8), scale,
            zero.to(torch.float32))


def dequantize_groupwise(q, scale, zero, group: int, dtype=torch.float32):
    """Dequantize (..., K, N) with per-group (..., K//g, N) scales/zeros."""
    K, N = q.shape[-2], q.shape[-1]
    qg = q.reshape(*q.shape[:-2], K // group, group, N).to(torch.float32)
    w = (qg - zero[..., :, None, :]) * scale[..., :, None, :]
    return w.reshape(*q.shape[:-2], K, N).to(dtype)


# -- int4 ----------------------------------------------------------------------
# All pack/unpack functions operate on the last two dims (..., K, N).
def pack_int4(q):
    if q.shape[-2] % 2:
        raise ValueError("int4 packing needs an even K")
    lo = q[..., 0::2, :].to(torch.uint8)
    hi = q[..., 1::2, :].to(torch.uint8)
    return lo | (hi << 4)                                  # (..., K//2, N)


def unpack_int4(packed, K: int):
    lo = packed & 0xF
    hi = (packed >> 4) & 0xF
    out = torch.stack([lo, hi], dim=-2)
    return out.reshape(*packed.shape[:-2], K, packed.shape[-1])


# -- int3 ----------------------------------------------------------------------
def pack_int3(q):
    K, N = q.shape[-2], q.shape[-1]
    if K % 8:
        raise ValueError("int3 packing needs K divisible by 8")
    qg = q.reshape(*q.shape[:-2], K // 8, 8, N).to(torch.int32)
    word = torch.zeros((*q.shape[:-2], K // 8, N), dtype=torch.int32,
                       device=q.device)
    for j in range(8):
        word = word | (qg[..., j, :] << (3 * j))
    return word                                            # (..., K//8, N)


def unpack_int3(packed, K: int):
    parts = [((packed >> (3 * j)) & 0x7).to(torch.uint8) for j in range(8)]
    out = torch.stack(parts, dim=-2)
    return out.reshape(*packed.shape[:-2], K, packed.shape[-1])


# -- int8 ----------------------------------------------------------------------
def pack_int8(q):
    return q.to(torch.uint8)


def unpack_int8(packed, K: int):
    return packed


_PACK = {8: pack_int8, 4: pack_int4, 3: pack_int3}
_UNPACK = {8: unpack_int8, 4: unpack_int4, 3: unpack_int3}


def pack(q, bits: int):
    return _PACK[bits](q)


def unpack(packed, bits: int, K: int):
    return _UNPACK[bits](packed, K)


def packed_nbytes(K: int, N: int, bits: int, group: int,
                  scale_bytes: int = 4) -> int:
    """Device bytes of a packed (K, N) weight incl. scales+zeros."""
    if bits == 8:
        body = K * N
    elif bits == 4:
        body = K // 2 * N
    elif bits == 3:
        body = K // 8 * N * 4
    else:
        raise ValueError(bits)
    return body + 2 * (K // group) * N * scale_bytes
