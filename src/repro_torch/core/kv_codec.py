"""Shared KV block quantization codec.

One quantize/dequantize implementation used by every KV compression
consumer in the system:

- the paged pool's quantize-cold relief tier (affine per-(layer, block)
  params stored in the scale/zero sidecar, read back by the in-kernel
  dequant epilogue of the paged decode / chunk-prefill kernels),
- the prefix cache's requantize-on-hit path for cross-level reuse,
- the migration channel's wire compression (symmetric whole-tensor
  variant, preserving the original int8 wire format byte-for-byte).

int4 values are materialized in int8 storage (one value per byte) so
the same kernel dequant path serves both widths; `pack_int4` /
`unpack_int4` exist for wire transport where the 2x byte saving is
real.
"""

from __future__ import annotations

import numpy as np
import torch

# Smallest representable scale: keeps division safe for all-constant
# blocks (max == min) without distorting real dynamic ranges.
SCALE_EPS = 1e-8

QBITS_SUPPORTED = (8, 4)


def qmax_for_bits(bits: int) -> int:
    if bits not in QBITS_SUPPORTED:
        raise ValueError(f"unsupported kv-quant width: {bits} (want 8 or 4)")
    return (1 << (bits - 1)) - 1


def bytes_ratio(bits: int) -> float:
    """Stored-bytes ratio of a quantized value vs its fp16 original."""
    qmax_for_bits(bits)
    return bits / 16.0


# ---------------------------------------------------------------------------
# affine per-(layer, block) codec — pool sidecar format
# ---------------------------------------------------------------------------


def affine_quantize_np(x: np.ndarray, bits: int = 8):
    """Quantize `x` with one (scale, zero) pair per leading-2-axes slab.

    x: (L, n, *rest) float array — one param pair per (layer, block).
    Returns (q int8 same shape, scale (L, n) f32, zero (L, n) f32) with
    dequant defined as `q * scale + zero`.
    """
    qmax = qmax_for_bits(bits)
    xf = np.asarray(x, dtype=np.float32)
    red = tuple(range(2, xf.ndim))
    mx = xf.max(axis=red)
    mn = xf.min(axis=red)
    zero = (mx + mn) * 0.5
    scale = np.maximum((mx - mn) / (2.0 * qmax), SCALE_EPS)
    expand = (...,) + (None,) * len(red)
    q = np.clip(np.round((xf - zero[expand]) / scale[expand]), -qmax, qmax)
    return q.astype(np.int8), scale.astype(np.float32), zero.astype(np.float32)


def affine_dequantize_np(q: np.ndarray, scale: np.ndarray, zero: np.ndarray,
                         dtype=np.float32) -> np.ndarray:
    expand = (...,) + (None,) * (q.ndim - scale.ndim)
    out = q.astype(np.float32) * np.asarray(scale, np.float32)[expand]
    out = out + np.asarray(zero, np.float32)[expand]
    return out.astype(dtype)


def affine_quantize_torch(x: torch.Tensor, bits: int = 8):
    """torch twin of `affine_quantize_np` (same shapes and semantics), on
    ``x``'s device."""
    qmax = qmax_for_bits(bits)
    xf = x.to(torch.float32)
    red = tuple(range(2, xf.ndim))
    mx = xf.amax(dim=red)
    mn = xf.amin(dim=red)
    zero = (mx + mn) * 0.5
    scale = torch.clamp((mx - mn) / (2.0 * qmax), min=SCALE_EPS)
    expand = (...,) + (None,) * len(red)
    q = torch.clamp(torch.round((xf - zero[expand]) / scale[expand]),
                    -qmax, qmax)
    return q.to(torch.int8), scale, zero


def affine_dequantize_torch(q: torch.Tensor, scale: torch.Tensor,
                            zero: torch.Tensor, dtype=None) -> torch.Tensor:
    expand = (...,) + (None,) * (q.ndim - scale.ndim)
    out = q.to(torch.float32) * scale.to(torch.float32)[expand]
    out = out + zero.to(torch.float32)[expand]
    return out.to(dtype) if dtype is not None else out


# ---------------------------------------------------------------------------
# symmetric whole-tensor codec — migration wire format
# ---------------------------------------------------------------------------


def symmetric_quantize_np(x: np.ndarray):
    """One signed scale for the whole tensor, zero-point 0.

    This is the migration channel's historical int8 wire format: wire
    bytes are exactly `q.tobytes()` and the scale ships out of band, so
    counters and `compress_ratio()` are unchanged by the codec merge.
    """
    scale = float(np.max(np.abs(x.astype(np.float32))) / 127.0) or 1.0
    q = np.clip(np.round(x.astype(np.float32) / scale), -127, 127).astype(np.int8)
    return q, scale


def symmetric_dequantize_np(q: np.ndarray, scale: float, dtype) -> np.ndarray:
    return (q.astype(np.float32) * scale).astype(dtype)


# ---------------------------------------------------------------------------
# int4 wire packing (two values per byte; storage stays int8)
# ---------------------------------------------------------------------------


def pack_int4(q: np.ndarray) -> bytes:
    """Pack an int8 array of int4-range values into nibbles for the wire."""
    flat = np.asarray(q, np.int8).reshape(-1)
    if flat.size % 2:
        flat = np.concatenate([flat, np.zeros(1, np.int8)])
    u = (flat.astype(np.int16) & 0xF).astype(np.uint8)
    return ((u[0::2] << 4) | u[1::2]).tobytes()


def unpack_int4(blob: bytes, shape) -> np.ndarray:
    u = np.frombuffer(blob, dtype=np.uint8)
    hi = (u >> 4).astype(np.int8)
    lo = (u & 0xF).astype(np.int8)
    # sign-extend 4-bit two's complement
    hi = np.where(hi >= 8, hi - 16, hi)
    lo = np.where(lo >= 8, lo - 16, lo)
    n = int(np.prod(shape))
    out = np.empty(2 * u.size, np.int8)
    out[0::2] = hi
    out[1::2] = lo
    return out[:n].reshape(shape)
