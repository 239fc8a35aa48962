"""Paged attention on the card: the wrappers of ``csrc/paged_attention.cu``.

``paged_decode`` is the decode block walk (K2) and ``paged_chunk`` the
chunk-prefill block walk (K3), each in both modes: ``fused_new=True`` takes
the new token(s) as operands and reads only pool positions before them;
``fused_new=False`` reads everything from the pool. Both take only CUDA
tensors; their plain torch versions are ``paged_decode_ref`` and
``paged_chunk_ref`` in :mod:`repro_torch.kernels.ref`, and
:mod:`repro_torch.kernels.ops` picks by the tensor's device. Each wrapper's
``launches`` attribute counts the calls that launched its kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_SMEM_LIMIT = 48 * 1024
_MAX_DECODE_G = 8             # csrc kMaxG
_HEAD_DIMS = (32, 64, 128, 256)
_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def _lib():
    lib = build.load("paged_attention")
    if not lib.morph_paged_decode.argtypes:   # else pointers pass as int32
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.morph_paged_decode.argtypes = [p, i, p, p, i, p, p, p, p, p, i, i,
                                           i, i, i, i, f, i, f, i, p]
        lib.morph_paged_decode.restype = ctypes.c_int
        lib.morph_paged_chunk.argtypes = [p, i, p, p, i, p, p, p, i, p, i, i,
                                          i, i, i, i, i, f, i, f, i, p]
        lib.morph_paged_chunk.restype = ctypes.c_int
    return lib


def _check(cond: bool, what: str, msg: str) -> None:
    if not cond:
        raise ValueError(f"{what}: {msg}")


def _check_common(what, q, k_pool, v_pool, tables, k_new, v_new, new_shape):
    dev = q.device
    _check(q.dtype in _DTYPES and k_pool.dtype in _DTYPES, what,
           f"q {q.dtype} / pool {k_pool.dtype} (each takes {_DTYPES})")
    _check(k_pool.ndim == 4 and k_pool.shape == v_pool.shape, what,
           "pools must be (cap, bs, KVH, Dh) and alike")
    _check(k_pool.dtype == v_pool.dtype, what, "k/v pool dtypes differ")
    _check(tables.dtype == torch.int32 and tables.ndim == 2, what,
           "tables must be int32 (B, nb)")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("tables", tables), ("k_new", k_new), ("v_new", v_new)):
        if t is None:
            continue
        _check(t.device == dev, what, f"{name} is on {t.device}, q on {dev}")
        _check(t.is_contiguous(), what, f"{name} must be contiguous")
    _, bs, KVH, Dh = k_pool.shape
    H = q.shape[-2]
    _check(q.shape[-1] == Dh and Dh in _HEAD_DIMS, what,
           f"head dim {q.shape[-1]} (pool {Dh}; takes {_HEAD_DIMS})")
    _check(H % KVH == 0, what, f"H={H} not a multiple of KVH={KVH}")
    if k_new is not None:
        _check(v_new is not None and tuple(k_new.shape) == new_shape
               and k_new.shape == v_new.shape, what,
               f"k_new/v_new must be {new_shape}")
        _check(k_new.dtype == k_pool.dtype and v_new.dtype == k_pool.dtype,
               what, "k_new/v_new must have the pool's dtype")
    return bs, KVH, Dh, H


def _check_device(what, q):
    _check(q.is_cuda, what, "q must be a CUDA tensor (the plain version in "
           "kernels/ref.py serves CPU tensors)")


def paged_decode(q, k_new, v_new, k_pool, v_pool, tables, lens, *,
                 scale: float, window: int = 0, softcap: float = 0.0,
                 fused_new: bool = True) -> torch.Tensor:
    """q (B, H, Dh); pools (cap, bs, KVH, Dh); tables (B, nb) int32; lens
    (B,) int32 pool tokens per sequence. With ``fused_new`` the token
    (k_new, v_new), each (B, KVH, Dh) in the pool dtype, sits at position
    ``lens[b]`` and is the query; otherwise the query is the pool token at
    ``lens[b] - 1``. Returns (B, H, Dh) in q's dtype."""
    what = "paged_decode"
    _check(q.ndim == 3, what, "q must be (B, H, Dh)")
    B = q.shape[0]
    if fused_new:
        _check(k_new is not None, what, "fused_new needs k_new/v_new")
    else:
        k_new = v_new = None
    bs, KVH, Dh, H = _check_common(what, q, k_pool, v_pool, tables, k_new,
                                   v_new, (B,) + tuple(k_pool.shape[2:]))
    _check(H // KVH <= _MAX_DECODE_G, what, f"G={H // KVH} > {_MAX_DECODE_G}")
    _check(tables.shape[0] == B, what, "tables must have B rows")
    _check(lens.dtype == torch.int32 and tuple(lens.shape) == (B,)
           and lens.device == q.device and lens.is_contiguous(), what,
           "lens must be int32 (B,) on q's device")
    _check_device(what, q)
    out = torch.empty_like(q)
    if B == 0:
        return out
    lib = _lib()
    ptr = (lambda t: None if t is None else t.data_ptr())
    with torch.cuda.device(q.device):
        rc = lib.morph_paged_decode(
            q.data_ptr(), build.dtype_code(q.dtype), k_pool.data_ptr(),
            v_pool.data_ptr(), build.dtype_code(k_pool.dtype), ptr(k_new),
            ptr(v_new), tables.data_ptr(), lens.data_ptr(), out.data_ptr(),
            B, H, KVH, Dh, bs, tables.shape[1], float(scale), int(window),
            float(softcap), int(fused_new),
            torch.cuda.current_stream(q.device).cuda_stream)
    build.check_rc(lib, rc, what)
    paged_decode.launches += 1
    return out


def paged_chunk(q, k_new, v_new, k_pool, v_pool, tables, pos0: int, *,
                scale: float, window: int = 0, softcap: float = 0.0,
                fused_new: bool = True) -> torch.Tensor:
    """q (B, C, H, Dh): C queries at positions ``pos0 + i``; pools
    (cap, bs, KVH, Dh); tables (B, nb) int32 covering the positions read.
    With ``fused_new`` the chunk's (k_new, v_new), each (B, C, KVH, Dh) in
    the pool dtype, enter under the intra-chunk causal mask and the pool is
    read only below ``pos0``; otherwise the chunk's KV is read back from the
    pool. Returns (B, C, H, Dh) in q's dtype."""
    what = "paged_chunk"
    _check(q.ndim == 4, what, "q must be (B, C, H, Dh)")
    B, C = q.shape[:2]
    if fused_new:
        _check(k_new is not None, what, "fused_new needs k_new/v_new")
    else:
        k_new = v_new = None
    bs, KVH, Dh, H = _check_common(
        what, q, k_pool, v_pool, tables, k_new, v_new,
        (B, C, k_pool.shape[2], k_pool.shape[3]))
    _check(tables.shape[0] == B, what, "tables must have B rows")
    _check(2 * bs * Dh * 4 <= _SMEM_LIMIT, what,
           f"block {bs} x head dim {Dh} exceeds the staging buffer")
    pos0 = int(pos0)
    _check(pos0 >= 0, what, "pos0 must be >= 0")
    _check(pos0 + (0 if fused_new else C) <= tables.shape[1] * bs, what,
           "tables do not cover the positions read")
    _check_device(what, q)
    out = torch.empty_like(q)
    if B == 0 or C == 0:
        return out
    lib = _lib()
    ptr = (lambda t: None if t is None else t.data_ptr())
    with torch.cuda.device(q.device):
        rc = lib.morph_paged_chunk(
            q.data_ptr(), build.dtype_code(q.dtype), k_pool.data_ptr(),
            v_pool.data_ptr(), build.dtype_code(k_pool.dtype), ptr(k_new),
            ptr(v_new), tables.data_ptr(), pos0, out.data_ptr(), B, C, H, KVH,
            Dh, bs, tables.shape[1], float(scale), int(window),
            float(softcap), int(fused_new),
            torch.cuda.current_stream(q.device).cuda_stream)
    build.check_rc(lib, rc, what)
    paged_chunk.launches += 1
    return out


paged_decode.launches = 0
paged_chunk.launches = 0
