"""wNa16 GEMM on the card: the wrapper of ``csrc/wna16_gemm.cu``.

``wna16_gemm`` launches the hand-written CUDA kernel and takes only CUDA
tensors; its plain torch version is :func:`repro_torch.kernels.ref.wna16_ref`
and :mod:`repro_torch.kernels.ops` picks between the two by the tensor's
device. ``wna16_gemm.launches`` counts the calls that launched the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_SMEM_LIMIT = 48 * 1024
_BM = (1, 2, 4, 8, 16)
_COLS_PER_CTA = 512            # 128 threads x 4 columns


def _pick_bm(M: int) -> int:
    """Skinny M tile for decode, 16 rows for prefill."""
    for c in _BM:
        if M <= c:
            return c
    return _BM[-1]


def _pick_splits(M: int, N: int, n_groups: int, bm: int, n_sm: int):
    """Split K over about four CTAs per SM for a skinny M (enough loads in
    flight), two above 16 rows; each split covers whole quantisation
    groups. Returns (splits, groups_per_split)."""
    tiles = -(-N // _COLS_PER_CTA) * -(-M // bm)
    waves = 4 if M <= _BM[-1] else 2
    want = max(1, min(n_groups, -(-waves * n_sm // tiles)))
    gps = -(-n_groups // want)
    return -(-n_groups // gps), gps


def _lib():
    lib = build.load("wna16_gemm")
    fn = lib.morph_wna16_gemm
    if not fn.argtypes:      # ctypes would pass a Python int as a 32-bit int
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return lib


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"wna16_gemm: {msg}")


def wna16_gemm(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
               zeros: torch.Tensor, inv_act=None, bias=None, *, bits: int,
               group: int) -> torch.Tensor:
    """x (M, K) float32/bfloat16/float16 × packed int{4,8} weight → (M, N)
    in x's dtype. ``inv_act`` (K,) and ``bias`` (N,) are float32 or None."""
    dev = x.device
    _check(x.ndim == 2 and x.is_contiguous(), "x must be a contiguous (M, K)")
    _check(x.dtype in (torch.float32, torch.bfloat16, torch.float16),
           f"x dtype {x.dtype} (takes float32, bfloat16, float16)")
    M, K = x.shape
    _check(bits in (4, 8), f"bits={bits} (takes 4 or 8)")
    _check(group > 0 and K % group == 0, f"group={group} must divide K={K}")
    _check(bits == 8 or group % 2 == 0, "int4 needs an even group")
    _check(packed.dtype == torch.uint8, "packed must be uint8")
    N = packed.shape[-1]
    kp = K // 2 if bits == 4 else K
    _check(tuple(packed.shape) == (kp, N), f"packed {tuple(packed.shape)} "
           f"!= ({kp}, {N})")
    _check(N % 4 == 0, f"N={N} must be a multiple of 4")
    for name, t in (("scales", scales), ("zeros", zeros)):
        _check(t.dtype == torch.float32 and tuple(t.shape) == (K // group, N),
               f"{name} must be float32 ({K // group}, {N})")
    for name, t, n in (("inv_act", inv_act, K), ("bias", bias, N)):
        if t is not None:
            _check(t.dtype == torch.float32 and tuple(t.shape) == (n,),
                   f"{name} must be float32 ({n},)")
    for name, t in (("packed", packed), ("scales", scales), ("zeros", zeros),
                    ("inv_act", inv_act), ("bias", bias)):
        if t is not None:
            _check(t.device == dev, f"{name} is on {t.device}, x on {dev}")
            _check(t.is_contiguous(), f"{name} must be contiguous")
            _check(t.data_ptr() % 16 == 0 or not t.is_cuda,
                   f"{name} must be 16-byte aligned")
    bm = _pick_bm(M)
    _check(bm * group * 4 <= _SMEM_LIMIT, f"group={group} too large")
    _check(x.is_cuda, "x must be a CUDA tensor")
    out = torch.empty((M, N), dtype=x.dtype, device=dev)
    if M == 0:
        return out
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    splits, gps = _pick_splits(M, N, K // group, bm, n_sm)
    ws = torch.empty((splits, M, N), dtype=torch.float32, device=dev)
    lib = _lib()
    ptr = (lambda t: None if t is None else t.data_ptr())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.morph_wna16_gemm(
            x.data_ptr(), build.dtype_code(x.dtype), packed.data_ptr(),
            scales.data_ptr(), zeros.data_ptr(), ptr(inv_act), ptr(bias),
            out.data_ptr(), ws.data_ptr(), M, K, N, bits, group, bm, splits,
            gps, stream)
    build.check_rc(lib, rc, "wna16_gemm")
    wna16_gemm.launches += 1
    return out


wna16_gemm.launches = 0
