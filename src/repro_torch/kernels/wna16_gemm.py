"""wNa16 GEMM on the card: the launch planner and the wrapper of
``csrc/wna16_gemm.cu`` and ``csrc/wna16_gemm_narrow.cu`` (one kernel
template, ``csrc/wna16_gemm.cuh``: the first for an N whose packed rows are
multiples of 16 bytes, the second for any other N).

``wna16_gemm`` launches the hand-written tensor-core kernel and takes only
CUDA tensors; its plain torch version is
:func:`repro_torch.kernels.ref.wna16_ref` and :mod:`repro_torch.kernels.ops`
picks between the two by the tensor's device. :func:`plan` is the one
owner of a launch's plan (row tile, splits of K, mma passes, the
shared-memory ring and its bytes): the C side executes what it is given, and
the planner refuses what the kernel is not built for, on any device.
``wna16_gemm.launches`` counts the calls that launched the kernel and
``wna16_gemm.launches_by_shape`` the same calls by (K, N, :func:`m_bucket`
of M).
"""
from __future__ import annotations

import collections
import ctypes
import functools
from dataclasses import astuple, dataclass

import torch

from repro_torch.kernels import build

BN = 256                  # columns a CTA: four column warps of 64
GROUPS = (32, 64, 128)
BITS = (4, 8)
DTYPES = ("float32", "bfloat16", "float16")
SMEM_LIMIT = 232_448      # H100 opt-in dynamic shared memory a block
SMEM_SM = 233_472         # shared memory an SM holds; 1 KB a block is reserved
MAX_SPLITS = 8            # the portable cluster size
RED_STRIDE = BN + 4       # floats a row of the split-reduce tile
# a CTA's fixed cost (filling the ring, the cluster's reduction), in groups
SPLIT_FILL = 5
# (upper M, name) of the M buckets of ``launches_by_shape``; above the last:
# ">512"
M_BUCKETS = ((1, "1"), (8, "2-8"), (16, "9-16"), (64, "17-64"),
             (256, "65-256"), (512, "257-512"))
_ITEMSIZE = {"float32": 4, "bfloat16": 2, "float16": 2}


def m_bucket(M: int) -> str:
    """The M bucket of a launch with M rows (``launches_by_shape``)."""
    for top, name in M_BUCKETS:
        if M <= top:
            return name
    return ">512"


@dataclass(frozen=True)
class Plan:
    """One launch of the kernel; the fields up to ``smem`` are the C
    struct ``Wna16Plan``, in its order. Offsets and strides are bytes.
    ``pk_vec`` picks the build (16: ``wna16_gemm.cu``, else the narrow
    one), which derives the same widths from N."""
    bm: int                # rows of x a CTA: 8 or 16 (decode), 64
    splits: int            # CTAs along K a tile, one thread block cluster
    groups_per_split: int
    passes: int            # mma passes a k-step
    stages: int            # cp.async ring depth, in quantisation groups
    x_stride: int
    pk_stride: int
    off_pk: int
    off_s: int
    off_z: int
    off_inv: int
    stage_bytes: int
    smem: int
    pk_vec: int            # bytes a copy of a packed row: 16, 8, 4, 2, 1
    sz_vec: int            # bytes a copy of a scale / zero row: 16, 8, 4
    grid: tuple            # (N tiles, M tiles, splits)


class _CPlan(ctypes.Structure):
    _fields_ = [(f, ctypes.c_int) for f in Plan.__dataclass_fields__
                if f not in ("pk_vec", "sz_vec", "grid")]


def _refuse(msg: str) -> None:
    raise ValueError(f"wna16_gemm: {msg}")


@functools.lru_cache(maxsize=4096)
def plan(M: int, K: int, N: int, *, bits: int, group: int, x_dtype: str,
         inv_act: bool, n_sm: int = 132) -> Plan:
    """The launch of x (M, K) ``x_dtype`` × an int``bits`` (K, N) weight of
    quantisation ``group``, with or without ``inv_act``, on a card of
    ``n_sm`` SMs. Raises ValueError for what the kernel is not built for.

    Passes: the mma runs on x itself for bf16 / fp16 x (one pass), on two
    bf16 parts of x * inv_act for 16-bit x with inv_act, and on three for
    float32 x (exact). Rows: an 8- or 16-row decode tile (four warps, up to
    four CTAs an SM) up to M = 16, else 64 rows (eight warps, one CTA an
    SM). Splits: the power of two of K splits (at most ``MAX_SPLITS``, whole
    groups each: clusters of 3, 5, 6 or 7 CTAs measured slower) that
    minimises waves x (groups a CTA + ``SPLIT_FILL``) at the most CTAs an SM
    that hold two stages; ties take fewer splits. Stages: the deepest ring
    (at most four groups, and the groups a CTA walks plus one) whose shared
    memory still lets every CTA of the grid be resident at once, or as many
    as the most CTAs an SM allow. Columns: any N, as the TPU kernel takes;
    the last of the ceil(N / 256) column tiles holds the tail. Copies: a
    row of the packed weight (N bytes) or of the scales and zeros (4 N
    bytes) starts on a boundary of the largest power of two, at most 16,
    that divides its length, and the tile's 16-byte chunks of it are
    copied in pieces of that width (``pk_vec``, ``sz_vec``): cp.async
    takes 16, 8 and 4 bytes, plain loads 2 and 1."""
    if bits not in BITS:
        _refuse(f"bits={bits} is not built (takes {BITS})")
    if x_dtype not in DTYPES:
        _refuse(f"x dtype {x_dtype} is not built (takes {DTYPES})")
    if group not in GROUPS:
        _refuse(f"group={group} is not built (takes {GROUPS})")
    if K <= 0 or K % group:
        _refuse(f"group={group} must divide K={K}")
    if N <= 0:
        _refuse(f"N={N}: no columns")
    if M <= 0:
        _refuse(f"M={M}: nothing to launch")
    passes = 3 if x_dtype == "float32" else (2 if inv_act else 1)
    # CTAs an SM the kernel's registers allow: decode tiles (128 threads) up
    # to four, three with the split passes; prefill tiles (256) one
    if M <= 16:
        bm = 8 if M <= 8 else 16
        occupancy = (3, 2, 1) if passes > 1 else (4, 3, 2, 1)
    else:
        bm, occupancy = 64, (1,)
    size = _ITEMSIZE[x_dtype]
    # row paddings keep the 8 rows of an ldmatrix / the 4 rows of a packed
    # load on distinct banks
    x_stride = group * size + (32 if size == 4 else 16)
    pk_rows, pk_stride = (group // 2, BN + 32) if bits == 4 else (group, BN + 16)
    off_pk = bm * x_stride
    off_s = off_pk + pk_rows * pk_stride
    off_z = off_s + BN * 4
    off_inv = off_z + BN * 4
    stage_bytes = off_inv + (group * 4 if inv_act else 0)
    red = bm * RED_STRIDE * 4

    def depth(per_sm):            # stages (at most four) for per_sm CTAs an SM
        return min(4, min(SMEM_LIMIT, SMEM_SM // per_sm - 1024) // stage_bytes)

    per_sm = next((n for n in occupancy if depth(n) >= 2), 0)
    if not per_sm:
        _refuse(f"group={group} x {x_dtype} does not fit two stages")
    n_groups = K // group
    tiles = -(-N // BN) * -(-M // bm)
    best = None
    for s in (1, 2, 4, MAX_SPLITS):
        if s > n_groups:
            break
        gps = -(-n_groups // s)
        splits = -(-n_groups // gps)
        if splits & (splits - 1):
            continue
        cost = -(-tiles * splits // (n_sm * per_sm)) * (gps + SPLIT_FILL)
        if best is None or cost < best[0]:
            best = (cost, splits, gps)
    _, splits, gps = best
    # as deep a ring as the SMs this grid fills allow, at most the groups a
    # CTA walks (and the one in use)
    per_sm = min(per_sm, -(-tiles * splits // n_sm))
    stages = max(2, min(depth(per_sm), gps + 1))
    smem = max(stages * stage_bytes, red)
    pk_vec = min(16, N & -N)
    return Plan(bm=bm, splits=splits, groups_per_split=gps,
                passes=passes, stages=stages, x_stride=x_stride,
                pk_stride=pk_stride, off_pk=off_pk, off_s=off_s, off_z=off_z,
                off_inv=off_inv, stage_bytes=stage_bytes, smem=smem,
                pk_vec=pk_vec, sz_vec=min(16, 4 * pk_vec),
                grid=(-(-N // BN), -(-M // bm), splits))


@functools.lru_cache(maxsize=4096)
def _c_plan(p: Plan) -> _CPlan:
    return _CPlan(*astuple(p)[:len(_CPlan._fields_)])


def _entry(narrow: bool):
    """(library, C entry point) of the 16-byte or the narrow build."""
    name = "wna16_gemm_narrow" if narrow else "wna16_gemm"
    lib = build.load(name)
    fn = getattr(lib, "morph_" + name)
    if not fn.argtypes:      # ctypes would pass a Python int as a 32-bit int
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, p, p, p, p, p, p, i, i, i, i, i,
                       ctypes.POINTER(_CPlan), p]
        fn.restype = ctypes.c_int
    return lib, fn


def _check(cond: bool, msg: str) -> None:
    if not cond:
        _refuse(msg)


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
    _check(bits in BITS, f"bits={bits} (takes 4 or 8)")
    _check(packed.dtype == torch.uint8, "packed must be uint8")
    _check(group > 0 and K % group == 0, f"group={group} must divide K={K}")
    N = packed.shape[-1]
    kp = K // 2 if bits == 4 else K
    _check(tuple(packed.shape) == (kp, N), f"packed {tuple(packed.shape)} "
           f"!= ({kp}, {N})")
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
    x_dtype = str(x.dtype).replace("torch.", "")
    if M:       # refuses what is not built, on any device
        plan(M, K, N, bits=bits, group=group, x_dtype=x_dtype,
             inv_act=inv_act is not None)
    _check(x.is_cuda, "x must be a CUDA tensor")
    for name, t in (("x", x), ("packed", packed), ("scales", scales),
                    ("zeros", zeros), ("inv_act", inv_act), ("bias", bias)):
        if t is not None:
            _check(t.data_ptr() % 16 == 0, f"{name} must be 16-byte aligned")
    out = torch.empty((M, N), dtype=x.dtype, device=dev)
    if M == 0:
        return out
    p = plan(M, K, N, bits=bits, group=group, x_dtype=x_dtype,
             inv_act=inv_act is not None, n_sm=build.sm_count(dev.index or 0))
    lib, fn = _entry(p.pk_vec < 16)
    ptr = (lambda t: None if t is None else t.data_ptr())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(
            x.data_ptr(), build.dtype_code(x.dtype), packed.data_ptr(),
            scales.data_ptr(), zeros.data_ptr(), ptr(inv_act), ptr(bias),
            out.data_ptr(), M, K, N, bits, group, ctypes.byref(_c_plan(p)),
            stream)
    build.check_rc(lib, rc, "wna16_gemm")
    wna16_gemm.launches += 1
    wna16_gemm.launches_by_shape[K, N, m_bucket(M)] += 1
    return out


wna16_gemm.launches = 0
wna16_gemm.launches_by_shape = collections.Counter()
