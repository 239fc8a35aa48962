"""Paged attention on the card: the wrappers of ``csrc/paged_attention.cu``
(``paged_decode``, the decode block walk K2) and ``csrc/paged_chunk.cu``
(``paged_chunk``, the chunk-prefill block walk K3 on tensor cores).

Each works in both modes: ``fused_new=True`` takes
the new token(s) as operands and reads only pool positions before them;
``fused_new=False`` reads everything from the pool. Both take only CUDA
tensors; their plain torch versions are ``paged_decode_ref`` and
``paged_chunk_ref`` in :mod:`repro_torch.kernels.ref`, and
:mod:`repro_torch.kernels.ops` picks by the tensor's device.

Both take the optional quantized-KV bundle ``kv_quant=(qk, qv, k_scale,
v_scale, k_zero, v_zero)`` of one layer (int8 mirrors shaped like the pools,
float32 ``(cap,)`` scale/zero rows); with it the kernel's KVQ lane
dequantizes every visited pool block (K2-q, K3-q). Each wrapper counts the
calls that launched its kernel: ``launches`` those without a bundle,
``quant_launches`` those with one. ``paged_decode`` also counts them by
:func:`nb_bucket` of the table width, in ``launches_by_nb`` and
``quant_launches_by_nb``.

``paged_chunk_mla`` is K3's MLA latent mode (K3-mla, the wrapper of
``csrc/paged_attention_mla.cu``): one latent pool serves every query head,
scores span its full width and values are its first ``dv`` lanes. Its
plain version is ``paged_chunk_ref(..., dv=dv)`` with the latent pool as
both pools; it counts its launches in ``paged_chunk_mla.launches``.

The wrappers plan each launch with :mod:`repro_torch.kernels.plan`, which
says which widths and dtypes are built, so that what the kernels lack is
refused before the device check. The chunk walks size their own launch on
the C side; the decode walk executes the plan it is given
(``plan.decode_plan``: context splits, ring depth, shared-memory layout),
made from host integers only, so a decode launch reads no device value on
the host.
"""
from __future__ import annotations

import collections
import ctypes

import torch

from repro_torch.kernels import build, plan

_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# argtypes of each C entry point (else ctypes passes pointers as int32)
_ARGTYPES = {
    "morph_paged_decode": [_P, _I, _P, _P, _I, _P, _P, _P, _P, _P, _I, _I,
                           _I, _I, _I, _I, _I, _F, _I, _F, _I,
                           _P, _P, _P, _P, _P, _P,
                           ctypes.POINTER(plan.CDecodePlan), _P, _P, _P],
    "morph_paged_chunk": [_P, _I, _P, _P, _I, _P, _P, _P, _I, _P, _I, _I,
                          _I, _I, _I, _I, _I, _F, _I, _F, _I,
                          _P, _P, _P, _P, _P, _P, _P],
    "morph_paged_chunk_plan": [_I, _I, _I, _I, _P],
    "morph_paged_chunk_mla": [_P, _P, _I, _P, _P, _I, _P, _I, _I, _I, _I, _I,
                              _I, _I, _F, _I, _F, _I, _P],
    "morph_paged_chunk_mla_plan": [_I, _I, _I, _P],
}


def _lib(name: str):
    """The library of ``csrc/<name>.cu`` with its entry points typed."""
    lib = build.load(name)
    for fn_name, argtypes in _ARGTYPES.items():
        if hasattr(lib, fn_name) and not getattr(lib, fn_name).argtypes:
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def built_chunk_plan(q_dtype, kv_dtype, Dh: int, Dv: int, kvq: bool):
    """The plan the built library reports for one chunk instantiation:
    (dynamic shared bytes, key tile, mma passes of Q K^T, of P V, threads,
    row tile), for holding :mod:`plan` against the sources on the card."""
    out = (ctypes.c_int * 6)()
    if Dv == Dh:
        lib = _lib("paged_chunk")
        rc = lib.morph_paged_chunk_plan(build.dtype_code(q_dtype),
                                        build.dtype_code(kv_dtype), Dh,
                                        int(kvq), out)
    else:
        lib = _lib("paged_attention_mla")
        rc = lib.morph_paged_chunk_mla_plan(build.dtype_code(kv_dtype), Dh,
                                            Dv, out)
    build.check_rc(lib, rc, "chunk plan")
    return tuple(out)


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
    _check(q.shape[-1] == Dh and Dh in plan.HEAD_DIMS, what,
           f"head dim {q.shape[-1]} (pool {Dh}; takes {plan.HEAD_DIMS})")
    _check(H % KVH == 0, what, f"H={H} not a multiple of KVH={KVH}")
    if k_new is not None:
        _check(v_new is not None and tuple(k_new.shape) == new_shape
               and k_new.shape == v_new.shape, what,
               f"k_new/v_new must be {new_shape}")
        _check(k_new.dtype == k_pool.dtype and v_new.dtype == k_pool.dtype,
               what, "k_new/v_new must have the pool's dtype")
    return bs, KVH, Dh, H


def _check_kv_quant(what, kv_quant, k_pool):
    """The six sidecar operands of one layer as data pointers (six Nones
    without a bundle), after checking them against the pool."""
    if kv_quant is None:
        return (None,) * 6
    _check(len(kv_quant) == 6, what,
           "kv_quant is (qk, qv, k_scale, v_scale, k_zero, v_zero)")
    cap = k_pool.shape[0]
    for name, t in zip(("qk", "qv", "k_scale", "v_scale", "k_zero", "v_zero"),
                       kv_quant):
        mirror = name in ("qk", "qv")
        want = ((torch.int8, tuple(k_pool.shape)) if mirror
                else (torch.float32, (cap,)))
        _check((t.dtype, tuple(t.shape)) == want, what,
               f"{name} must be {want[0]} {want[1]}, not {t.dtype} "
               f"{tuple(t.shape)}")
        _check(t.device == k_pool.device, what,
               f"{name} is on {t.device}, the pool on {k_pool.device}")
        _check(t.is_contiguous(), what, f"{name} must be contiguous")
    return tuple(t.data_ptr() for t in kv_quant)


def _check_device(what, q):
    _check(q.is_cuda, what, "q must be a CUDA tensor (the plain version in "
           "kernels/ref.py serves CPU tensors)")


def _check_aligned(what, **tensors):
    """The walks copy rows by cp.async (16 bytes a copy) or TMA, both from
    16-byte aligned sources."""
    for name, t in tensors.items():
        if t is not None:
            _check(t.data_ptr() % 16 == 0, what,
                   f"{name} must start on a 16-byte boundary")


def _name(dtype) -> str:
    return str(dtype).replace("torch.", "")


# The decode walk's split counters, one int32 a (sequence, kv head) row, by
# (device index, stream): a launch leaves them 0 (the row's last split
# resets its own), so the launches of one stream share one buffer.
_DECODE_COUNTERS = {}


def _decode_counters(dev, stream: int, rows: int) -> torch.Tensor:
    key = (dev.index, stream)
    c = _DECODE_COUNTERS.get(key)
    if c is None or c.numel() < rows:
        c = torch.zeros(max(rows, 1024), dtype=torch.int32, device=dev)
        _DECODE_COUNTERS[key] = c
    return c


# upper table widths of the buckets of ``launches_by_nb``; above: ">64"
NB_BUCKETS = (1, 2, 4, 8, 16, 32, 64)


def nb_bucket(nb_t: int) -> str:
    """The ``launches_by_nb`` bucket of a decode launch whose block table
    is ``nb_t`` entries wide: the power of two at or above it (the engine
    buckets its tables to those)."""
    for top in NB_BUCKETS:
        if nb_t <= top:
            return str(top)
    return f">{NB_BUCKETS[-1]}"


def paged_decode(q, k_new, v_new, k_pool, v_pool, tables, lens, *,
                 scale: float, window: int = 0, softcap: float = 0.0,
                 fused_new: bool = True, kv_quant=None) -> torch.Tensor:
    """q (B, H, Dh); pools (cap, bs, KVH, Dh); tables (B, nb) int32; lens
    (B,) int32 pool tokens per sequence. With ``fused_new`` the token
    (k_new, v_new), each (B, KVH, Dh) in the pool dtype, sits at position
    ``lens[b]`` and is the query; otherwise the query is the pool token at
    ``lens[b] - 1``. ``kv_quant``: the layer's sidecar bundle (module
    docstring). Returns (B, H, Dh) in q's dtype."""
    what = "paged_decode"
    _check(q.ndim == 3, what, "q must be (B, H, Dh)")
    B = q.shape[0]
    if fused_new:
        _check(k_new is not None, what, "fused_new needs k_new/v_new")
    else:
        k_new = v_new = None
    bs, KVH, Dh, H = _check_common(what, q, k_pool, v_pool, tables, k_new,
                                   v_new, (B,) + tuple(k_pool.shape[2:]))
    _check(tables.shape[0] == B, what, "tables must have B rows")
    _check(lens.dtype == torch.int32 and tuple(lens.shape) == (B,)
           and lens.device == q.device and lens.is_contiguous(), what,
           "lens must be int32 (B,) on q's device")
    nb_t = tables.shape[1]
    kw = dict(B=B, H=H, KVH=KVH, Dh=Dh, bs=bs, nb_t=nb_t,
              q_dtype=_name(q.dtype), kv_dtype=_name(k_pool.dtype),
              window=int(window))
    if B:          # refuses what is not built, on any device
        plan.decode_plan(**kw)
    quant = _check_kv_quant(what, kv_quant, k_pool)
    _check_device(what, q)
    qk, qv = kv_quant[:2] if kv_quant is not None else (None, None)
    _check_aligned(what, k_pool=k_pool, v_pool=v_pool, qk=qk, qv=qv)
    out = torch.empty_like(q)
    if B == 0:
        return out
    p = plan.decode_plan(**kw, n_sm=build.sm_count(q.device.index or 0))
    lib = _lib("paged_attention")
    ptr = (lambda t: None if t is None else t.data_ptr())
    G = H // KVH
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        # the partials (m, l, acc) of the splits of rows that take several
        ws = torch.empty(B * KVH * p.splits * (G * Dh + 2 * G),
                         dtype=torch.float32, device=q.device)
        counters = _decode_counters(q.device, stream, B * KVH)
        rc = lib.morph_paged_decode(
            q.data_ptr(), build.dtype_code(q.dtype), k_pool.data_ptr(),
            v_pool.data_ptr(), build.dtype_code(k_pool.dtype), ptr(k_new),
            ptr(v_new), tables.data_ptr(), lens.data_ptr(), out.data_ptr(),
            B, H, KVH, Dh, bs, nb_t, k_pool.shape[0], float(scale),
            int(window), float(softcap), int(fused_new), *quant,
            ctypes.byref(plan.c_decode_plan(p)), ws.data_ptr(),
            counters.data_ptr(), stream)
    build.check_rc(lib, rc, what)
    if kv_quant is None:
        paged_decode.launches += 1
        paged_decode.launches_by_nb[nb_bucket(nb_t)] += 1
    else:
        paged_decode.quant_launches += 1
        paged_decode.quant_launches_by_nb[nb_bucket(nb_t)] += 1
    return out


def paged_chunk(q, k_new, v_new, k_pool, v_pool, tables, pos0: int, *,
                scale: float, window: int = 0, softcap: float = 0.0,
                fused_new: bool = True, kv_quant=None) -> torch.Tensor:
    """q (B, C, H, Dh): C queries at positions ``pos0 + i``; pools
    (cap, bs, KVH, Dh); tables (B, nb) int32 covering the positions read.
    With ``fused_new`` the chunk's (k_new, v_new), each (B, C, KVH, Dh) in
    the pool dtype, enter under the intra-chunk causal mask and the pool is
    read only below ``pos0``; otherwise the chunk's KV is read back from the
    pool. ``kv_quant``: the layer's sidecar bundle (module docstring); the
    chunk's own (k_new, v_new) are always fp. Returns (B, C, H, Dh) in q's
    dtype."""
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
    plan.chunk_plan(B=B, C=C, H=H, KVH=KVH, Dh=Dh, Dv=Dh,
                    q_dtype=_name(q.dtype), kv_dtype=_name(k_pool.dtype),
                    kvq=kv_quant is not None)
    pos0 = int(pos0)
    _check(pos0 >= 0, what, "pos0 must be >= 0")
    _check(pos0 + (0 if fused_new else C) <= tables.shape[1] * bs, what,
           "tables do not cover the positions read")
    quant = _check_kv_quant(what, kv_quant, k_pool)
    _check_device(what, q)
    qk, qv = kv_quant[:2] if kv_quant is not None else (None, None)
    _check_aligned(what, q=q, k_pool=k_pool, v_pool=v_pool, k_new=k_new,
                   v_new=v_new, qk=qk, qv=qv)
    out = torch.empty_like(q)
    if B == 0 or C == 0:
        return out
    lib = _lib("paged_chunk")
    ptr = (lambda t: None if t is None else t.data_ptr())
    with torch.cuda.device(q.device):
        rc = lib.morph_paged_chunk(
            q.data_ptr(), build.dtype_code(q.dtype), k_pool.data_ptr(),
            v_pool.data_ptr(), build.dtype_code(k_pool.dtype), ptr(k_new),
            ptr(v_new), tables.data_ptr(), pos0, out.data_ptr(), B, C, H, KVH,
            Dh, bs, tables.shape[1], float(scale), int(window),
            float(softcap), int(fused_new), *quant,
            torch.cuda.current_stream(q.device).cuda_stream)
    build.check_rc(lib, rc, what)
    if kv_quant is None:
        paged_chunk.launches += 1
    else:
        paged_chunk.quant_launches += 1
    return out


def paged_chunk_mla(q, latent_new, pool, tables, pos0: int, *, dv: int,
                    scale: float, window: int = 0, softcap: float = 0.0,
                    fused_new: bool = True) -> torch.Tensor:
    """K3's MLA latent mode. q (B, C, H, Dh) float32: the absorbed queries
    at positions ``pos0 + i``; pool (cap, bs, 1, Dh): the latent pool, read
    for keys over all Dh lanes and for values over the first ``dv``. With
    ``fused_new`` the chunk's own latent rows ``latent_new`` (B, C, 1, Dh)
    in the pool dtype enter under the intra-chunk causal mask and the pool
    is read only below ``pos0``; otherwise they are read back from the pool.
    Returns (B, C, H, dv) float32. Takes only the (Dh, dv) pairs and pool
    dtypes the kernel is built for, and raises for any other."""
    what = "paged_chunk_mla"
    _check(q.ndim == 4 and q.dtype == torch.float32, what,
           "q must be float32 (B, C, H, Dh)")
    B, C, H, Dh = q.shape
    _check(pool.ndim == 4 and pool.shape[2] == 1, what,
           "the latent pool must be (cap, bs, 1, Dh)")
    _check(pool.shape[3] == Dh, what,
           f"latent width: q {Dh}, pool {pool.shape[3]}")
    plan.chunk_plan(B=B, C=C, H=H, KVH=1, Dh=Dh, Dv=dv, q_dtype="float32",
                    kv_dtype=_name(pool.dtype), kvq=False)
    _check(tables.dtype == torch.int32 and tables.ndim == 2
           and tables.shape[0] == B, what, "tables must be int32 (B, nb)")
    if fused_new:
        _check(latent_new is not None
               and tuple(latent_new.shape) == (B, C, 1, Dh)
               and latent_new.dtype == pool.dtype, what,
               f"latent_new must be ({B}, {C}, 1, {Dh}) in the pool dtype")
    else:
        latent_new = None
    for name, t in (("q", q), ("pool", pool), ("tables", tables),
                    ("latent_new", latent_new)):
        if t is not None:
            _check(t.device == q.device, what,
                   f"{name} is on {t.device}, q on {q.device}")
            _check(t.is_contiguous(), what, f"{name} must be contiguous")
    bs = pool.shape[1]
    pos0 = int(pos0)
    _check(pos0 >= 0, what, "pos0 must be >= 0")
    _check(pos0 + (0 if fused_new else C) <= tables.shape[1] * bs, what,
           "tables do not cover the positions read")
    _check_device(what, q)
    _check_aligned(what, q=q, pool=pool, latent_new=latent_new)
    out = torch.empty((B, C, H, dv), dtype=q.dtype, device=q.device)
    if B == 0 or C == 0:
        return out
    lib = _lib("paged_attention_mla")
    with torch.cuda.device(q.device):
        rc = lib.morph_paged_chunk_mla(
            q.data_ptr(), pool.data_ptr(), build.dtype_code(pool.dtype),
            None if latent_new is None else latent_new.data_ptr(),
            tables.data_ptr(), pos0, out.data_ptr(), B, C, H, Dh, dv, bs,
            tables.shape[1], float(scale), int(window), float(softcap),
            int(fused_new), torch.cuda.current_stream(q.device).cuda_stream)
    build.check_rc(lib, rc, what)
    paged_chunk_mla.launches += 1
    return out


paged_decode.launches = paged_decode.quant_launches = 0
paged_decode.launches_by_nb = collections.Counter()
paged_decode.quant_launches_by_nb = collections.Counter()
paged_chunk.launches = paged_chunk.quant_launches = 0
paged_chunk_mla.launches = 0
