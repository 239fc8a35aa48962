"""Carry the JAX package's parameters and pool contents into the port.

The two packages meet only through numpy arrays: a test turns JAX arrays
into numpy (``jax.tree.map(np.asarray, params)``) and this module turns the
result into the port's tensors, so the port never imports ``repro`` or
jax. A quantized leaf arrives as any object with the JAX ``QTensor``'s
fields — ``packed``, ``scales``, ``zeros``, ``inv_act`` as numpy arrays and
``bits``, ``group``, ``K``, ``N``, ``out_dtype``, ``use_kernel`` — and
becomes a :class:`~repro_torch.quant.QTensor`, 2-D or a stack of MoE
experts (3-D ``packed``/``scales``/``zeros``). A JAX ``PagedKVPool``'s
device state (fp pools, quantized-KV sidecar, ``qbits``) crosses with
:func:`copy_pool_state`, a JAX engine's per-slot SSM state
(``ssm_conv``/``ssm_ssm``) with :func:`copy_ssm_state`, a JAX optimizer
state with :func:`to_opt_state`. 0-d arrays (a hybrid layer's
``beta_a``/``beta_s``, an optimizer's step) become 0-d tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.optim import OptState
from repro_torch.quant import QTensor

_QT_FIELDS = ("packed", "scales", "zeros", "bits", "group", "K", "N")


def array_to_torch(a, device="cuda") -> torch.Tensor:
    """numpy (or numpy-convertible) array → tensor on ``device``.

    bfloat16 arrays (ml_dtypes) go through float32, which holds them
    exactly; uint32 words (the JAX int3 packing) become the int32 words the
    port stores, bit for bit."""
    a = np.asarray(a)
    name = a.dtype.name
    if name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(device,
                                                         torch.bfloat16)
    if name == "uint32":
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a, order="C")).to(device)


def dtype_to_torch(dt) -> torch.dtype:
    name = np.dtype(dt).name
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


def to_torch(tree, device="cuda"):
    """Convert a numpy param tree (dicts, lists, tuples, arrays, QTensor
    records) into the port's tree on ``device``; structure is preserved."""
    if isinstance(tree, dict):
        return {k: to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_torch(v, device) for v in tree)
    if all(hasattr(tree, f) for f in _QT_FIELDS):
        inv = getattr(tree, "inv_act", None)
        return QTensor(array_to_torch(tree.packed, device),
                       array_to_torch(tree.scales, device),
                       array_to_torch(tree.zeros, device),
                       bits=int(tree.bits), group=int(tree.group),
                       K=int(tree.K), N=int(tree.N),
                       out_dtype=dtype_to_torch(tree.out_dtype),
                       inv_act=None if inv is None
                       else array_to_torch(inv, device),
                       use_kernel=bool(getattr(tree, "use_kernel", False)))
    if tree is None or (isinstance(tree, (bool, int, float, str))
                        and not isinstance(tree, np.generic)):
        return tree
    return array_to_torch(tree, device)


def to_opt_state(state, device="cuda"):
    """A JAX ``OptState`` (``step``, ``m``, ``v`` as numpy-convertible
    trees) as the port's :class:`~repro_torch.optim.OptState` on
    ``device``. An error-feedback state of the int8 gradient compression
    is a plain tree: :func:`to_torch` carries it."""
    return OptState(array_to_torch(state.step, device),
                    to_torch(state.m, device), to_torch(state.v, device))


_POOL_STATE = ("k", "v", "qk", "qv", "k_scale", "v_scale", "k_zero",
               "v_zero")


def copy_pool_state(src, dst) -> None:
    """Give the port's pool ``dst`` the device state of ``src``, any object
    with the JAX ``PagedKVPool``'s fields as numpy-convertible arrays: the
    fp pools ``k``/``v``, the quantized-KV sidecar (int8 mirrors
    ``qk``/``qv``, float32 ``k_scale``/``v_scale``/``k_zero``/``v_zero``
    rows; None while ``src`` has none) and the ``qbits`` host map. The two
    pools must have the same shape; for an MLA latent pool ``k`` is the
    latent pool and ``v`` the (1,) placeholder on both sides. The allocator
    is not copied."""
    for name in ("k", "v"):
        a, t = getattr(src, name), getattr(dst, name)
        if tuple(np.shape(a)) != tuple(t.shape):
            raise ValueError(f"pool shapes differ ({name}): {np.shape(a)} "
                             f"vs {tuple(t.shape)}")
    for name in _POOL_STATE:
        a = getattr(src, name)
        t = None if a is None else array_to_torch(a, dst.device)
        if name in ("k", "v"):
            t = t.to(dst.dtype)
        setattr(dst, name, t)
    dst.qbits = dict(src.qbits)


def copy_ssm_state(src, dst) -> None:
    """Give the port's engine ``dst`` the per-slot SSM state of ``src``,
    any object with the JAX engine's ``ssm_conv`` (n_ssm, slots, d_conv -
    1, conv_ch) and ``ssm_ssm`` (n_ssm, slots, H, P, N) as
    numpy-convertible float32 arrays, copied into ``dst``'s tensors in
    place."""
    for name in ("ssm_conv", "ssm_ssm"):
        a, t = np.asarray(getattr(src, name)), getattr(dst, name)
        if tuple(a.shape) != tuple(t.shape):
            raise ValueError(f"state shapes differ ({name}): {a.shape} vs "
                             f"{tuple(t.shape)}")
        t.copy_(array_to_torch(a, t.device))


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor (e.g. a pool's contents) as a float32-or-integer numpy
    array for the JAX side; bfloat16/float16 go through float32."""
    t = t.detach().cpu()
    if t.is_floating_point() and t.dtype != torch.float32:
        t = t.to(torch.float32)
    return t.numpy()
