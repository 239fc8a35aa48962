"""Carry the JAX package's parameters and pool contents into the port.

The two packages meet only through numpy arrays: a test turns JAX arrays
into numpy (``jax.tree.map(np.asarray, params)``) and this module turns the
result into the port's tensors, so the port never imports ``repro`` or
jax. A quantized leaf arrives as any object with the JAX ``QTensor``'s
fields — ``packed``, ``scales``, ``zeros``, ``inv_act`` as numpy arrays and
``bits``, ``group``, ``K``, ``N``, ``out_dtype``, ``use_kernel`` — and
becomes a :class:`~repro_torch.quant.QTensor`.
"""
from __future__ import annotations

import numpy as np
import torch

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
    if tree is None or isinstance(tree, (bool, int, float, str)):
        return tree
    return array_to_torch(tree, device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor (e.g. a pool's contents) as a float32-or-integer numpy
    array for the JAX side; bfloat16/float16 go through float32."""
    t = t.detach().cpu()
    if t.is_floating_point() and t.dtype != torch.float32:
        t = t.to(torch.float32)
    return t.numpy()
