"""INT8 gradient compression with error feedback, over the port's trees.

The JAX package's ``optim/compression.py``. Each worker quantizes its local
gradient to int8 (one absmax scale a leaf), all-reduces the payload
(summed in int32) and the scales, dequantizes with the mean scale, and
carries the quantization residual into the next step (error feedback
keeps the compressed SGD unbiased in the long run; Karimireddy et al.,
2019). Where JAX sums over a mesh axis with ``psum``,
:func:`allreduce_compressed` sums over a ``torch.distributed`` group.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.tree import leaves, tree_map, unflatten

F32 = torch.float32


def compress(g, err):
    """g, err: float tensors → (q int8, scale (0-d float32), new_err)."""
    gf = g.to(F32) + err
    scale = torch.max(torch.abs(gf)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    deq = q.to(F32) * scale
    return q, scale, gf - deq


def compress_tree(grads, err_state) -> Tuple[Any, Any, Any]:
    """(int8 payloads, scales, new error state), each with ``grads``'
    structure; ``err_state=None`` starts from zero error."""
    gl = leaves(grads)
    el = leaves(err_state) if err_state is not None \
        else [torch.zeros_like(g, dtype=F32) for g in gl]
    out = [compress(g, e) for g, e in zip(gl, el)]
    return tuple(unflatten(grads, [o[i] for o in out]) for i in range(3))


def decompress_tree(qs, scales):
    return tree_map(lambda q, s: q.to(F32) * s, qs, scales)


def allreduce_compressed(grads, err_state, group=None):
    """The mean of every worker's int8-compressed gradients over the
    ``torch.distributed`` group (the default group when None): int8
    payloads summed in int32 (no overflow for up to 2**23 workers), then
    dequantized with the mean scale. Returns (mean_grads, new_err_state);
    every worker of the group must call it with the same tree."""
    import torch.distributed as dist
    qs, scales, errs = compress_tree(grads, err_state)
    n = dist.get_world_size(group)
    mean = []
    for q, s in zip(leaves(qs), leaves(scales)):
        summed = q.to(torch.int32)
        dist.all_reduce(summed, group=group)
        total = s.clone()
        dist.all_reduce(total, group=group)
        mean.append(summed.to(F32) * (total / n) / n)
    return unflatten(grads, mean), errs


def init_error_state(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=F32,
                                          device=p.device), params)
