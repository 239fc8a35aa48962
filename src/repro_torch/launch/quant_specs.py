"""Quantized-parameter shapes for the all-int4 dry-run variant, the JAX
package's ``launch/quant_specs.py`` over the port's ``meta`` trees.

Every large 2-D / 3-D weight of a params tree becomes the port's packed
:class:`~repro_torch.quant.QTensor` on ``meta`` (the 'level = L' MorphServe
endpoint): packed uint8 (..., K/2, N), float32 scales and zeros
(..., K/g, N). Nothing is allocated. The rule is the JAX one even where the
port's ``quantize_tree`` differs: a leaf is quantized when it is at least
2-D with ``MIN_SIZE`` elements, its path names none of the skipped parts
(the router among them) and its K is even; the group is ``GROUP`` halved
until it divides K. One repair: a layer's vector stacked over the layers
of a repeated segment or of the encoder / decoder blocks (a bias (L, N))
is 2-D only by its stack, and stays a vector. The JAX rule quantizes it
too, and the JAX step then cannot run the tree (Qwen2's, Whisper's and
InternVL2's biases; ROADMAP §3).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import path_str
from repro_torch.models.lm import segment_plan
from repro_torch.quant import QTensor
from repro_torch.tree import flatten_with_path, unflatten

MIN_SIZE = 1 << 14
GROUP = 128
SKIP = ("embed", "norm", "ln", "router", "conv", "beta", "a_log", "dt_bias")
META = torch.device("meta")


def _qstruct(shape, dtype) -> QTensor:
    *lead, K, N = shape
    g = min(GROUP, K)
    while K % g:
        g //= 2
    f32 = dict(dtype=torch.float32, device=META)
    return QTensor(torch.empty((*lead, K // 2, N), dtype=torch.uint8,
                               device=META),
                   torch.empty((*lead, K // g, N), **f32),
                   torch.empty((*lead, K // g, N), **f32),
                   bits=4, group=g, K=K, N=N, out_dtype=dtype)


def _stack_dims(cfg: ModelConfig, path) -> int:
    """Leading dims of a leaf that stack layers: a repeated segment's, or
    the encoder's or decoder's blocks."""
    if path[0] in ("enc_blocks", "dec_blocks"):
        return 1
    if path[0] == "segments":
        return int(segment_plan(cfg)[path[1]][1] > 1)
    return 0


def quantized_params_shape(cfg: ModelConfig, pshape):
    """``pshape`` (a tree of tensors, ``meta`` or not) with every leaf the
    rule picks replaced by its int4 QTensor on ``meta``."""
    out = []
    for path, leaf in flatten_with_path(pshape):
        p = path_str(path).lower()
        big = leaf.ndim - _stack_dims(cfg, path) >= 2 \
            and leaf.numel() >= MIN_SIZE
        skip = any(t in p for t in SKIP)
        if big and not skip and leaf.shape[-2] % 2 == 0:
            out.append(_qstruct(tuple(leaf.shape), leaf.dtype))
        else:
            out.append(leaf)
    return unflatten(pshape, out)
