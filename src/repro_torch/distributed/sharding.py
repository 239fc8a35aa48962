"""Sharding rules for every arch family on the production mesh.

Path-and-shape-driven partition-spec assignment with divisibility checks:
a dim is sharded on an axis only when evenly divisible, otherwise the rule
falls back to replication (e.g. kv_heads=5 on a 16-way model axis →
replicated KV, the standard GQA-TP choice).

Modes:
  * serve: TP over 'model' (heads / d_ff / experts / **cache sequence dim**),
    DP over 'data' (+ 'pod'); decode KV caches shard T over 'model' so the
    32k/500k cells fit HBM.
  * train: serve rules + FSDP — remaining large dims additionally sharded
    over 'data' (ZeRO-3 analogue); optimizer moments inherit param specs.

The rules are the JAX package's (``repro.distributed.sharding``), over the
port's trees, walked in JAX's order by ``repro_torch.tree`` (dict keys
sorted, a QTensor's children ``packed``, ``scales``, ``zeros`` and
``inv_act`` as leaves ``0`` to ``3`` of its path, a ``None`` dropped, as in
JAX). So a leaf's path is the string the JAX package gives it. A spec is a
:class:`P`; :func:`placements` turns one into the DTensor placements of a
``DeviceMesh``. Nothing on the one-card serving path calls these rules.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.tree import flatten_with_path, map_with_path


class P(tuple):
    """A partition spec: per tensor dim, ``None`` (replicated), a mesh axis
    name, or a tuple of names (sharded over their product, major first),
    as JAX's ``PartitionSpec`` holds them."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def tree_flatten_with_path(tree):
    """``[(path, leaf)]`` of a port tree in JAX's flattening order
    (``repro_torch.tree``); a :class:`P` is a leaf."""
    return flatten_with_path(tree, is_leaf=_is_spec)


def _is_spec(node) -> bool:
    return isinstance(node, P)


def _map_with_path(fn, tree):
    """``tree`` with every leaf replaced by ``fn(path, leaf)`` (same
    containers; a QTensor is copied with its children replaced)."""
    return map_with_path(fn, tree, is_leaf=_is_spec)


def path_str(path) -> str:
    """A ``tree_flatten_with_path`` path in 'a/b/0/c' form."""
    return "/".join(str(k) for k in path)


# rules: substring of the leaf path -> (dim sharded on 'model') for 2-D core
_COL = ("wq", "wk", "wv", "w_uq", "w_dq", "w_dkv", "w_ukv", "w_up", "w_gate",
        "in_proj", "adapter", "projector")          # (K, N): shard N
_ROW = ("wo", "w_down", "out_proj")                  # (K, N): shard K
_EMBED = ("embed",)                                  # (V, D): shard V
_HEAD = ("lm_head",)                                 # (D, V): shard V
_REPL = ("router", "norm", "ln", "bias", "beta", "scale", "A_log", "dt_bias",
         "gnorm", "conv")


def _div(n: int, size: int) -> bool:
    return size > 0 and n % size == 0


def spec_for_param(path: str, shape: Tuple[int, ...], axes: Dict[str, int],
                   *, fsdp: bool = False) -> P:
    """axes: {"model": size, "data": size} for present mesh axes."""
    model, msize = "model", axes.get("model", 0)
    data, dsize = "data", axes.get("data", 0)
    nd = len(shape)
    path_l = path.lower()
    parts: list = [None] * nd
    # stacked layer/expert leading dims stay unsharded (scan carries them),
    # EXCEPT expert stacks (E, K, N) where we shard E (expert parallelism).
    core0 = nd - 2 if nd >= 3 else 0
    is2d = nd >= 2

    def used_axes():
        out = set()
        for p in parts:
            if isinstance(p, tuple):
                out.update(p)
            elif p is not None:
                out.add(p)
        return out

    def put(dim, axis, size):
        if parts[dim] is None and _div(shape[dim], size) \
                and axis not in used_axes():
            parts[dim] = axis
            return True
        return False

    matched = False
    if is2d and not any(t in path_l for t in _REPL):
        if nd >= 3 and ("w_gate" in path_l or "w_up" in path_l
                        or "w_down" in path_l or "packed" in path_l
                        or "scales" in path_l or "zeros" in path_l):
            # stacked experts (E, K, N) or stacked-layer weights (L, K, N)
            if "moe" in path_l:
                # expert parallelism over BOTH axes when E divides data*model
                # (e.g. deepseek 256e / 256 chips), else over model only
                both = msize * dsize
                if both and _div(shape[nd - 3], both):
                    parts[nd - 3] = (data, model)
                    matched = True
                elif msize:
                    matched = put(nd - 3, model, msize)
            if not matched and msize:
                # stacked per-layer weight: shard core dims as usual
                if any(t in path_l for t in _ROW):
                    matched = put(nd - 2, model, msize)
                else:
                    matched = put(nd - 1, model, msize)
        elif any(t in path_l for t in _EMBED) and msize:
            matched = put(nd - 2, model, msize)
        elif any(t in path_l for t in _HEAD) and msize:
            matched = put(nd - 1, model, msize)
        elif any(t in path_l for t in _ROW) and msize:
            matched = put(nd - 2, model, msize)
        elif any(t in path_l for t in _COL) and msize:
            matched = put(nd - 1, model, msize)
    if fsdp and dsize and is2d and not any(t in path_l for t in _REPL):
        # FSDP: shard the largest remaining dim over 'data'
        order = sorted(range(core0, nd), key=lambda d: -shape[d])
        for d in order:
            if parts[d] is None and put(d, data, dsize):
                break
    return P(*parts)


def param_specs(cfg, params, axes: Dict[str, int], *, fsdp: bool = False):
    """Map a param tree (tensors of any device, ``meta`` included) to a
    tree of the same containers with a :class:`P` at every leaf."""
    return _map_with_path(
        lambda path, leaf: spec_for_param(path_str(path), tuple(leaf.shape),
                                          axes, fsdp=fsdp), params)


def batch_axes(axes: Dict[str, int]) -> Tuple[Optional[str], ...]:
    """Mesh axes used for data parallelism (pod absorbs into data)."""
    out = tuple(a for a in ("pod", "data") if a in axes)
    return out if out else (None,)


def data_spec(shape: Tuple[int, ...], axes: Dict[str, int]) -> P:
    """Shard batch dim 0 over (pod, data) when divisible."""
    ba = batch_axes(axes)
    if ba == (None,):
        return P(*([None] * len(shape)))
    size = int(np.prod([axes[a] for a in ba]))
    if _div(shape[0], size):
        return P(ba if len(ba) > 1 else ba[0], *([None] * (len(shape) - 1)))
    # try data only
    if "data" in axes and _div(shape[0], axes["data"]):
        return P("data", *([None] * (len(shape) - 1)))
    return P(*([None] * len(shape)))


def cache_spec(path: str, shape: Tuple[int, ...],
               axes: Dict[str, int]) -> P:
    """Decode-cache sharding: batch over data axes, sequence dim over model.

    Cache leaves (stacked over L): k/v (L, B, T, KVH, Dh); mla latent
    (L, B, T, W); mamba conv (L, B, W, C) / ssm (L, B, H, P, N).
    """
    nd = len(shape)
    parts = [None] * nd
    msize = axes.get("model", 0)
    path_l = path.lower()
    # find batch dim: first dim after optional leading L-stack
    bdim = 1 if nd >= 3 else 0
    ba = batch_axes(axes)
    if ba != (None,):
        size = int(np.prod([axes[a] for a in ba]))
        if _div(shape[bdim], size):
            parts[bdim] = ba if len(ba) > 1 else ba[0]
        elif "data" in axes and _div(shape[bdim], axes["data"]):
            parts[bdim] = "data"
    if any(k in path_l for k in ("self_k", "self_v", "cross_k", "cross_v",
                                 "latent", "/k", "/v")) or \
            path_l.endswith(("k", "v")):
        tdim = bdim + 1
        if nd > tdim and _div(shape[tdim], msize):
            parts[tdim] = "model"
    elif "ssm" in path_l and nd >= 4:
        # shard SSM heads over model when divisible
        hdim = bdim + 1
        if _div(shape[hdim], msize):
            parts[hdim] = "model"
    return P(*parts)


def cache_specs(cache, axes: Dict[str, int]):
    """A decode-cache tree (``init_cache``'s, any device) to a tree of
    :class:`P`; the position vector ``pos`` stays replicated."""
    def spec(path, leaf):
        p, shape = path_str(path), tuple(leaf.shape)
        if p.endswith("pos"):
            return P(*([None] * len(shape)))
        return cache_spec(p, shape, axes)
    return _map_with_path(spec, cache)


def mesh_axes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``torch.distributed.device_mesh.DeviceMesh``
    with named dims."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def placements(spec: Sequence, mesh_dim_names: Sequence[str]):
    """The DTensor placements of ``spec`` on a mesh whose dims are named
    ``mesh_dim_names``: per mesh dim, ``Shard(d)`` for the tensor dim ``d``
    whose entry names it, else ``Replicate()`` — what ``NamedSharding``
    expresses in JAX. A tensor dim sharded over several axes names them in
    the mesh's own dim order (DTensor splits a dim over mesh dims in that
    order, the first the major one)."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh_dim_names)
    where: Dict[str, int] = {}
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        for a in axes:
            if a not in names:
                raise ValueError(f"spec {spec} names axis {a!r}, not a dim "
                                 f"of the mesh {tuple(names)}")
            if a in where:
                raise ValueError(f"spec {spec} uses axis {a!r} twice")
            where[a] = d
        if list(axes) != sorted(axes, key=names.index):
            raise ValueError(f"spec {spec}: dim {d} names {axes} out of the "
                             f"mesh's order {tuple(names)}")
    return tuple(Shard(where[n]) if n in where else Replicate()
                 for n in names)
