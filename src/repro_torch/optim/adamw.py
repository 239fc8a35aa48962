"""AdamW + cosine schedule + global-norm clipping over the port's trees.

The JAX package's ``optim/adamw.py``, with the same maths: the gradients
clipped to ``clip_norm`` by their global norm, float32 moments, bias
correction, decoupled weight decay on every leaf, and the new parameter
cast back to its leaf's dtype. The update runs leaf by leaf, so no
whole-tree temporaries of the bias-corrected moments are held (at
Llama-2-7B width they would be as large as the moments themselves); the
values are the same. A leaf whose gradient is ``None`` (one that autograd
did not reach, where ``jax.grad`` gives zeros) is updated with a zero
gradient: its moments decay and weight decay still applies, as in JAX.
Nothing is updated in place.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.tree import flatten_with_path, leaves, tree_map, unflatten

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    betas: Tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: float = 1.0
    warmup_steps: int = 20
    total_steps: int = 1000
    min_lr_frac: float = 0.1


class OptState(NamedTuple):
    step: torch.Tensor        # 0-d int32
    m: Any
    v: Any


def schedule(cfg: OptConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or a 0-d tensor), float32:
    linear warmup, then a cosine down to ``min_lr_frac`` of ``lr``."""
    step = torch.as_tensor(step).to(F32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos)


def init(params) -> OptState:
    """Zero float32 moments shaped like every leaf, and step 0, on the
    params' device."""
    ps = leaves(params)
    dev = ps[0].device if ps else "cpu"
    return OptState(torch.zeros((), dtype=torch.int32, device=dev),
                    tree_map(lambda p: torch.zeros_like(p, dtype=F32),
                             params),
                    tree_map(lambda p: torch.zeros_like(p, dtype=F32),
                             params))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32 (``None``
    leaves count as zeros)."""
    total = None
    for x in leaves(tree):
        sq = torch.sum(torch.square(x.to(F32)))
        total = sq if total is None else total + sq
    if total is None:
        return torch.zeros((), dtype=F32)
    return torch.sqrt(total)


def apply(cfg: OptConfig, params, grads, state: OptState):
    """One AdamW step. ``grads`` has ``params``' structure; a ``None`` leaf
    is a zero gradient. Returns (new_params, new_state, {"grad_norm" (the
    norm before clipping), "lr"})."""
    gn = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gn + 1e-9), max=1.0)
    step = state.step + 1
    lr = schedule(cfg, step)
    b1, b2 = cfg.betas
    c1 = 1 - b1 ** step.to(F32)
    c2 = 1 - b2 ** step.to(F32)

    grads = dict(flatten_with_path(grads))
    new_p, new_m, new_v = [], [], []
    for (path, p), m_, v_ in zip(flatten_with_path(params), leaves(state.m),
                                 leaves(state.v)):
        g = grads.get(path)
        # the clip multiplies in float32, as the JAX package's bf16 * f32
        # promotes
        g = (torch.zeros_like(p, dtype=F32) if g is None
             else g.to(F32) * scale)
        m = b1 * m_ + (1 - b1) * g
        v = b2 * v_ + (1 - b2) * torch.square(g)
        pf = p.to(F32)
        delta = (m / c1) / (torch.sqrt(v / c2) + cfg.eps) \
            + cfg.weight_decay * pf
        new_p.append((pf - lr * delta).to(p.dtype))
        new_m.append(m)
        new_v.append(v)
    return (unflatten(params, new_p),
            OptState(step, unflatten(state.m, new_m),
                     unflatten(state.v, new_v)),
            {"grad_norm": gn, "lr": lr})
