"""Step functions and input specs for every (arch x shape) cell, in torch.

The JAX package's ``launch/steps.py``: the train step (the loss of
``forward`` with remat, its gradient, AdamW), the prefill and serve steps,
and the shapes of a cell's inputs, parameters, cache and optimizer state.
A shape is a tensor on the ``meta`` device (the counterpart of a
``jax.ShapeDtypeStruct``): nothing is allocated. Each step takes the JAX
sharding hints as a ``ShardCtx`` (``models/layers.py``): without mesh axes,
on one card and on the CPU, they leave every tensor as it is; the dry run
(``launch/dryrun.py``) gives them a mesh.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ENCDEC, VLM, ModelConfig, ShapeSpec
from repro_torch.launch import knobs
from repro_torch.models.layers import NO_SHARD, ShardCtx
from repro_torch.models.lm import torch_dtype
from repro_torch.models.registry import (frontend_shape, get_model,
                                         text_seq_len)
from repro_torch.optim import adamw
from repro_torch.tree import leaves, unflatten

META = torch.device("meta")


def model_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch_dtype(cfg.dtype)


# ---------------------------------------------------------------------------
# shapes (meta tensors: never allocate)
# ---------------------------------------------------------------------------
class _MetaGenerator(torch.Generator):
    """A generator whose draws land on the ``meta`` device: ``init_params``
    draws on its generator's device, so this gives the parameters' shapes
    and dtypes alone."""

    @property
    def device(self):
        return META


def input_specs(cfg: ModelConfig,
                shape: ShapeSpec) -> Dict[str, torch.Tensor]:
    """The cell's inputs: "tokens" (and "labels" to train) int32, and a
    frontend's embeddings except at decode."""
    B = shape.global_batch
    out: Dict[str, torch.Tensor] = {}
    S = 1 if shape.kind == "decode" else text_seq_len(cfg, shape.seq_len)
    out["tokens"] = torch.empty((B, S), dtype=torch.int32, device=META)
    if shape.kind == "train":
        out["labels"] = torch.empty((B, S), dtype=torch.int32, device=META)
    fs = frontend_shape(cfg, B)
    if fs is not None and shape.kind != "decode":
        out["frontend"] = torch.empty(fs, dtype=model_dtype(cfg),
                                      device=META)
    return out


def params_shape(cfg: ModelConfig):
    return get_model(cfg).init_params(cfg, _MetaGenerator())


def cache_shape(cfg: ModelConfig, shape: ShapeSpec):
    dt = knobs.KNOBS.kv_cache_dtype
    return get_model(cfg).init_cache(
        cfg, shape.global_batch, shape.seq_len,
        dtype=getattr(torch, dt) if dt else None, device=META)


def opt_state_shape(cfg: ModelConfig):
    return adamw.init(params_shape(cfg))


# ---------------------------------------------------------------------------
# step functions
# ---------------------------------------------------------------------------
def softmax_xent(logits, labels):
    """Mean cross-entropy in the JAX package's form: every op elementwise
    or a reduction over V (the max shift outside the gradient, the gold
    logit picked by a one-hot compare), which keeps vocab-sharded logits
    sharded."""
    logits = logits.to(torch.float32)
    m = torch.amax(logits, dim=-1, keepdim=True).detach()
    shifted = logits - m
    lse = torch.log(torch.sum(torch.exp(shifted), dim=-1)) + m[..., 0]
    onehot = (torch.arange(logits.shape[-1], device=logits.device)
              == labels[..., None])
    gold = torch.sum(torch.where(onehot, shifted, 0.0), dim=-1) + m[..., 0]
    return torch.mean(lse - gold)


def make_loss_and_grad(cfg: ModelConfig, ctx: ShardCtx = NO_SHARD):
    """``loss_and_grad(params, tokens, labels, frontend=None)`` -> (loss,
    grads): the JAX ``value_and_grad`` of the train loss. ``grads`` has
    ``params``' structure; a leaf that the loss does not reach (a
    selection bias, an unread projection) has ``None``. The loss runs
    ``forward`` with ``remat=True`` (``knobs.KNOBS.remat_policy``) and the
    MoE capacity factor ``knobs.KNOBS.moe_capacity_factor``; a VLM's loss
    covers its text positions only, and its logits are hinted vocab over
    model (``ctx``)."""
    api = get_model(cfg)

    def loss_and_grad(params, tokens, labels, frontend=None):
        kw = {"moe_cf": knobs.KNOBS.moe_capacity_factor} \
            if cfg.family != ENCDEC else {}
        flat = [p.detach().requires_grad_(True) for p in leaves(params)]
        with torch.enable_grad():
            logits = api.forward(cfg, unflatten(params, flat), tokens,
                                 frontend=frontend, remat=True, ctx=ctx,
                                 **kw)
            if cfg.family == VLM:
                logits = logits[:, cfg.n_image_tokens:]
            logits = ctx.constrain(
                logits, (ctx.data_axis, None, ctx.model_axis), "steps.loss")
            loss = softmax_xent(logits, labels)
            del logits            # the backward does not read them
            grads = torch.autograd.grad(loss, flat, allow_unused=True)
        return loss.detach(), unflatten(params, grads)

    return loss_and_grad


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.OptConfig,
                    ctx: ShardCtx = NO_SHARD):
    """``train_step(params, opt_state, tokens, labels, frontend=None)`` ->
    (params, opt_state, {"loss", "grad_norm", "lr"}). Its inputs are left
    as they are."""
    loss_and_grad = make_loss_and_grad(cfg, ctx)

    def train_step(params, opt_state, tokens, labels, frontend=None):
        loss, grads = loss_and_grad(params, tokens, labels, frontend)
        params, opt_state, stats = adamw.apply(opt_cfg, params, grads,
                                               opt_state)
        return params, opt_state, {"loss": loss, **stats}

    return train_step


def make_prefill_step(cfg: ModelConfig, ctx: ShardCtx = NO_SHARD):
    api = get_model(cfg)

    @torch.no_grad()
    def prefill_step(params, tokens, frontend=None):
        logits = api.forward(cfg, params, tokens, frontend=frontend, ctx=ctx)
        # serving prefill returns next-token logits only
        return logits[:, -1, :]

    return prefill_step


def make_serve_step(cfg: ModelConfig, ctx: ShardCtx = NO_SHARD):
    """One decode step against a full-length cache (the decode_* cells);
    the cache is written in place. The decode path has no sharding hints
    (nor has the JAX one): ``ctx`` is taken for the JAX signature."""
    api = get_model(cfg)

    @torch.no_grad()
    def serve_step(params, cache, tokens):
        return api.decode_step(cfg, params, cache, tokens)

    return serve_step
