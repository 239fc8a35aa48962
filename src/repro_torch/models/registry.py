"""Model registry: one API over the decoder-only and enc-dec families.

    api = get_model(cfg)
    params = api.init_params(cfg, gen)
    logits = api.forward(cfg, params, **api_inputs)   # dummy_inputs(...)
    cache  = api.init_cache(cfg, batch, max_seq, device=...)
    logits, cache = api.decode_step(cfg, params, cache, tokens)

``decode_step`` (and an encdec's ``start_cache``) write into the cache in
place; they and ``forward`` take ``plain=True`` to ask each kernel route
for its plain version. ``gen`` is a ``torch.Generator``: parameters and
dummy inputs are drawn on its device (or the device given).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.configs.base import ENCDEC, VLM, ModelConfig
from repro_torch.models import encdec, lm
from repro_torch.models.lm import torch_dtype
from repro_torch.quant import qlinear


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    init_params: Callable          # (cfg, gen)
    forward: Callable              # (cfg, params, tokens, *, frontend,
    #                                 remat, collect_aux, plain)
    init_cache: Callable           # (cfg, batch, max_seq, dtype, *, device)
    decode_step: Callable          # (cfg, params, cache, tokens, *, plain)
    needs_frontend: bool
    start_cache: Optional[Callable] = None   # encdec: fill cross-attn KV


_LM_API = ModelAPI(lm.init_params, lm.forward, lm.init_cache, lm.decode_step,
                   needs_frontend=False)
_VLM_API = dataclasses.replace(_LM_API, needs_frontend=True)
_ENCDEC_API = ModelAPI(encdec.init_params, encdec.forward, encdec.init_cache,
                       encdec.decode_step, needs_frontend=True,
                       start_cache=encdec.start_cache)


def get_model(cfg: ModelConfig) -> ModelAPI:
    lm.check_family(cfg)
    if cfg.family == ENCDEC:
        return _ENCDEC_API
    if cfg.family == VLM:
        return _VLM_API
    return _LM_API


def frontend_shape(cfg: ModelConfig, batch: int):
    if cfg.family == ENCDEC:
        return (batch, cfg.encoder_seq, cfg.frontend_dim)
    if cfg.family == VLM:
        return (batch, cfg.n_image_tokens, cfg.frontend_dim)
    return None


def text_seq_len(cfg: ModelConfig, seq_len: int) -> int:
    """A VLM counts its image tokens toward ``seq_len``."""
    if cfg.family == VLM:
        return max(seq_len - cfg.n_image_tokens, 1)
    return seq_len


def dummy_inputs(cfg: ModelConfig, batch: int, seq_len: int,
                 gen: Optional[torch.Generator] = None, dtype=None,
                 device="cuda"):
    """Random inputs for smoke runs on ``device``: {"tokens": (batch,
    text_seq_len) int64}, and for an enc-dec or VLM config "frontend" of
    ``frontend_shape`` in ``dtype`` (the config's by default), drawn from
    ``gen`` (seed 0 on ``device`` when None; a given generator must live
    on ``device``)."""
    gen = gen if gen is not None else \
        torch.Generator(device=device).manual_seed(0)
    tokens = torch.randint(0, cfg.vocab, (batch, text_seq_len(cfg, seq_len)),
                           generator=gen, device=device)
    out = {"tokens": tokens}
    fs = frontend_shape(cfg, batch)
    if fs is not None:
        out["frontend"] = torch.randn(
            fs, generator=gen, device=device,
            dtype=torch.float32).to(torch_dtype(dtype or cfg.dtype))
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif qlinear.is_quantized(tree):
        yield from (t for t in (tree.packed, tree.scales, tree.zeros,
                                tree.inv_act) if t is not None)
    elif isinstance(tree, torch.Tensor):
        yield tree


def count_params(params) -> int:
    """Elements of every tensor of the tree (a QTensor's stored fields,
    as the JAX pytree counts them)."""
    return sum(t.numel() for t in _leaves(params))


def param_bytes(params) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(params))
