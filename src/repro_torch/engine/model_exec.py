"""Model execution over the paged KV pool + mixed-precision layers (GQA).

This is the worker's data plane. PyTorch runs eagerly, so there is no jit
cache; what stays from the JAX package is the bucketing that fixes shapes:
swap levels are bucketed (``SwapPlan.levels``), pool capacities are
power-of-two buckets (``PagedKVPool``), and the engine pads prompt lengths,
chunk lengths and block-table widths to powers of two (``pad_bucket``).
Those widths decide what the kernels walk, so the same bucketing keeps the
block walks and the prefill GEMMs at a bounded set of shapes.

The pool tensors are updated **in place**: every layer appends its new KV
with an indexed assignment into ``pool_k[li]``/``pool_v[li]`` (where JAX
used ``.at[].set`` and returned a new pool), so the step functions return
only logits.

``plain=True`` on a step function runs every kernel route's plain torch
version (``kernels/ref.py``) instead of the CUDA kernel; the step-parity
checks use it to hold a whole step through the kernels against the same
step without them.
"""
from __future__ import annotations

from typing import List

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.quant import qlinear


def pad_bucket(n: int, quantum: int = 64) -> int:
    """Round up to a small set of buckets (powers of two of `quantum`)."""
    b = quantum
    while b < n:
        b *= 2
    return b


def build_attention_specs(cfg: ModelConfig, kinds) -> tuple:
    """One :class:`~repro_torch.kernels.ops.AttentionSpec` per layer, built
    once at :class:`ModelExec` construction."""
    return tuple(
        ops.AttentionSpec(window=lm.layer_window(cfg, i),
                          softcap=cfg.logit_softcap,
                          q_heads=cfg.n_heads, kv_heads=cfg.n_kv_heads)
        for i, _ in enumerate(kinds))


def _mlp_residual(p, cfg, x, h, attn_out, plain):
    if cfg.parallel_block:
        return x + attn_out + L.mlp_apply(p["mlp"], cfg, h, plain=plain)
    x = x + attn_out
    h2 = L.apply_norm(cfg.norm, p["ln2"], x)
    return x + L.mlp_apply(p["mlp"], cfg, h2, plain=plain)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------
def _append_kv(pool_k, pool_v, li, k_new, v_new, blk, off):
    """Write one new token's KV per slot into layer ``li`` of the pool, in
    place. k_new: (slots, KVH, Dh); blk/off: (slots,) (scratch 0 for idle
    slots, whose writes collide harmlessly in the scratch block)."""
    pool_k[li, blk, off] = k_new.to(pool_k.dtype)
    pool_v[li, blk, off] = v_new.to(pool_v.dtype)


def _paged_gqa_decode(p, cfg, x, pool_k, pool_v, li, tables, pos, spec,
                      plain=False):
    """x: (slots, 1, D); pos: (slots,) absolute position of the new token.
    The attention read is the decode kernel route (K2) over the
    caller-truncated width of ``tables``."""
    slots = x.shape[0]
    bs = pool_k.shape[2]
    q, k, v = L.gqa_project_qkv(p, cfg, x, pos[:, None], plain=plain)
    pos_l = pos.long()
    blk = tables.long().gather(1, (pos_l // bs)[:, None])[:, 0]
    _append_kv(pool_k, pool_v, li, k[:, 0], v[:, 0], blk, pos_l % bs)
    out = ops.paged_decode_attention(
        q[:, 0], k[:, 0], v[:, 0], pool_k[li], pool_v[li], tables, pos, spec,
        plain=plain)
    return qlinear.matmul(out.reshape(slots, 1, -1), p["wo"],
                          bias=p.get("bo"), plain=plain)


def paged_decode_step(cfg: ModelConfig, kinds, specs, misc, layer_params,
                      tokens, pos, pool_k, pool_v, tables, *,
                      plain: bool = False):
    """tokens: (slots, 1); pos: (slots,) int32 absolute index of the token
    being decoded (its RoPE position and KV append slot); tables:
    (slots, nb) int32. Appends each layer's KV to the pools in place.
    Returns logits (slots, V)."""
    x = lm.embed_tokens(cfg, misc, tokens)
    for i, p in enumerate(layer_params):
        h = L.apply_norm(cfg.norm, p["ln1"], x)
        attn_out = _paged_gqa_decode(p["attn"], cfg, h, pool_k, pool_v, i,
                                     tables, pos, specs[i], plain)
        x = _mlp_residual(p, cfg, x, h, attn_out, plain)
    return lm.unembed(cfg, misc, x)[:, 0]


# ---------------------------------------------------------------------------
# Whole-prompt prefill
# ---------------------------------------------------------------------------
def paged_prefill(cfg: ModelConfig, kinds, misc, layer_params, tokens,
                  pool_k, pool_v, block_ids, *, plain: bool = False):
    """Prefill ONE request (batch 1, padded length Sp <= len(block_ids)*bs).
    tokens: (1, Sp); block_ids: (nb,) — scratch 0 where padded. Scatters
    the KV into the pools in place. Returns full logits (Sp, V)."""
    layer_list = list(zip(kinds, layer_params))
    logits, payloads = lm.prefill_collect(cfg, misc, layer_list, tokens,
                                          plain=plain)
    bs = pool_k.shape[2]
    nb = block_ids.shape[0]
    pad = nb * bs - tokens.shape[1]
    ids = block_ids.long()
    if nb > 0:
        for i, payload in enumerate(payloads):
            for pool, t in ((pool_k, payload["k"][0]),
                            (pool_v, payload["v"][0])):
                if pad > 0:
                    t = torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad))
                pool[i, ids] = t.reshape(nb, bs, *t.shape[1:]).to(pool.dtype)
    return logits[0]


def paged_prefill_batch(cfg: ModelConfig, kinds, misc, layer_params, tokens,
                        pool_k, pool_v, tables, lens, *, plain: bool = False):
    """Prefill up to P requests in ONE call at a shared padded length.

    tokens: (P, Sp) with Sp = tables.shape[1] * block_size; tables: (P, nb)
    physical block ids, scratch 0 where padded; lens: (P,) true prompt
    lengths. Rows are independent (causal masking), so batching is
    transparent per row. Scatters the KV into the pools in place and
    returns last-token logits (P, V)."""
    layer_list = list(zip(kinds, layer_params))
    logits, payloads = lm.prefill_collect(cfg, misc, layer_list, tokens,
                                          plain=plain)
    bs = pool_k.shape[2]
    P = tokens.shape[0]
    nb = tables.shape[1]
    ids = tables.long()
    if nb > 0:
        for i, payload in enumerate(payloads):
            for pool, t in ((pool_k, payload["k"]), (pool_v, payload["v"])):
                pool[i, ids] = t.reshape(P, nb, bs, *t.shape[2:]).to(
                    pool.dtype)
    rows = torch.arange(P, device=logits.device)
    return logits[rows, lens.long() - 1]


# ---------------------------------------------------------------------------
# Chunked prefill
# ---------------------------------------------------------------------------
def _chunk_gqa_attention(p, cfg, x, positions, pool_k, pool_v, li, tables,
                         blk, off, pos0, spec, plain=False):
    """Causal chunk attention against already-paged context (batch 1).

    x: (1, Cp, D) chunk activations at absolute positions ``positions``.
    The chunk's KV is scattered into layer ``li`` of the pool in place (pad
    positions land in blocks the next chunk overwrites, or in scratch 0),
    then the chunk attends through the chunk kernel route (K3) with its own
    (k, v) as operands: the walk covers only the already-paged context
    ``< pos0`` and never reads back what was just scattered. The operands
    are cast to the pool dtype first, so later chunks and decode read the
    same rounding the fold used."""
    B, Cp, _ = x.shape
    q, k, v = L.gqa_project_qkv(p, cfg, x, positions, plain=plain)
    pool_k[li, blk, off] = k[0].to(pool_k.dtype)
    pool_v[li, blk, off] = v[0].to(pool_v.dtype)
    out = ops.paged_prefill_attention(q, pool_k[li], pool_v[li],
                                      tables[None], pos0, spec,
                                      k_new=k, v_new=v, plain=plain)
    return qlinear.matmul(out.reshape(B, Cp, -1), p["wo"], bias=p.get("bo"),
                          plain=plain)


def paged_prefill_chunk(cfg: ModelConfig, kinds, specs, misc, layer_params,
                        tokens, pos0: int, pool_k, pool_v, tables, *,
                        plain: bool = False):
    """Prefill ONE chunk of ONE request against partially-paged context.

    tokens: (1, Cp) — the chunk, end-padded to a bucketed length; pos0: the
    absolute position of tokens[0] (the request's ``prefill_pos``); tables:
    (nb,) int32 block table whose span ``nb * bs`` covers ``pos0 + Cp``
    positions (scratch 0 where the request owns fewer blocks). Each layer
    appends the chunk's KV into the pool and runs causal attention of the
    chunk against everything paged so far (Sarathi-style chunked prefill).
    Returns chunk logits (Cp, V)."""
    bs = pool_k.shape[2]
    Cp = tokens.shape[1]
    abs_pos = pos0 + torch.arange(Cp, device=tokens.device)
    positions = abs_pos[None, :]
    blk = tables.long()[abs_pos // bs]
    off = abs_pos % bs
    x = lm.embed_tokens(cfg, misc, tokens)
    for i, p in enumerate(layer_params):
        h = L.apply_norm(cfg.norm, p["ln1"], x)
        attn_out = _chunk_gqa_attention(p["attn"], cfg, h, positions, pool_k,
                                        pool_v, i, tables, blk, off, pos0,
                                        specs[i], plain)
        x = _mlp_residual(p, cfg, x, h, attn_out, plain)
    return lm.unembed(cfg, misc, x)[0]


class ModelExec:
    """Binds a model's static parts (config, layer kinds, per-layer
    attention specs, embedding/head params) to the step functions; the
    per-level layer list is passed per call. Runs under ``no_grad``."""

    def __init__(self, cfg: ModelConfig, params, kinds):
        self.cfg = cfg
        self.kinds = tuple(kinds)
        self.misc = {k: v for k, v in params.items() if k != "segments"}
        self.specs = build_attention_specs(cfg, self.kinds)

    @staticmethod
    def _lp(layer_list) -> List:
        return [p for _, p in layer_list]

    @torch.no_grad()
    def decode(self, layer_list, tokens, pos, pool_k, pool_v, tables, *,
               plain: bool = False):
        return paged_decode_step(self.cfg, self.kinds, self.specs, self.misc,
                                 self._lp(layer_list), tokens, pos, pool_k,
                                 pool_v, tables, plain=plain)

    @torch.no_grad()
    def prefill(self, layer_list, tokens, pool_k, pool_v, block_ids, *,
                plain: bool = False):
        return paged_prefill(self.cfg, self.kinds, self.misc,
                             self._lp(layer_list), tokens, pool_k, pool_v,
                             block_ids, plain=plain)

    @torch.no_grad()
    def prefill_batch(self, layer_list, tokens, pool_k, pool_v, tables, lens,
                      *, plain: bool = False):
        return paged_prefill_batch(self.cfg, self.kinds, self.misc,
                                   self._lp(layer_list), tokens, pool_k,
                                   pool_v, tables, lens, plain=plain)

    @torch.no_grad()
    def prefill_chunk(self, layer_list, tokens, pos0: int, pool_k, pool_v,
                      table, *, plain: bool = False):
        return paged_prefill_chunk(self.cfg, self.kinds, self.specs,
                                   self.misc, self._lp(layer_list), tokens,
                                   pos0, pool_k, pool_v, table, plain=plain)
