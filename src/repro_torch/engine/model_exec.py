"""Model execution over the paged KV pool + mixed-precision layers (GQA,
DeepSeek's MLA over the latent pool, and the SSM and hybrid layers with
their per-slot state; a layer's FFN is its MLP or, in an MoE layer,
``models/moe.moe_apply`` at no-drop capacity).

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

The decode and chunk steps take the pool's quantized-KV bundle ``kvq``
(L-leading tensors, ``PagedKVPool.kv_quant_bundle``; None while no block is
quantized) and hand each layer its slice. Whole-prompt prefill takes none:
it writes only freshly allocated blocks and reads no pool KV.

SSM (``mamba``) and ``hybrid`` layers carry a per-slot recurrent state,
``ssm_conv`` (n_ssm, slots, d_conv - 1, conv_ch) and ``ssm_ssm`` (n_ssm,
slots, H, P, N) in float32 (``engine.kv_cache.StatePool``), indexed by the
layer's position among those layers. Decode updates every slot's row in
place; whole-prompt prefill writes the request's ``slot`` row. A hybrid
layer's attention is GQA over the paged pool (the decode walk, K2, beside
``models/mamba.mamba_decode``); its prefill is whole-prompt, at the
prompt's exact length, since an SSM state would take in end padding.

MLA layers keep one latent row (c_kv, k_rope) per token in ``pool_k``
(KVH = 1, Dh = r + rope; ``pool_v`` is a placeholder nobody reads). Decode
and chunk prefill score against the latent pool with the absorbed weights
(``absorb_mla_decode_weights``, cached per layer list by ModelExec):
decode in plain torch, as in the JAX package, and chunk prefill through
the chunk route's latent mode (K3-mla). The JAX package has a second chunk
numerics, expanding the latent to per-head K/V under its ``xla`` dispatch
mode; the port always takes the absorbed one.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.models import mamba as M
from repro_torch.quant import qlinear


def pad_bucket(n: int, quantum: int = 64) -> int:
    """Round up to a small set of buckets (powers of two of `quantum`)."""
    b = quantum
    while b < n:
        b *= 2
    return b


def build_attention_specs(cfg: ModelConfig, kinds,
                          kv_quant: bool = False) -> tuple:
    """One :class:`~repro_torch.kernels.ops.AttentionSpec` per layer, built
    once at :class:`ModelExec` construction. ``kv_quant=True`` marks the
    layers' pools as ones that may hold quantized blocks; without it a step
    given a bundle raises. An MLA layer's spec is the latent mode: one kv
    head, the qk head dim's scale and ``latent_dv = kv_lora_rank`` (the
    latent pool keeps fp blocks, so ``kv_quant`` does not apply)."""
    if cfg.mla is not None:
        m = cfg.mla
        spec = ops.AttentionSpec(
            scale=(m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5,
            q_heads=cfg.n_heads, kv_heads=1, latent_dv=m.kv_lora_rank)
        return tuple(spec for _ in kinds)
    return tuple(
        ops.AttentionSpec(window=lm.layer_window(cfg, i),
                          softcap=cfg.logit_softcap,
                          q_heads=cfg.n_heads, kv_heads=cfg.n_kv_heads,
                          kv_quant=kv_quant)
        for i, _ in enumerate(kinds))


def _layer_kvq(kvq, li):
    """Layer ``li``'s slice of the pool's L-leading quantized-KV bundle."""
    return None if kvq is None else tuple(a[li] for a in kvq)


def _mlp_residual(kind, p, cfg, x, h, attn_out, plain):
    """The block's FFN half and residuals; an MoE layer runs at no-drop
    capacity (``lm.ffn_apply``)."""
    if cfg.parallel_block:
        return x + attn_out + L.mlp_apply(p["mlp"], cfg, h, plain=plain)
    x = x + attn_out
    h2 = L.apply_norm(cfg.norm, p["ln2"], x)
    return x + lm.ffn_apply(kind, p, cfg, h2, plain=plain)[0]


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
                      kvq=None, plain=False):
    """x: (slots, 1, D); pos: (slots,) absolute position of the new token.
    The attention read is the decode kernel route (K2, or K2-q with the
    layer's quantized-KV slice ``kvq``) over the caller-truncated width of
    ``tables``."""
    slots = x.shape[0]
    bs = pool_k.shape[2]
    q, k, v = L.gqa_project_qkv(p, cfg, x, pos[:, None], plain=plain)
    pos_l = pos.long()
    blk = tables.long().gather(1, (pos_l // bs)[:, None])[:, 0]
    _append_kv(pool_k, pool_v, li, k[:, 0], v[:, 0], blk, pos_l % bs)
    out = ops.paged_decode_attention(
        q[:, 0], k[:, 0], v[:, 0], pool_k[li], pool_v[li], tables, pos, spec,
        kv_quant=kvq, plain=plain)
    return qlinear.matmul(out.reshape(slots, 1, -1), p["wo"],
                          bias=p.get("bo"), plain=plain)


def _paged_mla_decode(p, cfg, x, pool_k, li, tables, pos, plain=False):
    """MLA decode over the latent pool with absorbed-weight scoring, in
    plain torch (the JAX package has no kernel here). Expects the absorbed
    attention params (``wk_abs``/``wv_abs`` in place of ``w_ukv``). Appends
    each slot's latent row in place, then reads the table's width of
    latent rows, of which the first ``pos + 1`` are live."""
    m = cfg.mla
    slots = x.shape[0]
    bs = pool_k.shape[2]
    q_nope, q_rope, c_kv_new, k_rope_new = L._mla_qkv(p, cfg, x,
                                                      pos[:, None],
                                                      plain=plain)
    latent_new = torch.cat([c_kv_new[:, 0], k_rope_new[:, 0, 0]], -1)
    pos_l = pos.long()
    blk = tables.long().gather(1, (pos_l // bs)[:, None])[:, 0]
    pool_k[li, blk, pos_l % bs, 0] = latent_new.to(pool_k.dtype)
    lat = pool_k[li][tables.long()]           # (slots, nb, bs, 1, r+rope)
    lat = lat.reshape(slots, -1, lat.shape[-1]).to(torch.float32)
    c_kv, k_rope = lat[..., :m.kv_lora_rank], lat[..., m.kv_lora_rank:]
    T = c_kv.shape[1]
    q_abs = torch.einsum("bshd,rhd->bshr", q_nope.to(torch.float32),
                         p["wk_abs"])
    s = (torch.einsum("bshr,btr->bhst", q_abs, c_kv)
         + torch.einsum("bshd,btd->bhst", q_rope.to(torch.float32), k_rope))
    s = s * ((m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5)
    live = torch.arange(T, device=x.device)[None, :] < (pos_l + 1)[:, None]
    s = torch.where(live[:, None, None, :], s, torch.full_like(s, -1e30))
    ctx = torch.einsum("bhst,btr->bshr", torch.softmax(s, dim=-1), c_kv)
    out = torch.einsum("bshr,rhd->bshd", ctx, p["wv_abs"]).to(x.dtype)
    return qlinear.matmul(out.reshape(slots, 1, -1), p["wo"], plain=plain)


def _ssm_decode(p, cfg, h, ssm_conv, ssm_ssm, li, plain):
    """One SSM mixer's decode over every slot, its state row ``li`` of
    ``ssm_conv``/``ssm_ssm`` updated in place."""
    y, st = M.mamba_decode(p, cfg, h, {"conv": ssm_conv[li],
                                       "ssm": ssm_ssm[li]}, plain=plain)
    ssm_conv[li] = st["conv"]
    ssm_ssm[li] = st["ssm"]
    return y


def paged_decode_step(cfg: ModelConfig, kinds, specs, misc, layer_params,
                      tokens, pos, pool_k, pool_v, tables, ssm_conv=None,
                      ssm_ssm=None, kvq=None, *, plain: bool = False):
    """tokens: (slots, 1); pos: (slots,) int32 absolute index of the token
    being decoded (its RoPE position and KV append slot); tables:
    (slots, nb) int32; ``ssm_conv``/``ssm_ssm``: the SSM state of every
    slot (None without SSM layers); ``kvq``: the pool's quantized-KV
    bundle or None. Appends each layer's KV to the pools and advances each
    SSM layer's state, in place. MLA layers take the absorbed params.
    Returns logits (slots, V)."""
    x = lm.embed_tokens(cfg, misc, tokens)
    ssm_li = 0
    for i, p in enumerate(layer_params):
        if kinds[i] == "mamba":
            h = L.apply_norm(cfg.norm, p["norm"], x)
            x = x + _ssm_decode(p["mixer"], cfg, h, ssm_conv, ssm_ssm,
                                ssm_li, plain)
            ssm_li += 1
            continue
        h = L.apply_norm(cfg.norm, p["ln1"], x)
        if kinds[i] == "hybrid":
            a = _paged_gqa_decode(p["attn"], cfg, h, pool_k, pool_v, i,
                                  tables, pos, specs[i], _layer_kvq(kvq, i),
                                  plain)
            s = _ssm_decode(p["ssm"], cfg, h, ssm_conv, ssm_ssm, ssm_li,
                            plain)
            ssm_li += 1
            x = lm.hybrid_ffn(p, cfg, x, a, s, plain=plain)
            continue
        if cfg.mla is not None:
            attn_out = _paged_mla_decode(p["attn"], cfg, h, pool_k, i,
                                         tables, pos, plain)
        else:
            attn_out = _paged_gqa_decode(p["attn"], cfg, h, pool_k, pool_v,
                                         i, tables, pos, specs[i],
                                         _layer_kvq(kvq, i), plain)
        x = _mlp_residual(kinds[i], p, cfg, x, h, attn_out, plain)
    return lm.unembed(cfg, misc, x)[:, 0]


# ---------------------------------------------------------------------------
# Whole-prompt prefill
# ---------------------------------------------------------------------------
def paged_prefill(cfg: ModelConfig, kinds, misc, layer_params, tokens,
                  pool_k, pool_v, block_ids, ssm_conv=None, ssm_ssm=None,
                  slot: int = 0, *, plain: bool = False):
    """Prefill ONE request (batch 1, padded length Sp <= len(block_ids)*bs).
    tokens: (1, Sp); block_ids: (nb,) — scratch 0 where padded. Scatters
    the KV into the pools in place, and each SSM layer's final state into
    row ``slot`` of ``ssm_conv``/``ssm_ssm``. Returns full logits
    (Sp, V)."""
    layer_list = list(zip(kinds, layer_params))
    logits, payloads = lm.prefill_collect(cfg, misc, layer_list, tokens,
                                          plain=plain)
    bs = pool_k.shape[2]
    nb = block_ids.shape[0]
    pad = nb * bs - tokens.shape[1]
    ids = block_ids.long()
    ssm_li = 0
    for i, payload in enumerate(payloads):
        for pool, t in _payload_rows(payload, pool_k, pool_v, 0) \
                if nb > 0 else ():
            if pad > 0:
                t = torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad))
            pool[i, ids] = t.reshape(nb, bs, *t.shape[1:]).to(pool.dtype)
        if "ssm_conv" in payload:
            ssm_conv[ssm_li, slot] = payload["ssm_conv"][0]
            ssm_ssm[ssm_li, slot] = payload["ssm_ssm"][0]
            ssm_li += 1
    return logits[0]


def _payload_rows(payload, pool_k, pool_v, row=None):
    """(pool, rows) pairs of one layer's prefill payload, batch row ``row``
    (all rows when None), shaped (..., S, KVH, Dh): k and v for GQA and
    hybrid; for MLA, the latent rows as the one kv head of ``pool_k``;
    none for an SSM layer."""
    sel = (lambda t: t if row is None else t[row])
    if "latent" in payload:
        return ((pool_k, sel(payload["latent"]).unsqueeze(-2)),)
    if "k" not in payload:
        return ()
    return ((pool_k, sel(payload["k"])), (pool_v, sel(payload["v"])))


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
            for pool, t in _payload_rows(payload, pool_k, pool_v):
                pool[i, ids] = t.reshape(P, nb, bs, *t.shape[2:]).to(
                    pool.dtype)
    rows = torch.arange(P, device=logits.device)
    return logits[rows, lens.long() - 1]


# ---------------------------------------------------------------------------
# Chunked prefill
# ---------------------------------------------------------------------------
def _chunk_gqa_attention(p, cfg, x, positions, pool_k, pool_v, li, tables,
                         blk, off, pos0, spec, kvq=None, plain=False):
    """Causal chunk attention against already-paged context (batch 1).

    x: (1, Cp, D) chunk activations at absolute positions ``positions``.
    The chunk's KV is scattered into layer ``li`` of the pool in place (pad
    positions land in blocks the next chunk overwrites, or in scratch 0),
    then the chunk attends through the chunk kernel route (K3) with its own
    (k, v) as operands: the walk covers only the already-paged context
    ``< pos0`` and never reads back what was just scattered. The operands
    are cast to the pool dtype first, so later chunks and decode read the
    same rounding the fold used. ``kvq``, the layer's quantized-KV slice,
    dequantizes the walked context (K3-q); the chunk's own KV is always
    fp."""
    B, Cp, _ = x.shape
    q, k, v = L.gqa_project_qkv(p, cfg, x, positions, plain=plain)
    pool_k[li, blk, off] = k[0].to(pool_k.dtype)
    pool_v[li, blk, off] = v[0].to(pool_v.dtype)
    out = ops.paged_prefill_attention(q, pool_k[li], pool_v[li],
                                      tables[None], pos0, spec,
                                      k_new=k, v_new=v, kv_quant=kvq,
                                      plain=plain)
    return qlinear.matmul(out.reshape(B, Cp, -1), p["wo"], bias=p.get("bo"),
                          plain=plain)


def _chunk_mla_attention(p, cfg, x, positions, pool_k, li, tables, blk,
                         off, pos0, spec, plain=False):
    """MLA chunk attention over the latent pool, absorbed (batch 1).

    The chunk's latent rows are scattered into layer ``li`` of the pool in
    place; the absorbed query (q_nope · W_uk, then q_rope, in float32)
    attends through the chunk route's latent mode (K3-mla) with the chunk's
    latent rows as its fused keys and values (the walk reads the pool only
    below ``pos0``); the (1, Cp, H, r) latent context is expanded through
    W_uv afterwards. Expects the absorbed attention params."""
    B, Cp, _ = x.shape
    q_nope, q_rope, c_kv_new, k_rope_new = L._mla_qkv(p, cfg, x, positions,
                                                      plain=plain)
    latent_new = torch.cat([c_kv_new[0], k_rope_new[0, :, 0]], -1)
    pool_k[li, blk, off, 0] = latent_new.to(pool_k.dtype)
    q_abs = torch.einsum("bshd,rhd->bshr", q_nope.to(torch.float32),
                         p["wk_abs"])
    q_lat = torch.cat([q_abs, q_rope.to(torch.float32)], -1)
    lat = latent_new[None, :, None, :]
    ctx = ops.paged_latent_chunk_attention(q_lat, pool_k[li], tables[None],
                                           pos0, spec, latent_new=lat,
                                           plain=plain)
    out = torch.einsum("bshr,rhd->bshd", ctx.to(torch.float32),
                       p["wv_abs"]).to(x.dtype)
    return qlinear.matmul(out.reshape(B, Cp, -1), p["wo"], plain=plain)


def paged_prefill_chunk(cfg: ModelConfig, kinds, specs, misc, layer_params,
                        tokens, pos0: int, pool_k, pool_v, tables, kvq=None,
                        *, plain: bool = False):
    """Prefill ONE chunk of ONE request against partially-paged context.

    tokens: (1, Cp) — the chunk, end-padded to a bucketed length; pos0: the
    absolute position of tokens[0] (the request's ``prefill_pos``); tables:
    (nb,) int32 block table whose span ``nb * bs`` covers ``pos0 + Cp``
    positions (scratch 0 where the request owns fewer blocks). Each layer
    appends the chunk's KV into the pool and runs causal attention of the
    chunk against everything paged so far (Sarathi-style chunked prefill);
    ``kvq`` is the pool's quantized-KV bundle or None. MLA layers take the
    absorbed params. Returns chunk logits (Cp, V)."""
    bs = pool_k.shape[2]
    Cp = tokens.shape[1]
    abs_pos = pos0 + torch.arange(Cp, device=tokens.device)
    positions = abs_pos[None, :]
    blk = tables.long()[abs_pos // bs]
    off = abs_pos % bs
    x = lm.embed_tokens(cfg, misc, tokens)
    for i, p in enumerate(layer_params):
        h = L.apply_norm(cfg.norm, p["ln1"], x)
        if cfg.mla is not None:
            attn_out = _chunk_mla_attention(p["attn"], cfg, h, positions,
                                            pool_k, i, tables, blk, off,
                                            pos0, specs[i], plain)
        else:
            attn_out = _chunk_gqa_attention(p["attn"], cfg, h, positions,
                                            pool_k, pool_v, i, tables, blk,
                                            off, pos0, specs[i],
                                            _layer_kvq(kvq, i), plain)
        x = _mlp_residual(kinds[i], p, cfg, x, h, attn_out, plain)
    return lm.unembed(cfg, misc, x)[0]


def absorb_mla_decode_weights(cfg: ModelConfig, layer_params):
    """The absorbed MLA projection of each layer: ``w_ukv`` (dense, or a
    QTensor dequantized here) becomes ``wk_abs`` (r, H, nope) and
    ``wv_abs`` (r, H, v) in float32, once per layer list rather than once
    per step. Layers without ``w_ukv`` pass through."""
    m = cfg.mla
    out = []
    for p in layer_params:
        attn = p.get("attn") if isinstance(p, dict) else None
        if attn is None or "w_ukv" not in attn:
            out.append(p)
            continue
        w = attn["w_ukv"]
        wd = (w.dequantize(torch.float32) if qlinear.is_quantized(w)
              else w.to(torch.float32))
        wd = wd.reshape(m.kv_lora_rank, cfg.n_heads,
                        m.qk_nope_head_dim + m.v_head_dim)
        attn = {k: v for k, v in attn.items() if k != "w_ukv"}
        attn["wk_abs"] = wd[..., :m.qk_nope_head_dim].contiguous()
        attn["wv_abs"] = wd[..., m.qk_nope_head_dim:].contiguous()
        out.append(dict(p, attn=attn))
    return tuple(out)


class ModelExec:
    """Binds a model's static parts (config, layer kinds, per-layer
    attention specs, embedding/head params) to the step functions; the
    per-level layer list is passed per call. Runs under ``no_grad``. For
    MLA, decode and chunk prefill take the absorbed weights, cached per
    layer list (the actuator hands out one stable list per swap level)."""

    def __init__(self, cfg: ModelConfig, params, kinds, kv_quant=False):
        self.cfg = cfg
        self.kinds = tuple(kinds)
        self.misc = {k: v for k, v in params.items() if k != "segments"}
        self.specs = build_attention_specs(cfg, self.kinds, kv_quant)
        self._absorb_cache: Dict[int, Tuple[Any, tuple]] = {}

    @staticmethod
    def _lp(layer_list) -> List:
        return [p for _, p in layer_list]

    def _absorbed(self, layer_list):
        """Per-layer params for decode and chunk prefill: for MLA, with the
        absorbed ``w_ukv`` (computed once per layer list)."""
        if self.cfg.mla is None:
            return self._lp(layer_list)
        hit = self._absorb_cache.get(id(layer_list))
        if hit is None or hit[0] is not layer_list:
            # keep the source list so that its id stays valid
            hit = (layer_list, absorb_mla_decode_weights(
                self.cfg, self._lp(layer_list)))
            self._absorb_cache[id(layer_list)] = hit
        return hit[1]

    @torch.no_grad()
    def decode(self, layer_list, tokens, pos, pool_k, pool_v, tables,
               ssm_conv=None, ssm_ssm=None, kvq=None, *, plain: bool = False):
        return paged_decode_step(self.cfg, self.kinds, self.specs, self.misc,
                                 self._absorbed(layer_list), tokens, pos,
                                 pool_k, pool_v, tables, ssm_conv, ssm_ssm,
                                 kvq, plain=plain)

    @torch.no_grad()
    def prefill(self, layer_list, tokens, pool_k, pool_v, block_ids,
                ssm_conv=None, ssm_ssm=None, slot: int = 0, *,
                plain: bool = False):
        return paged_prefill(self.cfg, self.kinds, self.misc,
                             self._lp(layer_list), tokens, pool_k, pool_v,
                             block_ids, ssm_conv, ssm_ssm, slot, plain=plain)

    @torch.no_grad()
    def prefill_batch(self, layer_list, tokens, pool_k, pool_v, tables, lens,
                      *, plain: bool = False):
        return paged_prefill_batch(self.cfg, self.kinds, self.misc,
                                   self._lp(layer_list), tokens, pool_k,
                                   pool_v, tables, lens, plain=plain)

    @torch.no_grad()
    def prefill_chunk(self, layer_list, tokens, pos0: int, pool_k, pool_v,
                      table, kvq=None, *, plain: bool = False):
        return paged_prefill_chunk(self.cfg, self.kinds, self.specs,
                                   self.misc, self._absorbed(layer_list),
                                   tokens, pos0, pool_k, pool_v, table, kvq,
                                   plain=plain)
