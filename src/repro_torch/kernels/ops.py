"""The kernel routes of the data plane.

Each route takes the JAX package's layouts and picks its path from the
device of the tensor it is given, with no environment variable and no
fallback: a CUDA tensor goes to the hand-written kernel (which launches or
raises), a CPU tensor to the kernel's plain torch version in
:mod:`repro_torch.kernels.ref`. ``plain=True`` asks for the plain version
on any device; only the step-parity checks use it.

One :class:`AttentionSpec` carries the static attention configuration of a
layer (window, softcap, scale, head layout), built once per layer by
``engine.model_exec.build_attention_specs``.

The attention routes take the layer's quantized-KV bundle ``kv_quant=(qk,
qv, k_scale, v_scale, k_zero, v_zero)`` (the pool's sidecar, see
``engine.kv_cache.PagedKVPool.kv_quant_bundle``) or None while no block is
quantized; on a CUDA tensor a bundle selects the kernels' KVQ lane. A
bundle reaching a spec built without ``kv_quant`` raises.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.kernels import ref


@dataclasses.dataclass(frozen=True)
class AttentionSpec:
    """Static attention configuration shared by decode and chunk prefill.

    ``scale=None`` means ``head_dim ** -0.5``. ``q_heads``/``kv_heads`` are
    the head layout (GQA group = q_heads // kv_heads), checked when given.
    ``kv_quant`` marks the layer's pool as one that may hold quantized
    blocks (the engine's quantize-cold tier is on); the bundle itself is
    passed per call, and a bundle given to a spec without ``kv_quant`` is
    refused. ``latent_dv`` selects the MLA latent mode of chunk attention
    (:func:`paged_latent_chunk_attention`): keys and values are one latent
    pool of width ``kv_lora_rank + rope`` (``kv_heads == 1``), scores span
    the full width and values keep its first ``latent_dv`` (=
    ``kv_lora_rank``) lanes; it takes no quantized-KV bundle, and the GQA
    routes refuse it (MLA decode is plain torch in ``engine.model_exec``)."""
    window: int = 0
    softcap: float = 0.0
    scale: Optional[float] = None
    q_heads: Optional[int] = None
    kv_heads: Optional[int] = None
    latent_dv: Optional[int] = None
    kv_quant: bool = False

    def validate(self, q, k_pool, kv_quant=None) -> None:
        if kv_quant is not None and not self.kv_quant:
            raise ValueError("a kv_quant bundle reached an AttentionSpec "
                             "built with kv_quant=False")
        if self.latent_dv is not None:
            if k_pool.shape[2] != 1:
                raise ValueError("the MLA latent mode needs one kv head, "
                                 f"not a pool {tuple(k_pool.shape)}")
            if not 0 < self.latent_dv < k_pool.shape[3]:
                raise ValueError(f"latent_dv={self.latent_dv} must be below "
                                 f"the latent width {k_pool.shape[3]}")
            if self.kv_quant:
                raise ValueError("the MLA latent pool keeps fp blocks: a "
                                 "latent spec takes no kv_quant")
        if self.q_heads is not None and q.shape[-2] != self.q_heads:
            raise ValueError(f"q heads {q.shape[-2]} != spec {self.q_heads}")
        if self.kv_heads is not None and k_pool.shape[2] != self.kv_heads:
            raise ValueError(f"pool kv heads {k_pool.shape[2]} != spec "
                             f"{self.kv_heads}")

    def resolved_scale(self, head_dim: int) -> float:
        return head_dim ** -0.5 if self.scale is None else self.scale


def _on_card(t: torch.Tensor, plain: bool) -> bool:
    """True when the route launches the CUDA kernel for tensor ``t``."""
    if plain or t.device.type == "cpu":
        return False
    if t.device.type == "cuda":
        return True
    raise ValueError(f"no kernel route for a tensor on {t.device}")


# ---------------------------------------------------------------------------
# wNa16 quantized matmul (K1)
# ---------------------------------------------------------------------------
def wna16_matmul(x2: torch.Tensor, qt, *, bias=None,
                 plain: bool = False) -> torch.Tensor:
    """x2 (M, K) × int4/int8 QTensor (K, N) → (M, N) in x2's dtype, with
    the AWQ ``inv_act``, ``bias`` and the output cast fused. A ``meta``
    x2 (the dry run's shapes, which hold no data) takes the plain version,
    whose matmul the dry run counts."""
    if qt.bits not in (4, 8):
        raise ValueError(f"wNa16 takes int4/int8 weights, not int{qt.bits}")
    inv = None if qt.inv_act is None else qt.inv_act.to(torch.float32)
    b = None if bias is None else bias.to(torch.float32)
    if x2.is_meta or not _on_card(x2, plain):
        return ref.wna16_ref(x2, qt.packed, qt.scales, qt.zeros, inv, b,
                             bits=qt.bits, group=qt.group)
    from repro_torch.kernels.wna16_gemm import wna16_gemm
    x2 = x2.contiguous()
    if x2.data_ptr() % 16:   # the kernel copies x in 16-byte chunks
        x2 = x2.clone()
    return wna16_gemm(x2, qt.packed, qt.scales, qt.zeros, inv, b,
                      bits=qt.bits, group=qt.group)


# ---------------------------------------------------------------------------
# paged attention (K2 decode, K3 chunk prefill)
# ---------------------------------------------------------------------------
def _decode_spec(spec, q, k_pool, kv_quant) -> AttentionSpec:
    spec = spec or AttentionSpec()
    if spec.latent_dv is not None:
        raise ValueError("the MLA latent mode is a chunk-attention lane; "
                         "MLA decode is plain torch (model_exec)")
    spec.validate(q, k_pool, kv_quant)
    return spec


def paged_attention(q, k_pool, v_pool, block_tables, context_lens,
                    spec: AttentionSpec = None, *, kv_quant=None,
                    plain: bool = False):
    """Context-only decode read: every ``context_lens[b]`` token lives in
    the pool and the query is the one at ``context_lens[b] - 1``."""
    spec = _decode_spec(spec, q, k_pool, kv_quant)
    kw = dict(scale=spec.resolved_scale(q.shape[-1]), window=spec.window,
              softcap=spec.softcap, fused_new=False, kv_quant=kv_quant)
    if not _on_card(q, plain):
        return ref.paged_decode_ref(q, None, None, k_pool, v_pool,
                                    block_tables, context_lens, **kw)
    from repro_torch.kernels.paged_attention import paged_decode
    return paged_decode(q, None, None, k_pool, v_pool, block_tables,
                        context_lens, **kw)


def paged_decode_attention(q, k_new, v_new, k_pool, v_pool, block_tables,
                           pos, spec: AttentionSpec = None, *, kv_quant=None,
                           plain: bool = False):
    """Decode attention over the pool's first ``pos[b]`` tokens plus the
    current token (k_new, v_new) (B, KVH, Dh) at position ``pos[b]``, which
    is cast to the pool dtype and never read back from the pool (the
    caller's scatter of it into the pool is independent of this read)."""
    spec = _decode_spec(spec, q, k_pool, kv_quant)
    kn = k_new.to(k_pool.dtype).contiguous()
    vn = v_new.to(v_pool.dtype).contiguous()
    kw = dict(scale=spec.resolved_scale(q.shape[-1]), window=spec.window,
              softcap=spec.softcap, fused_new=True, kv_quant=kv_quant)
    if not _on_card(q, plain):
        return ref.paged_decode_ref(q, kn, vn, k_pool, v_pool, block_tables,
                                    pos, **kw)
    from repro_torch.kernels.paged_attention import paged_decode
    return paged_decode(q.contiguous(), kn, vn, k_pool, v_pool,
                        block_tables, pos, **kw)


def paged_prefill_attention(q, k_pool, v_pool, block_tables, pos0: int,
                            spec: AttentionSpec = None, *, k_new=None,
                            v_new=None, kv_quant=None, plain: bool = False):
    """Chunk attention: C queries (B, C, H, Dh) at positions ``pos0 + i``.
    With the chunk's (k_new, v_new) (B, C, KVH, Dh) they enter as operands
    and the pool is read only below ``pos0``; without them the chunk's KV is
    read back from the pool, where the caller has scattered it. A latent
    spec is refused: MLA goes through :func:`paged_latent_chunk_attention`."""
    spec = spec or AttentionSpec()
    if spec.latent_dv is not None:
        raise ValueError("an MLA latent spec takes the latent route "
                         "(paged_latent_chunk_attention)")
    spec.validate(q, k_pool, kv_quant)
    fused = k_new is not None
    kn = vn = None
    if fused:
        kn = k_new.to(k_pool.dtype).contiguous()
        vn = v_new.to(v_pool.dtype).contiguous()
    kw = dict(scale=spec.resolved_scale(q.shape[-1]), window=spec.window,
              softcap=spec.softcap, fused_new=fused, kv_quant=kv_quant)
    if not _on_card(q, plain):
        return ref.paged_chunk_ref(q, kn, vn, k_pool, v_pool, block_tables,
                                   pos0, **kw)
    from repro_torch.kernels.paged_attention import paged_chunk
    return paged_chunk(q.contiguous(), kn, vn, k_pool, v_pool, block_tables,
                       pos0, **kw)


def paged_latent_chunk_attention(q, pool, block_tables, pos0: int,
                                 spec: AttentionSpec, *, latent_new=None,
                                 plain: bool = False):
    """K3's MLA latent mode (K3-mla): the absorbed queries q (B, C, H, Dh)
    at positions ``pos0 + i`` over the one latent pool (cap, bs, 1, Dh),
    which serves as keys over all Dh lanes and as values over the first
    ``spec.latent_dv``. With the chunk's latent rows ``latent_new`` (B, C,
    1, Dh) they enter as fused keys and values and the pool is read only
    below ``pos0``; without them they are read back from the pool. Returns
    (B, C, H, latent_dv), scaled by the spec's explicit ``scale``."""
    if spec.latent_dv is None:
        raise ValueError("the latent route takes a spec with latent_dv")
    spec.validate(q, pool)
    fused = latent_new is not None
    ln = latent_new.to(pool.dtype).contiguous() if fused else None
    kw = dict(scale=spec.resolved_scale(q.shape[-1]), window=spec.window,
              softcap=spec.softcap, fused_new=fused)
    if not _on_card(q, plain):
        return ref.paged_chunk_ref(q, ln, ln, pool, pool, block_tables, pos0,
                                   dv=spec.latent_dv, **kw)
    from repro_torch.kernels.paged_attention import paged_chunk_mla
    return paged_chunk_mla(q.contiguous(), ln, pool, block_tables, pos0,
                           dv=spec.latent_dv, **kw)
