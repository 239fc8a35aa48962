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
    The JAX spec's MLA ``latent_dv`` and ``kv_quant`` lanes are not ported
    yet (ROADMAP queue 2)."""
    window: int = 0
    softcap: float = 0.0
    scale: Optional[float] = None
    q_heads: Optional[int] = None
    kv_heads: Optional[int] = None

    def validate(self, q, k_pool) -> None:
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
    the AWQ ``inv_act``, ``bias`` and the output cast fused."""
    if qt.bits not in (4, 8):
        raise ValueError(f"wNa16 takes int4/int8 weights, not int{qt.bits}")
    inv = None if qt.inv_act is None else qt.inv_act.to(torch.float32)
    b = None if bias is None else bias.to(torch.float32)
    if not _on_card(x2, plain):
        return ref.wna16_ref(x2, qt.packed, qt.scales, qt.zeros, inv, b,
                             bits=qt.bits, group=qt.group)
    from repro_torch.kernels.wna16_gemm import wna16_gemm
    return wna16_gemm(x2.contiguous(), qt.packed, qt.scales, qt.zeros, inv,
                      b, bits=qt.bits, group=qt.group)


# ---------------------------------------------------------------------------
# paged attention (K2 decode, K3 chunk prefill)
# ---------------------------------------------------------------------------
def paged_attention(q, k_pool, v_pool, block_tables, context_lens,
                    spec: AttentionSpec = None, *, plain: bool = False):
    """Context-only decode read: every ``context_lens[b]`` token lives in
    the pool and the query is the one at ``context_lens[b] - 1``."""
    spec = spec or AttentionSpec()
    spec.validate(q, k_pool)
    kw = dict(scale=spec.resolved_scale(q.shape[-1]), window=spec.window,
              softcap=spec.softcap, fused_new=False)
    if not _on_card(q, plain):
        return ref.paged_decode_ref(q, None, None, k_pool, v_pool,
                                    block_tables, context_lens, **kw)
    from repro_torch.kernels.paged_attention import paged_decode
    return paged_decode(q, None, None, k_pool, v_pool, block_tables,
                        context_lens, **kw)


def paged_decode_attention(q, k_new, v_new, k_pool, v_pool, block_tables,
                           pos, spec: AttentionSpec = None, *,
                           plain: bool = False):
    """Decode attention over the pool's first ``pos[b]`` tokens plus the
    current token (k_new, v_new) (B, KVH, Dh) at position ``pos[b]``, which
    is cast to the pool dtype and never read back from the pool (the
    caller's scatter of it into the pool is independent of this read)."""
    spec = spec or AttentionSpec()
    spec.validate(q, k_pool)
    kn = k_new.to(k_pool.dtype).contiguous()
    vn = v_new.to(v_pool.dtype).contiguous()
    kw = dict(scale=spec.resolved_scale(q.shape[-1]), window=spec.window,
              softcap=spec.softcap, fused_new=True)
    if not _on_card(q, plain):
        return ref.paged_decode_ref(q, kn, vn, k_pool, v_pool, block_tables,
                                    pos, **kw)
    from repro_torch.kernels.paged_attention import paged_decode
    return paged_decode(q.contiguous(), kn, vn, k_pool, v_pool,
                        block_tables, pos, **kw)


def paged_prefill_attention(q, k_pool, v_pool, block_tables, pos0: int,
                            spec: AttentionSpec = None, *, k_new=None,
                            v_new=None, plain: bool = False):
    """Chunk attention: C queries (B, C, H, Dh) at positions ``pos0 + i``.
    With the chunk's (k_new, v_new) (B, C, KVH, Dh) they enter as operands
    and the pool is read only below ``pos0``; without them the chunk's KV is
    read back from the pool, where the caller has scattered it."""
    spec = spec or AttentionSpec()
    spec.validate(q, k_pool)
    fused = k_new is not None
    kn = vn = None
    if fused:
        kn = k_new.to(k_pool.dtype).contiguous()
        vn = v_new.to(v_pool.dtype).contiguous()
    kw = dict(scale=spec.resolved_scale(q.shape[-1]), window=spec.window,
              softcap=spec.softcap, fused_new=fused)
    if not _on_card(q, plain):
        return ref.paged_chunk_ref(q, kn, vn, k_pool, v_pool, block_tables,
                                   pos0, **kw)
    from repro_torch.kernels.paged_attention import paged_chunk
    return paged_chunk(q.contiguous(), kn, vn, k_pool, v_pool, block_tables,
                       pos0, **kw)
