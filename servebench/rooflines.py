"""The frozen arithmetic: published peaks, each kernel launch's least time,
and the model FLOPs of a serving step.

Copied from ``chip_smoke.py`` (``wna16_bounds``, ``tensor_core_bounds`` and
the K2 bound of ``_decode_case``) and frozen here, so that a change to the
program cannot move the yardstick. Every count takes each input byte read
once and each output byte written once, and only the work the live rows
need: the live context of each decode row (not idle slots or table
padding), the causal pairs of each chunk, the rows each expert was given.
A launch's least time is the larger of its FLOPs over the bf16 tensor-core
peak and its bytes over the HBM rate, so a share of it can only read high
if the work is counted too high.
"""
from __future__ import annotations

from typing import Dict, Iterable, Sequence, Tuple

# NVIDIA H100 SXM data sheet, dense rates, at the full 700 W power limit
BF16_FLOP_S = 989e12
HBM_BYTES_S = 3.35e12


def least_s(flops: float, nbytes: float) -> float:
    """A launch's least time on the card, in seconds."""
    return max(flops / BF16_FLOP_S, nbytes / HBM_BYTES_S)


# ---------------------------------------------------------------------------
# K1: the wNa16 GEMM, one launch per quantized matmul (per expert with rows)
# ---------------------------------------------------------------------------
def wna16_work(M: int, K: int, N: int, bits: int, group: int,
               x_item: int = 2, out_item: int = 2) -> Tuple[float, float]:
    """(FLOPs, bytes) of one K1 launch: x (M, K), the packed weight and its
    float32 scales and zeros, the output (M, N)."""
    nbytes = (M * K * x_item + K * N * bits // 8
              + 2 * (K // group) * N * 4 + M * N * out_item)
    return 2.0 * M * K * N, float(nbytes)


# ---------------------------------------------------------------------------
# K2: the paged decode walk, one launch per GQA layer per decode step
# ---------------------------------------------------------------------------
def paged_decode_work(positions: Sequence[int], H: int, KVH: int, Dh: int,
                      block_size: int, pool_item: int = 2,
                      act_item: int = 2) -> Tuple[float, float]:
    """(FLOPs, bytes) of one K2 launch over the live rows: row b decodes the
    token at position p_b over the p_b tokens in the pool plus itself (its
    k/v enter fused). Bytes: each live row's query and output, its new k/v,
    its p_b pooled tokens of K and V, the live blocks of its table and its
    position."""
    flops = nbytes = 0.0
    for p in positions:
        flops += 4.0 * H * Dh * (p + 1)
        nbytes += (2 * H * Dh * act_item + 2 * KVH * Dh * pool_item
                   + p * 2 * KVH * Dh * pool_item
                   + -(-p // block_size) * 4 + 4)
    return flops, nbytes


# ---------------------------------------------------------------------------
# K3 / K3-mla: the chunk walk, one launch per attention layer per chunk
# ---------------------------------------------------------------------------
def causal_pairs(pos0: int, clen: int) -> float:
    """(query, key) pairs of a chunk of ``clen`` tokens after ``pos0``."""
    return clen * pos0 + clen * (clen + 1) / 2.0


def paged_chunk_work(pos0: int, clen: int, H: int, KVH: int, Dh: int,
                     block_size: int, pool_item: int = 2,
                     act_item: int = 2) -> Tuple[float, float]:
    """(FLOPs, bytes) of one K3 launch (GQA, the chunk's k/v fused): the
    chunk's queries, outputs and new k/v, the ``pos0`` pooled tokens it
    walks, the table's live blocks."""
    flops = 4.0 * H * Dh * causal_pairs(pos0, clen)
    nbytes = (2 * clen * H * Dh * act_item + clen * 2 * KVH * Dh * pool_item
              + pos0 * 2 * KVH * Dh * pool_item
              + -(-(pos0 + clen) // block_size) * 4)
    return flops, float(nbytes)


def paged_chunk_mla_work(pos0: int, clen: int, H: int, dk: int, dv: int,
                         block_size: int, pool_item: int = 2,
                         q_item: int = 4) -> Tuple[float, float]:
    """(FLOPs, bytes) of one K3-mla launch: absorbed float32 queries of
    ``dk`` lanes (latent + rope), outputs of ``dv`` (the latent), the
    chunk's latent rows fused, the ``pos0`` pooled latent rows."""
    pairs = causal_pairs(pos0, clen)
    flops = 2.0 * H * (dk + dv) * pairs
    nbytes = (clen * H * (dk + dv) * q_item + clen * dk * pool_item
              + pos0 * dk * pool_item + -(-(pos0 + clen) // block_size) * 4)
    return flops, float(nbytes)


# ---------------------------------------------------------------------------
# Model FLOPs of a serving step (step.mfu)
# ---------------------------------------------------------------------------
def layer_matmul_params(model: Dict, kind: str) -> Tuple[float, float]:
    """(matmul parameters a token goes through in one layer of ``kind``,
    attention FLOPs a (query, key) pair costs there), from the
    configuration's ``model`` section."""
    D, H = model["d_model"], model["n_heads"]
    mla = model.get("mla")
    if mla:
        qk = mla["qk_nope_head_dim"] + mla["qk_rope_head_dim"]
        attn = (D * mla["q_lora_rank"] + mla["q_lora_rank"] * H * qk
                + D * (mla["kv_lora_rank"] + mla["qk_rope_head_dim"])
                + mla["kv_lora_rank"] * H * (mla["qk_nope_head_dim"]
                                             + mla["v_head_dim"])
                + H * mla["v_head_dim"] * D)
        pair = 2.0 * H * (qk + mla["v_head_dim"])
    else:
        Dh = model.get("head_dim") or D // H
        KVH = model["n_kv_heads"]
        attn = 2 * D * H * Dh + 2 * D * KVH * Dh
        pair = 4.0 * H * Dh
    gated = model.get("gated_mlp", True)
    moe = model.get("moe")
    if kind in ("moe", "mla_moe"):
        F = moe["d_ff_expert"]
        ffn = (D * moe["n_routed_experts"]
               + (moe["top_k"] + moe["n_shared_experts"]) * 3 * D * F)
    else:
        ffn = (3 if gated else 2) * D * model["d_ff"]
    return float(attn + ffn), pair


def step_model_flops(model: Dict, kinds: Sequence[str],
                     decode_positions: Iterable[int],
                     chunks: Iterable[Tuple[int, int]],
                     outputs: int) -> float:
    """Model FLOPs of one step: each decode token (at its position) and
    each prompt segment ``(pos0, clen)`` through every layer, 2 FLOPs a
    matmul parameter and the attention pairs of its causal context, and the
    head once for each of the ``outputs`` tokens the step delivers."""
    dec = list(decode_positions)
    chunks = list(chunks)
    tokens = len(dec) + sum(c for _, c in chunks)
    pairs = sum(p + 1 for p in dec) + sum(causal_pairs(p0, c)
                                          for p0, c in chunks)
    total = 0.0
    for kind in kinds:
        params, pair = layer_matmul_params(model, kind)
        total += 2.0 * params * tokens + pair * pairs
    return total + 2.0 * model["d_model"] * model["vocab"] * outputs
