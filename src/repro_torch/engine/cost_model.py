"""Roofline step-time model for the virtual serving clock.

The engine's serving clock is virtual: it advances by max(compute,
weight-traffic, kv-traffic) per step for a target hardware profile — the same three-term model as §Roofline. This is
what lets the 72-second paper traces reproduce saturation behaviour
(Fig. 1b / Fig. 6) at realistic scale while the actual tokens come from real
compute (or from ``sim_token`` in sim compute). A virtual-clock time is a
model output, never a measurement of the card.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig
from repro_torch.engine.kv_cache import kv_block_bytes


@dataclasses.dataclass(frozen=True)
class HardwareProfile:
    name: str
    flops: float                     # peak dense bf16/fp16 FLOP/s
    hbm_bw: float                    # bytes/s
    hbm_bytes: int
    host_link_bps: float = 26e9     # PCIe gen4-class (paper §3.3)


NVIDIA_L4 = HardwareProfile("l4", 121e12, 300e9, 24 * 2**30)
NVIDIA_A100_80G = HardwareProfile("a100-80g", 312e12, 2039e9, 80 * 2**30)
TPU_V5E = HardwareProfile("v5e", 197e12, 819e9, 16 * 2**30)
# published dense bf16 peak and HBM3 rate of the SXM part
NVIDIA_H100_SXM = HardwareProfile("h100-sxm", 989e12, 3.35e12, 80 * 10**9)
PROFILES = {p.name: p for p in (NVIDIA_L4, NVIDIA_A100_80G, TPU_V5E,
                                NVIDIA_H100_SXM)}


def active_params(cfg: ModelConfig) -> int:
    """Parameters touched per token (MoE: shared + top-k experts only)."""
    d, L, V = cfg.d_model, cfg.n_layers, cfg.vocab
    total = 2 * V * d                     # embed + head (tied counts once; keep 2 as upper)
    for i in range(L):
        if cfg.mla is not None:
            m = cfg.mla
            qk = m.qk_nope_head_dim + m.qk_rope_head_dim
            attn = (d * m.q_lora_rank + m.q_lora_rank * cfg.n_heads * qk
                    + d * (m.kv_lora_rank + m.qk_rope_head_dim)
                    + m.kv_lora_rank * cfg.n_heads *
                    (m.qk_nope_head_dim + m.v_head_dim)
                    + cfg.n_heads * m.v_head_dim * d)
        elif cfg.n_heads:
            dh = cfg.resolved_head_dim
            attn = d * (cfg.n_heads * dh) * 2 + d * (cfg.n_kv_heads * dh) * 2
        else:
            attn = 0
        if cfg.family == "ssm" or cfg.family == "hybrid":
            s = cfg.ssm
            di = s.expand * d
            ssm = d * (2 * di + 2 * s.n_groups * s.d_state
                       + di // s.head_dim) + di * d
            attn += ssm
        if cfg.moe is not None and _is_moe_layer(cfg, i):
            f = cfg.moe.d_ff_expert
            mlp = (cfg.moe.top_k + cfg.moe.n_shared_experts) * 3 * d * f
            mlp += d * cfg.moe.n_routed_experts     # router
        elif cfg.d_ff:
            mlp = (3 if cfg.gated_mlp else 2) * d * cfg.d_ff
        else:
            mlp = 0
        total += attn + mlp
    return total


def total_params(cfg: ModelConfig) -> int:
    if cfg.moe is None:
        return active_params(cfg)
    base = active_params(cfg)
    f = cfg.moe.d_ff_expert
    n_moe = sum(_is_moe_layer(cfg, i) for i in range(cfg.n_layers))
    extra = n_moe * (cfg.moe.n_routed_experts - cfg.moe.top_k) * 3 * cfg.d_model * f
    return base + extra


def _is_moe_layer(cfg, i) -> bool:
    mc = cfg.moe
    return (i >= mc.first_k_dense
            and (i - mc.first_k_dense) % mc.moe_layer_step
            == mc.moe_layer_step - 1)


def weight_bytes_at_level(cfg: ModelConfig, level: int, n_layers_swapped_bits=4,
                          dtype_bytes: int = 2) -> float:
    """Approximate device weight bytes with ``level`` layers at int4."""
    per_layer = total_params(cfg) / max(cfg.n_layers, 1)
    frac = n_layers_swapped_bits / (8 * dtype_bytes)
    full = total_params(cfg) * dtype_bytes
    return full - level * per_layer * dtype_bytes * (1 - frac)


@dataclasses.dataclass
class CostModel:
    cfg: ModelConfig
    hw: HardwareProfile
    block_size: int = 16
    dtype_bytes: int = 2
    fixed_overhead_s: float = 2e-4    # launch/dispatch floor per step

    def __post_init__(self):
        self._active = active_params(self.cfg)
        self._total = total_params(self.cfg)
        self._kvb = kv_block_bytes(self.cfg, self.block_size,
                                   self.dtype_bytes)

    def kv_bytes_per_token(self) -> float:
        return self._kvb / self.block_size if self._kvb else 0.0

    def decode_step_time(self, batch: int, total_ctx_tokens: int,
                         weight_bytes: float, level_frac_flops: float = 1.0
                         ) -> float:
        """One decode-only step (a mixed step with no prefill tokens)."""
        return self.mixed_step_time(batch, total_ctx_tokens, 0, 0.0, 0,
                                    weight_bytes, level_frac_flops)

    def mixed_step_time(self, decode_batch: int, decode_ctx_tokens: int,
                        prefill_tokens: int, prefill_attn_pairs: float,
                        prefill_kv_tokens: int, weight_bytes: float,
                        level_frac_flops: float = 1.0) -> float:
        """One token-budgeted engine step: ``decode_batch`` single-token
        decodes over ``decode_ctx_tokens`` of live KV plus ``prefill_tokens``
        prompt-chunk tokens packed into the same iteration.

        ``prefill_attn_pairs`` is the number of causal (q, kv) score pairs
        across this step's chunks (sum of clen·pos0 + clen²/2 — the chunk
        attends to everything already paged); ``prefill_kv_tokens`` is the
        paged context the chunks re-read. Weights are fetched once for the
        whole mixed batch — the reason packing chunks beside decodes beats
        running them as separate steps."""
        if decode_batch == 0 and prefill_tokens == 0:
            return self.fixed_overhead_s
        flops = (2.0 * self._active * (decode_batch + prefill_tokens)
                 * level_frac_flops)
        if self.cfg.n_heads and prefill_attn_pairs:
            h, dh = cfg_heads(self.cfg)
            flops += 4.0 * self.cfg.n_layers * h * dh * prefill_attn_pairs
        kv_read = ((decode_ctx_tokens + prefill_kv_tokens)
                   * self.kv_bytes_per_token())
        t_compute = flops / self.hw.flops
        t_mem = (weight_bytes + kv_read) / self.hw.hbm_bw
        return max(t_compute, t_mem) + self.fixed_overhead_s

    def queue_delay_estimate(self, backlog_tokens: int, tokens_per_step: int,
                             decode_batch: int = 0,
                             decode_ctx_tokens: int = 0,
                             weight_bytes: float = 0.0) -> float:
        """Estimated seconds until ``backlog_tokens`` of queued prefill work
        clears at the live per-step token budget, with ``decode_batch``
        running decodes sharing every step.

        This is the admission controller's crystal ball: a request whose
        class deadline falls inside this estimate (with no morph-relief
        headroom left) is shed at the front door instead of timing out
        silently. Monotone in ``backlog_tokens`` by construction — more
        backlog can never yield a smaller estimate (pinned by tests)."""
        if backlog_tokens <= 0:
            return 0.0
        per = max(int(tokens_per_step), 1)
        steps = -(-backlog_tokens // per)
        chunk = min(backlog_tokens, per)
        dt = self.mixed_step_time(decode_batch, decode_ctx_tokens, chunk,
                                  chunk * chunk / 2, 0, weight_bytes)
        return steps * dt

    def kv_migration_bytes(self, n_blocks: int,
                           compress_ratio: float = 1.0) -> int:
        """Wire bytes for ``n_blocks`` paged-KV blocks (all layers, k+v),
        optionally compressed in flight (e.g. int8: ratio 1/dtype_bytes)."""
        return int(n_blocks * self._kvb * compress_ratio)

    def kv_migration_time(self, n_blocks: int, link_bps: float,
                          latency_s: float = 0.0,
                          compress_ratio: float = 1.0) -> float:
        """Modeled cross-replica transfer time for a request's KV blocks:
        per-transfer setup latency + wire bytes over the inter-replica link.
        This is the cost the control plane weighs against a from-scratch
        re-prefill when deciding whether migration is worth it."""
        return latency_s + self.kv_migration_bytes(
            n_blocks, compress_ratio) / max(link_bps, 1.0)

    def prefill_time(self, prompt_tokens: int) -> float:
        """A whole prompt as its own step (fp16-resident weights)."""
        return self.mixed_step_time(0, 0, prompt_tokens,
                                    prompt_tokens * prompt_tokens / 2, 0,
                                    self._total * self.dtype_bytes)


def cfg_heads(cfg: ModelConfig):
    return max(cfg.n_heads, 1), max(cfg.resolved_head_dim, 1)
