"""Model / shape / serving configuration dataclasses.

Every assigned architecture is expressed as a ``ModelConfig``; the four
assigned input shapes are ``ShapeSpec`` instances.  ``reduced()`` produces the
CPU-smoke variant of any config (same family/topology, tiny dims).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Model families
# ---------------------------------------------------------------------------
DENSE = "dense"
MOE = "moe"
SSM = "ssm"
HYBRID = "hybrid"
ENCDEC = "encdec"  # audio (whisper)
VLM = "vlm"


@dataclass(frozen=True)
class MoEConfig:
    n_routed_experts: int = 0
    top_k: int = 1
    n_shared_experts: int = 0
    d_ff_expert: int = 0            # per-expert hidden dim
    first_k_dense: int = 0          # leading dense layers (deepseek-v3: 3)
    moe_layer_step: int = 1         # 2 => every other layer is MoE (llama4)
    router_aux_free_bias: bool = False  # deepseek-v3 aux-loss-free balancing
    routed_scaling_factor: float = 1.0


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head latent attention (DeepSeek-V2/V3)."""
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 (SSD) block parameters."""
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64              # SSD head dim; n_heads = d_inner/head_dim
    n_groups: int = 1
    chunk_size: int = 128           # SSD block-scan chunk


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int                    # 0 for attention-free archs
    n_kv_heads: int
    d_ff: int                       # dense-layer FFN hidden dim
    vocab: int
    head_dim: int = 0               # 0 => d_model // n_heads
    # --- block topology -----------------------------------------------------
    norm: str = "rmsnorm"           # rmsnorm | layernorm | nonparam_ln
    act: str = "silu"               # silu | gelu | sqrelu (squared ReLU)
    gated_mlp: bool = True          # SwiGLU-style two-matrix up path
    qkv_bias: bool = False
    attn_out_bias: bool = False
    mlp_bias: bool = False
    parallel_block: bool = False    # command-r: x + attn(ln x) + mlp(ln x)
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0      # nemotron uses partial rotary
    sliding_window: int = 0         # 0 => full attention
    global_attn_layers: Tuple[int, ...] = ()  # hymba: full-attn exceptions
    logit_softcap: float = 0.0
    # --- sub-configs ----------------------------------------------------------
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    # --- enc-dec (whisper) ----------------------------------------------------
    n_encoder_layers: int = 0
    encoder_seq: int = 0            # precomputed frame/patch count (stub frontend)
    frontend_dim: int = 0           # stub embedding dim fed to the adapter
    # --- vlm ------------------------------------------------------------------
    n_image_tokens: int = 0
    # --- numerics ---------------------------------------------------------------
    dtype: str = "bfloat16"
    # --- bookkeeping ------------------------------------------------------------
    source: str = ""                # provenance citation

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        if self.n_heads:
            return self.d_model // self.n_heads
        return 0

    @property
    def is_attention_free(self) -> bool:
        return self.family == SSM

    @property
    def subquadratic(self) -> bool:
        """True when a 500k-token decode is architecturally sensible."""
        return self.family in (SSM, HYBRID)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                       # train | prefill | decode


TRAIN_4K = ShapeSpec("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeSpec("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeSpec("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeSpec("long_500k", 524288, 1, "decode")
ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in ALL_SHAPES}


def applicable_shapes(cfg: ModelConfig):
    """The assigned-shape cells that are architecturally valid for ``cfg``.

    long_500k is sub-quadratic-only per the assignment; all archs here have a
    decode step (whisper is enc-dec, not encoder-only).
    """
    out = []
    for s in ALL_SHAPES:
        if s.name == "long_500k" and not cfg.subquadratic:
            continue
        out.append(s)
    return tuple(out)


# ---------------------------------------------------------------------------
# Serving-side configuration
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ServingConfig:
    """Engine + morphing policy knobs (paper §3, §4)."""
    hbm_budget_bytes: int = 16 * 2**30      # per-device budget (v5e: 16 GiB)
    kv_block_size: int = 16                  # tokens per paged-KV block
    max_batch_slots: int = 32                # decode slots (padded batch)
    max_seq_len: int = 4096
    max_blocks_per_seq: int = 0              # 0 => derived from max_seq_len
    # morphing thresholds (paper: KV usage > 85 %, queue delay > 100 ms)
    kv_pressure_high: float = 0.85
    kv_pressure_low: float = 0.60
    queue_delay_high_s: float = 0.100
    ttft_slo_s: float = 2.0
    monitor_window_s: float = 1.0
    # swap policy
    swap_levels: Tuple[int, ...] = (0, 1, 2, 4, 8, 16)   # bucketed #quantized layers
    swap_bits: int = 4
    # route every swapped-layer matmul through the fused wNa16 kernel path
    # (kernels/ops.wna16_matmul) instead of dequant-then-matmul
    use_quant_kernel: bool = False
    mode: str = "accuracy"                   # accuracy | performance
    # performance mode swaps earlier and deeper (paper §4 Baselines)
    perf_kv_pressure_high: float = 0.70
    perf_max_level_frac: float = 1.0         # fraction of layers swappable
    acc_max_level_frac: float = 0.5
    # KV resize buckets (fractions of baseline pool growable)
    kv_resize_step_frac: float = 0.125
    # restore hysteresis: with no high-pressure event for this long, step the
    # swap level back down even if kv usage sits in the [low, high) dead band
    # (a grown pool parks usage there after a burst, which used to wedge the
    # level at max for the rest of the trace — the paper's degradation is
    # transient, so calm alone must be enough to begin restoring)
    restore_patience_s: float = 1.0

    def max_level(self, n_layers: int) -> int:
        frac = (self.perf_max_level_frac if self.mode == "performance"
                else self.acc_max_level_frac)
        cap = int(round(n_layers * frac))
        valid = [l for l in self.swap_levels if l <= cap] or [0]
        return max(valid)
