"""The 10 assigned architectures (+ the paper's own Llama-2-7B-class config).

Exact dims from the assignment brief; provenance in ``source``. ``reduced()``
yields the same-family CPU-smoke config (tiny dims, same topology).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs.base import (DENSE, ENCDEC, HYBRID, MOE, SSM, VLM,
                                MLAConfig, ModelConfig, MoEConfig, SSMConfig)

HYMBA_1P5B = ModelConfig(
    name="hymba-1.5b", family=HYBRID, n_layers=32, d_model=1600, n_heads=25,
    n_kv_heads=5, d_ff=5504, vocab=32001, head_dim=64,
    sliding_window=1024, global_attn_layers=(0, 15, 31),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=64, n_groups=1),
    source="arXiv:2411.13676 (parallel attn+mamba heads; SWA + 3 global)")

DEEPSEEK_V3_671B = ModelConfig(
    name="deepseek-v3-671b", family=MOE, n_layers=61, d_model=7168,
    n_heads=128, n_kv_heads=128, d_ff=18432, vocab=129280,
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(n_routed_experts=256, top_k=8, n_shared_experts=1,
                  d_ff_expert=2048, first_k_dense=3,
                  router_aux_free_bias=True, routed_scaling_factor=2.5),
    source="arXiv:2412.19437 (MLA, 1 shared + 256 routed top-8; MTP head "
           "implemented as optional extra-predict branch)")

LLAMA4_MAVERICK_400B = ModelConfig(
    name="llama4-maverick-400b-a17b", family=MOE, n_layers=48, d_model=5120,
    n_heads=40, n_kv_heads=8, d_ff=16384, vocab=202048,
    moe=MoEConfig(n_routed_experts=128, top_k=1, n_shared_experts=1,
                  d_ff_expert=8192, moe_layer_step=2),
    source="hf:meta-llama/Llama-4 (unverified); interleaved MoE every other "
           "layer, expert d_ff=8192 per assignment, dense-layer d_ff=16384; "
           "early fusion → text backbone only (no [vlm] tag assigned)")

WHISPER_SMALL = ModelConfig(
    name="whisper-small", family=ENCDEC, n_layers=12, d_model=768, n_heads=12,
    n_kv_heads=12, d_ff=3072, vocab=51865, norm="layernorm", act="gelu",
    gated_mlp=False, qkv_bias=True, attn_out_bias=True, mlp_bias=True,
    tie_embeddings=True, n_encoder_layers=12, encoder_seq=1500,
    frontend_dim=768,
    source="arXiv:2212.04356 (enc-dec; conv frontend stubbed per assignment)")

OLMO_1B = ModelConfig(
    name="olmo-1b", family=DENSE, n_layers=16, d_model=2048, n_heads=16,
    n_kv_heads=16, d_ff=8192, vocab=50304, norm="nonparam_ln",
    source="arXiv:2402.00838 (non-parametric LN, SwiGLU, no biases)")

COMMAND_R_PLUS_104B = ModelConfig(
    name="command-r-plus-104b", family=DENSE, n_layers=64, d_model=12288,
    n_heads=96, n_kv_heads=8, d_ff=33792, vocab=256000, norm="layernorm",
    parallel_block=True,
    source="hf:CohereForAI (unverified); GQA kv=8, parallel attn+FFN, no bias")

QWEN2_1P5B = ModelConfig(
    name="qwen2-1.5b", family=DENSE, n_layers=28, d_model=1536, n_heads=12,
    n_kv_heads=2, d_ff=8960, vocab=151936, qkv_bias=True, tie_embeddings=True,
    rope_theta=1e6,
    source="arXiv:2407.10671 (GQA kv=2, QKV bias, tied embeddings)")

NEMOTRON_4_15B = ModelConfig(
    name="nemotron-4-15b", family=DENSE, n_layers=32, d_model=6144,
    n_heads=48, n_kv_heads=8, d_ff=24576, vocab=256000, norm="layernorm",
    act="sqrelu", gated_mlp=False, rope_fraction=0.5,
    source="arXiv:2402.16819 (squared-ReLU, partial rotary)")

MAMBA2_780M = ModelConfig(
    name="mamba2-780m", family=SSM, n_layers=48, d_model=1536, n_heads=0,
    n_kv_heads=0, d_ff=0, vocab=50280,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, n_groups=1),
    source="arXiv:2405.21060 (SSD; attn-free)")

INTERNVL2_1B = ModelConfig(
    name="internvl2-1b", family=VLM, n_layers=24, d_model=896, n_heads=14,
    n_kv_heads=2, d_ff=4864, vocab=151655, qkv_bias=True, tie_embeddings=True,
    rope_theta=1e6, n_image_tokens=256, frontend_dim=1024,
    source="arXiv:2404.16821 (InternViT stubbed → patch embeds; Qwen2-0.5B "
           "backbone dims)")

# The paper's own evaluation family (Llama-2-7B class) — used by the serving
# benchmarks as the 'paper config'.
MORPH_LLAMA2_7B = ModelConfig(
    name="morph-llama2-7b", family=DENSE, n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=32, d_ff=11008, vocab=32000,
    source="arXiv:2307.09288 (paper's primary eval model)")

ASSIGNED: Dict[str, ModelConfig] = {
    c.name: c for c in [
        HYMBA_1P5B, DEEPSEEK_V3_671B, LLAMA4_MAVERICK_400B, WHISPER_SMALL,
        OLMO_1B, COMMAND_R_PLUS_104B, QWEN2_1P5B, NEMOTRON_4_15B,
        MAMBA2_780M, INTERNVL2_1B]
}
ALL_CONFIGS: Dict[str, ModelConfig] = dict(ASSIGNED,
                                           **{MORPH_LLAMA2_7B.name: MORPH_LLAMA2_7B})


def get_config(name: str) -> ModelConfig:
    if name not in ALL_CONFIGS:
        raise KeyError(f"unknown arch '{name}'; have {sorted(ALL_CONFIGS)}")
    return ALL_CONFIGS[name]


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-topology variant for CPU smoke tests."""
    kw = dict(
        name=cfg.name + "-smoke",
        n_layers=min(cfg.n_layers, 4),
        d_model=128, d_ff=256 if cfg.d_ff else 0, vocab=512,
        head_dim=32, dtype="float32",
    )
    if cfg.n_heads:
        kw["n_heads"] = 4
        kw["n_kv_heads"] = min(cfg.n_kv_heads, 2) if cfg.n_kv_heads else 0
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(
            cfg.moe, n_routed_experts=4, top_k=min(cfg.moe.top_k, 2),
            d_ff_expert=64,
            first_k_dense=min(cfg.moe.first_k_dense, 1))
    if cfg.mla is not None:
        kw["mla"] = MLAConfig(q_lora_rank=64, kv_lora_rank=32,
                              qk_nope_head_dim=32, qk_rope_head_dim=16,
                              v_head_dim=32)
    if cfg.ssm is not None:
        kw["ssm"] = dataclasses.replace(cfg.ssm, d_state=16, head_dim=16,
                                        chunk_size=32)
    if cfg.family == ENCDEC:
        kw["n_encoder_layers"] = 2
        kw["encoder_seq"] = 64
        kw["frontend_dim"] = 32
    if cfg.family == VLM:
        kw["n_image_tokens"] = 8
        kw["frontend_dim"] = 32
    if cfg.sliding_window:
        kw["sliding_window"] = 16
        kw["global_attn_layers"] = (0,)
    return cfg.replace(**kw)
