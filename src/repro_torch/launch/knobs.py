"""Perf-iteration knobs, a copy of the JAX package's.

A tiny module-global read by the model code at call time (the attention
tiles and the windowed-prefill switch of ``models/layers.attention_core``).
Each named variant is one hypothesis about a lever; the default values
reproduce the baseline exactly.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class Knobs:
    kv_cache_dtype: Optional[str] = None   # e.g. "float8_e4m3fn"
    remat_policy: str = "full"             # full | dots | none
    q_chunk: int = 1024                    # blockwise attention tiles
    kv_chunk: int = 1024
    ssd_chunk: Optional[int] = None        # override cfg.ssm.chunk_size
    moe_capacity_factor: float = 1.25
    decode_absorbed_mla: bool = True
    moe_ep_align: bool = False            # align dispatch sharding with EP
    windowed_attn: bool = True            # slice-based sliding-window prefill
    #   (exact: it computes only the in-window keys of each query chunk)


KNOBS = Knobs()


def set_knobs(**kw) -> Knobs:
    global KNOBS
    KNOBS = dataclasses.replace(Knobs(), **kw)
    return KNOBS


def reset() -> None:
    global KNOBS
    KNOBS = Knobs()


VARIANTS = {
    "baseline": {},
    # decode: fp8 KV cache — halves the KV read term + cache footprint
    "kv_fp8": {"kv_cache_dtype": "float8_e4m3fn"},
    # train: save matmul outputs instead of recomputing everything
    "remat_dots": {"remat_policy": "dots"},
    "remat_none": {"remat_policy": "none"},
    # attention tile sweep (VMEM working set vs scan overhead)
    "attn_tiles_512": {"q_chunk": 512, "kv_chunk": 512},
    "attn_tiles_2048": {"q_chunk": 2048, "kv_chunk": 2048},
    # SSD chunk sweep (intra-chunk quadratic term ∝ chunk)
    "ssd_chunk_64": {"ssd_chunk": 64},
    "ssd_chunk_32": {"ssd_chunk": 32},
    # MoE: tighter capacity => less dispatch memory/compute, more drops
    "moe_cap_1_0": {"moe_capacity_factor": 1.0},
    # combined serving variant (paper-faithful int4 handled via --quant)
    "kv_fp8_tiles": {"kv_cache_dtype": "float8_e4m3fn", "q_chunk": 2048,
                     "kv_chunk": 2048},
    # MoE: dispatch buffer sharded to match expert-parallel placement
    "moe_ep_align": {"moe_ep_align": True},
    # sliding-window prefill computes only in-window KV chunks
    "windowed_attn": {"windowed_attn": True},
    "no_windowed_attn": {"windowed_attn": False},
    "hymba_combo": {"windowed_attn": True, "ssd_chunk": 64},
    "deepseek_combo": {"moe_ep_align": True, "moe_capacity_factor": 1.0},
}
