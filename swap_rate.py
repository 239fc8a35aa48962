#!/usr/bin/env python3
"""Find the lowest request rate at which the morphing engine swaps a layer,
on its virtual clock, for chip_smoke.py's trace shape.

    PYTHONPATH=src python3 swap_rate.py [config name] [layers]

(default: Mamba-2 780M cut to chip_smoke.py's 4 layers; ``0`` layers: the
config's own depth).

Runs on the CPU, with no weights: ``MorphServeEngine(compute="sim")`` on
the NVIDIA H100 cost profile, handed a sim swap plan that carries the
bytes the real-compute engine books (one layer drawn at full width in
bf16 and its int4 variant, as ``build_swap_plan`` makes it; the sim
engine's own reserve books the embedding and head, 2 x vocab x d bf16
values, which leaves out only the final norm's d), with whole-
prompt prefill (the real-compute path of the SSM and hybrid families).
It serves ``azure_like(duration_s=4, base_rps=R, seed=3, prompt_mean=160,
prompt_max=512, gen_mean=24, gen_max=48)`` at 8 slots, ``max_seq_len``
1024, swap levels (0, 1, 2, 4), under chip_smoke.py's budget of the
weights plus 8 float32 KV blocks and two blocks' slack (for an SSM config a
KV block is 0 bytes, and the slack two bytes), and bisects
on integer R for the lowest rate whose run lands a swap. An SSM config has
no KV pressure, so only queue delay trips the controller there.
"""
from __future__ import annotations

import dataclasses
import sys

import torch

from repro_torch.configs import ServingConfig, get_config
from repro_torch.core import front_to_back_order, swap_plan, tree_bytes
from repro_torch.engine import (EngineConfig, MorphServeEngine,
                                NVIDIA_H100_SXM, azure_like)
from repro_torch.engine.kv_cache import kv_block_bytes
from repro_torch.models import lm
from repro_torch.quant import quantize_tree


def real_bytes(cfg):
    """(fp bytes, int4 bytes) of each layer, and the bytes of the rest (the
    embedding, the head and the final norm), as the real-compute engine
    books them for bf16 weights."""
    gen = torch.Generator().manual_seed(0)
    fp, q = [], []
    cache = {}
    for kind in lm.layer_kinds(cfg):
        if kind not in cache:
            layer = lm.block_init(kind, gen, cfg, torch.bfloat16)
            cache[kind] = (tree_bytes(layer),
                           tree_bytes(quantize_tree(layer, bits=4)))
        fp.append(cache[kind][0])
        q.append(cache[kind][1])
    rest = 2 * cfg.vocab * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    rest += 2 * cfg.d_model
    return fp, q, rest


def swaps_at(cfg, rps: float, sizes) -> tuple:
    """Serve the trace at ``rps`` on the virtual clock; returns (requests,
    served, the swap log, engine steps)."""
    fp, q, rest = sizes
    wb = sum(fp) + rest
    bb = kv_block_bytes(cfg, 16, 4)
    sc = ServingConfig(hbm_budget_bytes=int((wb + 8 * bb) / 0.95)
                       + 2 * max(bb, 1),
                       kv_block_size=16, max_batch_slots=8, max_seq_len=1024,
                       swap_levels=(0, 1, 2, 4), mode="performance",
                       kv_resize_step_frac=0.25)
    plan = dataclasses.replace(
        swap_plan.build_sim_swap_plan(cfg, front_to_back_order(cfg.n_layers),
                                      serving=sc, bits=sc.swap_bits),
        fp_bytes=list(fp), q_bytes=list(q))
    eng = MorphServeEngine(cfg, None, sc, EngineConfig(
        policy="morph", compute="sim", hw=NVIDIA_H100_SXM,
        chunked_prefill=False), device="cpu", plan=plan)
    trace = azure_like(duration_s=4.0, base_rps=rps, seed=3, prompt_mean=160,
                       gen_mean=24, prompt_max=512, gen_max=48)
    rep = eng.run_trace(trace)
    return (rep.n_requests, rep.n_finished, eng.actuator.swap_log,
            len(eng.monitor.history))


def lowest_swap_rate(cfg, lo: int = 1, hi: int = 512) -> int:
    """Bisect on integer rates: the lowest in (lo, hi] whose run swaps,
    assuming runs at lo do not and at hi do."""
    sizes = real_bytes(cfg)
    def run(r):
        n, done, log, steps = swaps_at(cfg, r, sizes)
        print(f"rate {r}: {done}/{n} served, {steps} steps, swaps "
              f"{log[:2]}", flush=True)
        return log

    for r in (lo, hi):
        run(r)
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (lo, mid) if run(mid) else (mid, hi)
    return hi


if __name__ == "__main__":
    name = sys.argv[1] if len(sys.argv) > 1 else "mamba2-780m"
    layers = int(sys.argv[2]) if len(sys.argv) > 2 else 4
    cfg = get_config(name)
    cfg = cfg.replace(n_layers=layers or cfg.n_layers)
    rate = lowest_swap_rate(cfg)
    print(f"{name} x{cfg.n_layers} layers: lowest base_rps that lands a "
          f"swap: {rate}")
