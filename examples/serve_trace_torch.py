"""End-to-end serving run of the PyTorch port (the paper's experiment
shape): replay a 72 s Azure-like trace against a 7B-class model at L4 scale
for all four policies and print the Fig-4-style comparison — the torch twin
of ``serve_trace.py``: the same trace, budget, ladder and printed lines.

    PYTHONPATH=src python examples/serve_trace_torch.py [--trace burstgpt]
        [--device cuda]

The engines run in sim compute (virtual L4 clock) with their paged pools on
``--device``: 17.2 GB of bf16 pool at the fp policies and 34.4 GB at
``static_int4``, one engine at a time. ``--device meta`` serves the same
rows without allocating the pool (the sim engine never reads it).
"""
import argparse
import contextlib
import dataclasses
import gc

import torch

from repro_torch.configs import MORPH_LLAMA2_7B, ServingConfig
from repro_torch.engine import (EngineConfig, MorphServeEngine, NVIDIA_L4,
                                azure_like, burstgpt_like)

# (policy, controller mode) of the four printed rows
POLICIES = (("static_fp16", "accuracy"), ("static_int4", "accuracy"),
            ("morph", "accuracy"), ("morph", "performance"))
# an L4's 24 GiB, 48 decode slots, prompts + generations up to 2048 tokens
SERVING = ServingConfig(hbm_budget_bytes=24 * 2**30, kv_block_size=16,
                        max_batch_slots=48, max_seq_len=2048,
                        swap_levels=(0, 2, 4, 8, 16))
DURATION_S = 72.0
MAX_STEPS = 60000


def make_trace(kind="azure", rps=0.45, duration_s=DURATION_S):
    """The example's trace: ``kind`` azure or burstgpt at ``rps``."""
    gen = azure_like if kind == "azure" else burstgpt_like
    return gen(duration_s=duration_s, base_rps=rps, seed=5, prompt_mean=512,
               gen_mean=256, prompt_max=1024, gen_max=448)


def policy_name(policy, mode):
    return policy if policy.startswith("static") else f"morph-{mode}"


def run_policies(cfg, params, trace, serving, *, compute, hw, device,
                 swap_order=None, watch=None, policies=POLICIES):
    """Serve ``trace`` under each (policy, mode) of ``policies``, one
    bf16-pool engine at a time on ``device``; yields (name, report, KV
    block trajectory, swap log, resize log) per policy. ``watch(name, engine)``, if given, is a
    context manager entered around each engine's run. Each engine is
    dropped (and the card's cache emptied) before the next is built."""
    for policy, mode in policies:
        eng = MorphServeEngine(
            cfg, params, dataclasses.replace(serving, mode=mode),
            EngineConfig(policy=policy, compute=compute, hw=hw,
                         dtype="bfloat16", seed=1),
            swap_order=swap_order, device=device)
        name = policy_name(policy, mode)
        with watch(name, eng) if watch else contextlib.nullcontext():
            rep = eng.run_trace(trace, max_steps=MAX_STEPS)
        out = (name, rep, [t.kv_total_blocks for t in eng.monitor.history],
               list(eng.actuator.swap_log), list(eng.resize_log))
        dev = eng.device
        del eng
        gc.collect()            # wrapped engine methods form cycles
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        yield out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace", default="azure",
                    choices=["azure", "burstgpt"])
    ap.add_argument("--rps", type=float, default=0.45)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    trace = make_trace(args.trace, args.rps)
    print(f"{args.trace} trace: {len(trace)} requests over 72s")
    for name, rep, blocks, _, _ in run_policies(
            MORPH_LLAMA2_7B, None, trace, SERVING, compute="sim",
            hw=NVIDIA_L4, device=args.device):
        print(f"{name:18s} {rep.row()}  kv_blocks {blocks[0]}->"
              f"{max(blocks)}")


if __name__ == "__main__":
    main()
