"""Quickstart on the PyTorch port: profile a model's swap order, build a
MorphServe engine, and serve a bursty trace with live morphing — the same
model, budget and trace as ``quickstart.py``, on a CUDA card by default.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse

import torch

from repro_torch.configs import MORPH_LLAMA2_7B, ServingConfig, reduced
from repro_torch.core import profile_swap_sequence, tree_bytes
from repro_torch.engine import EngineConfig, MorphServeEngine, azure_like
from repro_torch.engine.kv_cache import kv_block_bytes
from repro_torch.models import lm

# the bursty trace the example serves
TRACE = dict(duration_s=6.0, base_rps=3.0, seed=3, prompt_mean=40,
             gen_mean=16, prompt_max=96, gen_max=32)


def serving_config(cfg, params) -> ServingConfig:
    """A deliberately tight HBM budget (the weights + 8 float32 KV
    blocks), which forces morphing."""
    wb = tree_bytes(params)
    bb = kv_block_bytes(cfg, 16, 4)
    return ServingConfig(hbm_budget_bytes=int((wb + 8 * bb) / 0.95) + 2 * bb,
                         kv_block_size=16, max_batch_slots=4,
                         max_seq_len=256, swap_levels=(0, 1, 2, 4),
                         mode="performance", kv_resize_step_frac=0.25)


def build(cfg, params, calib, device):
    """The LIS profile of ``params`` on the calibration batch ``calib``
    (paper §3.2, Algorithm 1) and a real-compute morphing engine on
    ``device`` that swaps in that order."""
    prof = profile_swap_sequence(cfg, params, calib, bits=4)
    eng = MorphServeEngine(cfg, params, serving_config(cfg, params),
                           EngineConfig(policy="morph", compute="real"),
                           swap_order=prof.order, device=device)
    return prof, eng


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    device = ap.parse_args().device

    # 1. a small Llama-2-family model (the paper's primary arch, reduced)
    cfg = reduced(MORPH_LLAMA2_7B)
    params = lm.init_params(cfg, torch.Generator(device=device).manual_seed(0))
    print(f"model: {cfg.name} ({cfg.n_layers} layers, d={cfg.d_model}) on "
          f"{device}")

    # 2. offline sensitivity profiling, 3. the engine
    calib = torch.randint(0, cfg.vocab, (2, 32), device=device,
                          generator=torch.Generator(device=device)
                          .manual_seed(1))
    prof, eng = build(cfg, params, calib, device)
    print(f"LIS swap order: {prof.order}  (safest layer first)")

    # 4. serve a bursty trace
    report = eng.run_trace(azure_like(**TRACE))
    print(f"served {report.n_finished}/{report.n_requests} requests")
    print(report.row())
    levels = sorted({t.swap_level for t in eng.monitor.history})
    blocks = [t.kv_total_blocks for t in eng.monitor.history]
    print(f"swap levels used: {levels}; KV pool {blocks[0]} -> "
          f"peak {max(blocks)} -> end {blocks[-1]} blocks")
    print(f"swaps: {len(eng.actuator.swap_log)}, "
          f"resizes: {len(eng.resize_log)}")


if __name__ == "__main__":
    main()
