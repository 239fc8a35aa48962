"""Sensitivity-profiling walkthrough of the PyTorch port (paper §3.2 +
Appendix B): compute LTS/LRS/MDS per layer, run greedy Algorithm 1, and
compare the resulting order against front-to-back / back-to-front / random
on a trained model — the torch twin of ``morph_profile.py``: the same
model, training, calibration batch, orders and printed lines.

    PYTHONPATH=src python examples/morph_profile_torch.py [--device cpu]

On a CUDA card every matmul of an int4 layer goes through the wNa16
kernel.
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import MORPH_LLAMA2_7B, reduced
from repro_torch.core import (back_to_front_order, front_to_back_order,
                              profile_swap_sequence, random_order)
from repro_torch.data import DataConfig, batch_at
from repro_torch.launch import steps as st
from repro_torch.models import lm
from repro_torch.optim import adamw
from repro_torch.quant import quantize_tree

BENCH_VOCAB = 256
KS = (0, 1, 2, 4)                  # swapped layers, the table's columns


def small_config():
    """The 4-layer, d-128 Llama the example trains."""
    return reduced(MORPH_LLAMA2_7B).replace(
        name="bench-small", n_layers=4, d_model=128, vocab=BENCH_VOCAB,
        d_ff=512)


def trained_small_model(steps: int = 250, *, params=None, device="cuda"):
    """Train a small LM on markov data so quantization has a *meaningful*,
    ordered quality impact (random weights don't). ``params``: the initial
    params (default: drawn from a generator seeded 0 on ``device``).
    Returns (cfg, params, per-step losses, data config)."""
    cfg = small_config()
    if params is None:
        params = lm.init_params(
            cfg, torch.Generator(device=device).manual_seed(0))
    ocfg = adamw.OptConfig(lr=3e-3, warmup_steps=10, total_steps=steps)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=64, batch_size=8, seed=0)
    step_fn = st.make_train_step(cfg, ocfg)
    opt = adamw.init(params)
    losses = []
    for s in range(steps):
        x, y = (torch.from_numpy(a).to(device) for a in batch_at(dcfg, 0, s))
        params, opt, stats = step_fn(params, opt, x, y)
        losses.append(float(stats["loss"]))
    return cfg, params, losses, dcfg


def eval_loss(cfg, params, dcfg, layer_list, *, plain=False):
    """Cross-entropy of ``layer_list`` on held-out shards (shard 9xx), on
    the params' device; ``plain=True`` asks every kernel route for its
    plain version."""
    dev = params["embed"].device
    tot = 0.0
    with torch.no_grad():
        for b in range(4):
            x, y = (torch.from_numpy(a).to(dev)
                    for a in batch_at(dcfg, 900 + b, 0))
            logits = lm.forward_unrolled(cfg, params, layer_list, x,
                                         plain=plain)
            tot += float(st.softmax_xent(logits, y))
    return tot / 4


def perplexity(loss: float) -> float:
    return float(np.exp(loss))


def int4_bank(cfg, params):
    """Each layer's int4 variant, flagged for the wNa16 kernel."""
    return [quantize_tree(lp, bits=4, use_kernel=True)
            for _, lp in lm.params_to_layer_list(cfg, params)]


def ppl_table(cfg, params, dcfg, qbank, lis_order, *, plain=False):
    """{order name: perplexity with its first k layers int4, k in KS}."""
    n = cfg.n_layers
    fp_layers = lm.params_to_layer_list(cfg, params)
    out = {}
    for name, order in [("front_to_back", front_to_back_order(n)),
                        ("back_to_front", back_to_front_order(n)),
                        ("random", random_order(n, 1)), ("lis", lis_order)]:
        out[name] = [perplexity(eval_loss(
            cfg, params, dcfg, [(kind, qbank[i] if i in set(order[:k])
                                 else lp)
                                for i, (kind, lp) in enumerate(fp_layers)],
            plain=plain)) for k in KS]
    return out


def calibration(dcfg, device):
    """The profile's calibration batch: 2 x 48 tokens of shard 800."""
    calib_x, _ = batch_at(dcfg, 800, 0)
    return torch.from_numpy(calib_x[:2, :48]).long().to(device)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    dev = torch.device(ap.parse_args(argv).device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device (pass --device cpu to run on the "
                         "CPU)")

    cfg, params, losses, dcfg = trained_small_model(steps=150, device=dev)
    print(f"trained {cfg.n_layers}-layer model: "
          f"loss {losses[0]:.3f} -> {losses[-1]:.3f}")

    qbank = int4_bank(cfg, params)
    prof = profile_swap_sequence(cfg, params, calibration(dcfg, dev), bits=4,
                                 quant_bank=qbank)
    print("\nper-layer sensitivity (higher = safer to swap):")
    for i in range(cfg.n_layers):
        print(f"  layer {i}: LTS={prof.lts[i]:.4f} LRS={prof.lrs[i]:.4f}")
    print(f"greedy LIS order: {prof.order}")

    table = ppl_table(cfg, params, dcfg, qbank, prof.order)
    print("\nperplexity vs #swapped (Table-1 style):")
    print(f"{'order':15s}" + "".join(f" k={k:<8d}" for k in KS))
    for name, vals in table.items():
        print(f"{name:15s}" + "".join(f" {v:<9.4f}" for v in vals))
    return cfg, params, dcfg, prof, table


if __name__ == "__main__":
    main()
