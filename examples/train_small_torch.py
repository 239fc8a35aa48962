"""Training driver of the PyTorch port: train a small LM on the synthetic
pipeline with checkpointing + resume (the torch twin of
``examples/train_small.py``: the same config, data, optimizer and
checkpoint loop).

    PYTHONPATH=src python examples/train_small_torch.py [--steps 200]
        [--device cuda] [--ckpt-dir DIR] [--ckpt-every 50]

Run again with the same ``--ckpt-dir`` and it resumes from the latest good
checkpoint there.
"""
import argparse
import os
import tempfile
import time

import torch

from repro_torch import checkpoint as ckpt
from repro_torch.configs import MORPH_LLAMA2_7B, reduced
from repro_torch.data import DataConfig, batch_at
from repro_torch.launch import steps as st
from repro_torch.models import lm
from repro_torch.optim import adamw


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_small"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device (pass --device cpu to train on "
                         "the CPU)")

    cfg = reduced(MORPH_LLAMA2_7B).replace(n_layers=4, d_model=128,
                                           vocab=256, d_ff=512)
    ocfg = adamw.OptConfig(lr=3e-3, warmup_steps=10, total_steps=args.steps)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=64, batch_size=8, seed=0)
    step_fn = st.make_train_step(cfg, ocfg)

    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    opt = adamw.init(params)
    start = 0
    restored, rstep = ckpt.load(args.ckpt_dir, {"p": params, "o": opt})
    if restored is not None:
        params, opt, start = restored["p"], restored["o"], rstep
        print(f"resumed from step {start}")

    t0 = time.time()
    writer = None
    for s in range(start, args.steps):
        x, y = (torch.from_numpy(a).to(dev) for a in batch_at(dcfg, 0, s))
        params, opt, stats = step_fn(params, opt, x, y)
        if (s + 1) % 25 == 0:
            print(f"step {s+1:4d} loss={float(stats['loss']):.4f} "
                  f"lr={float(stats['lr']):.2e} "
                  f"gnorm={float(stats['grad_norm']):.2f}")
        if (s + 1) % args.ckpt_every == 0:
            if writer is not None:
                writer.join()
            writer = ckpt.save(args.ckpt_dir, s + 1, {"p": params, "o": opt},
                               async_write=True)
    if writer is not None:                 # the last write lands before exit
        writer.join()
    print(f"trained {args.steps - start} steps in {time.time()-t0:.1f}s on "
          f"{dev}; checkpoints in {args.ckpt_dir}")


if __name__ == "__main__":
    main()
