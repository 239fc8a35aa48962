"""Deterministic, shard-aware synthetic LM data pipeline (numpy only: a
copy of the JAX package's, so both packages train on the same batches).

Two generators:
  * ``markov_stream`` — a seeded token-level Markov chain with enough
    structure that a small LM trained on it develops non-trivial,
    quantization-sensitive weights (used by the Table-1 / Fig-4 quality
    benchmarks).
  * ``uniform_stream`` — iid tokens (throughput-only benchmarks).

The loader is deterministic in (seed, shard, step): any worker can reproduce
any batch — the property elastic restarts and the checkpoint tests rely on.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    batch_size: int                    # per-shard batch
    seed: int = 0
    kind: str = "markov"               # markov | uniform
    branching: int = 4                 # markov out-degree


def _markov_table(vocab: int, branching: int, seed: int) -> np.ndarray:
    """(vocab, branching) successor table + implicit skewed probs."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, size=(vocab, branching))


def _gen_markov(rng, table, n, vocab, branching):
    probs = np.array([0.55, 0.25, 0.15, 0.05][:branching])
    probs = probs / probs.sum()
    out = np.empty(n, np.int32)
    s = int(rng.integers(0, vocab))
    for i in range(n):
        out[i] = s
        s = int(table[s, rng.choice(branching, p=probs)])
        if rng.random() < 0.02:                      # occasional reset
            s = int(rng.integers(0, vocab))
    return out


def batch_at(cfg: DataConfig, shard: int, step: int) -> Tuple[np.ndarray,
                                                              np.ndarray]:
    """Deterministic (tokens, labels) for a given shard and step."""
    rng = np.random.default_rng(
        np.random.SeedSequence([cfg.seed, shard, step]))
    n = cfg.batch_size * (cfg.seq_len + 1)
    if cfg.kind == "markov":
        table = _markov_table(cfg.vocab, cfg.branching, cfg.seed)
        flat = _gen_markov(rng, table, n, cfg.vocab, cfg.branching)
    else:
        flat = rng.integers(0, cfg.vocab, size=n).astype(np.int32)
    x = flat.reshape(cfg.batch_size, cfg.seq_len + 1)
    return x[:, :-1], x[:, 1:]


def stream(cfg: DataConfig, shard: int = 0,
           start_step: int = 0) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    step = start_step
    while True:
        yield batch_at(cfg, shard, step)
        step += 1
