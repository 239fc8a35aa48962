"""Shared helpers of the tests that hold the PyTorch port against the JAX
package: seeded numpy inputs, the JAX reduced Llama and its bridged twin,
the engine tests' serving budget, and their near-tie check."""
import functools
import importlib.util
import sys
from pathlib import Path

import jax
import numpy as np
import torch

from repro.configs import MORPH_LLAMA2_7B, reduced
from repro.core import tree_bytes as j_tree_bytes
from repro.engine.kv_cache import kv_block_bytes
from repro.models import lm as jlm
from repro_torch import bridge
from repro_torch.configs import MORPH_LLAMA2_7B as T_LLAMA
from repro_torch.configs import reduced as t_reduced

ROOT = Path(__file__).resolve().parent.parent

# the suite runs with several pytest-xdist workers on one machine
torch.set_num_threads(2)

# every argmax of a real-compute engine trace compared across frameworks
# must win by more than this (cross-framework float32 logits differ ~1e-5)
MIN_GAP = 1e-3
ORDER = [2, 0, 3, 1]      # the engine tests' swap order


def jcfg():
    return reduced(MORPH_LLAMA2_7B)


def tcfg():
    return t_reduced(T_LLAMA)


@functools.lru_cache(maxsize=1)
def llama_params():
    """(JAX params, numpy copy, port params on the CPU) of the reduced
    Llama-2 (4 layers, d 128, 4 heads, 2 kv heads, float32)."""
    params = jlm.init_params(jcfg(), jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, params)
    return params, np_params, bridge.to_torch(np_params, "cpu")


def to_np(t):
    return bridge.to_numpy(t)


def np_tree(tree):
    """A JAX tree (QTensor records included) with numpy leaves, for the
    bridge."""
    return jax.tree.map(np.asarray, tree)


def rnd(shape, seed, scale=1.0):
    """Seeded standard-normal float32 numpy input."""
    return (np.random.default_rng(seed).standard_normal(shape)
            .astype(np.float32) * scale)


def close(got, want, tol):
    """A port tensor against a JAX array, ``tol`` = dict(rtol, atol)."""
    np.testing.assert_allclose(to_np(got), np.asarray(want), **tol)


def trees_close(tt, jt, tol):
    """A port tree against a JAX tree of the same leaves and shapes."""
    jl = jax.tree.leaves(jt)
    tl = jax.tree.leaves(tt, is_leaf=lambda x: isinstance(x, torch.Tensor))
    assert len(jl) == len(tl)
    for a, b in zip(tl, jl):
        assert tuple(a.shape) == tuple(b.shape)
        close(a, b, tol)


def serving(params, cls):
    """quickstart's deliberately tight budget: weights + 8 fp32 blocks."""
    wb = j_tree_bytes(params)
    bb = kv_block_bytes(jcfg(), 16, 4)
    return cls(hbm_budget_bytes=int((wb + 8 * bb) / 0.95) + 2 * bb,
               kv_block_size=16, max_batch_slots=4, max_seq_len=256,
               swap_levels=(0, 1, 2, 4), mode="performance",
               kv_resize_step_frac=0.25)


def same_free_ids(jax_alloc, torch_alloc) -> bool:
    """The two allocators hold the same free block ids (the port's keeps
    its never-allocated tail as a range, so it is compared by count and
    membership)."""
    free = torch_alloc.free_ids()
    return (len(jax_alloc.free) == torch_alloc.n_free
            and all(b in free for b in jax_alloc.free))


def _top2_gap(row):
    top = torch.topk(row.float(), 2).values
    return float(top[0] - top[1])


def record_gaps(eng):
    """Wrap the port engine's real-compute calls to collect the top-2 logit
    gap of every argmax it takes."""
    gaps, last = [], {}
    for name in ("decode", "prefill", "prefill_batch", "prefill_chunk"):
        fn = getattr(eng.exec, name)

        def run(*a, _fn=fn, _name=name, **k):
            last[_name] = _fn(*a, **k)
            return last[_name]
        setattr(eng.exec, name, run)

    dec, many, chunk = (eng._decode_real, eng._prefill_real_many,
                        eng._prefill_chunk_real)

    def decode_real(run):
        dec(run)
        gaps.extend(_top2_gap(last["decode"][r.slot]) for r in run)

    def prefill_many(admitted):
        out = many(admitted)
        if "prefill_batch" in last and len(admitted) > 1:
            gaps.extend(_top2_gap(last["prefill_batch"][i])
                        for i in range(len(admitted)))
        return out

    def prefill_chunk(r, clen):
        first = chunk(r, clen)
        if first is not None:
            gaps.append(_top2_gap(last["prefill_chunk"][clen - 1]))
        return first

    eng._decode_real = decode_real
    eng._prefill_real_many = prefill_many
    eng._prefill_chunk_real = prefill_chunk
    return gaps


def load_module(name, path):
    """The file ``path`` (relative to the repo root) as module ``name``:
    the examples and ``benchmarks/common.py`` are in no package."""
    spec = importlib.util.spec_from_file_location(name, ROOT / path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod          # dataclasses look their module up
    spec.loader.exec_module(mod)
    return mod
