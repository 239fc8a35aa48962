"""Shared helpers of the tests that hold the PyTorch port against the JAX
package: seeded numpy inputs, the JAX reduced Llama and its bridged twin."""
import functools

import jax
import numpy as np
import torch

from repro.configs import MORPH_LLAMA2_7B, reduced
from repro.models import lm as jlm
from repro_torch import bridge
from repro_torch.configs import MORPH_LLAMA2_7B as T_LLAMA
from repro_torch.configs import reduced as t_reduced

# the suite runs with several pytest-xdist workers on one machine
torch.set_num_threads(2)


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
