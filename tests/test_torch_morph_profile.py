"""``examples/morph_profile_torch.py``, the torch twin of
``examples/morph_profile.py``, against the JAX package.

The JAX script trains its 4-layer model with ``benchmarks/common.py``'s
``trained_small_model(steps=150)``; those params cross to the port through
numpy. On them:

- the LIS profile: the greedy order exactly (every greedy choice wins by
  more than ``MIN_LIS_GAP``, checked), LTS, LRS and the chosen LIS scores
  to ``RTOL`` relative;
- the Table-1 perplexities, every entry to ``TABLE_RTOL`` relative (the
  port's int4 layers flagged for the wNa16 kernel, whose plain version
  runs on the CPU; the JAX side dequantizes).

The twin's own training, started from the bridged JAX init on the same
batches: its 150 losses equal JAX's to ``LOSS_RTOL`` relative (the
tolerance of test_torch_train.py's 4-step trajectory) up to step ``PART``,
where float32 summation order first parts them by more, and to
``LOSS_RTOL_AFTER`` to the end.
Last, the twin's ``main(["--device", "cpu"])`` prints the JAX script's
layout.
"""
import re

import jax
import numpy as np
import pytest
import torch
from torch_parity import load_module, np_tree

from repro.core import profile_swap_sequence as j_profile
from repro.core import back_to_front_order as j_b2f
from repro.core import front_to_back_order as j_f2b
from repro.core import random_order as j_random
from repro.data import batch_at as j_batch_at
from repro.models import lm as jlm
from repro.quant import quantize_tree as j_quantize_tree
from repro_torch import bridge
from repro_torch.core.sensitivity import final_hidden, mean_cosine
from repro_torch.models import lm as tlm

RTOL = 1e-5
TABLE_RTOL = 1e-4
MIN_LIS_GAP = 1e-4
LOSS_RTOL = 1e-5
PART = 27                 # the first step whose losses part by > LOSS_RTOL
LOSS_RTOL_AFTER = 1e-3    # 1.0e-4 measured at worst over steps 27-149


def _twin():
    return load_module("morph_profile_torch", "examples/morph_profile_torch.py")


@pytest.fixture(scope="module")
def common():
    """The JAX script's ``benchmarks/common.py``."""
    return load_module("bench_common", "benchmarks/common.py")


@pytest.fixture(scope="module")
def jax_trained(common):
    """``trained_small_model(steps=150)``: (cfg, params, losses, data
    config)."""
    return common.trained_small_model(steps=150)


@pytest.fixture
def deterministic():
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(was)


def _lis_gaps(cfg, params, calib, qbank, prof):
    """At each greedy step of Algorithm 1, the chosen layer's LIS less the
    runner-up's (the port's profile's own inputs)."""
    layers = tlm.params_to_layer_list(cfg, params)
    current = list(layers)
    prev = final_hidden(cfg, params, layers, calib)
    gaps = []
    with torch.no_grad():
        for best in prof.order[:-1]:
            lis = {}
            for j in range(cfg.n_layers):
                if current[j][1] is qbank[j]:
                    continue
                trial = list(current)
                trial[j] = (trial[j][0], qbank[j])
                h = final_hidden(cfg, params, trial, calib)
                lis[j] = (0.25 * prof.lts[j] + 0.25 * prof.lrs[j]
                          + 0.5 * mean_cosine(prev, h))
            assert max(lis, key=lis.get) == best
            top = sorted(lis.values(), reverse=True)
            gaps.append(top[0] - top[1])
            current[best] = (current[best][0], qbank[best])
            prev = final_hidden(cfg, params, current, calib)
    return gaps


def test_profile_and_table_match_jax(jax_trained, common):
    twin = _twin()
    cfg, params, losses, dcfg = jax_trained
    # the JAX run the example's recorded output came from
    assert f"{losses[0]:.3f} -> {losses[-1]:.3f}" == "6.044 -> 1.450"
    tcfg = twin.small_config()
    tparams = bridge.to_torch(np_tree(params), "cpu")
    calib_x, _ = j_batch_at(dcfg, 800, 0)
    jprof = j_profile(cfg, params, jax.numpy.array(calib_x[:2, :48]), bits=4)
    calib = twin.calibration(dcfg, "cpu")
    qbank = twin.int4_bank(tcfg, tparams)
    tprof = twin.profile_swap_sequence(tcfg, tparams, calib, bits=4,
                                       quant_bank=qbank)
    assert jprof.order == [3, 2, 1, 0]
    assert tprof.order == jprof.order
    gaps = _lis_gaps(tcfg, tparams, calib, qbank, tprof)
    assert min(gaps) > MIN_LIS_GAP, f"near-tie in the LIS greedy: {gaps}"
    for key in ("lts", "lrs", "lis"):
        np.testing.assert_allclose(getattr(tprof, key), getattr(jprof, key),
                                   rtol=RTOL, err_msg=key)

    # the JAX script's table, through benchmarks/common's eval_loss
    fp_layers = jlm.params_to_layer_list(cfg, params)
    jbank = [j_quantize_tree(lp, bits=4) for _, lp in fp_layers]
    want = {}
    for name, order in [("front_to_back", j_f2b(cfg.n_layers)),
                        ("back_to_front", j_b2f(cfg.n_layers)),
                        ("random", j_random(cfg.n_layers, 1)),
                        ("lis", jprof.order)]:
        want[name] = [common.perplexity(common.eval_loss(
            cfg, params, dcfg, layer_list=[
                (kind, jbank[i] if i in set(order[:k]) else lp)
                for i, (kind, lp) in enumerate(fp_layers)]))
            for k in twin.KS]
    got = twin.ppl_table(tcfg, tparams, dcfg, qbank, tprof.order)
    assert list(got) == list(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=TABLE_RTOL,
                                   err_msg=name)
    # the table printed by the JAX script at commit 3ec7065
    recorded = {"front_to_back": [4.3614, 4.3877, 4.3874, 4.3873],
                "back_to_front": [4.3614, 4.3602, 4.3609, 4.3873],
                "random": [4.3614, 4.3877, 4.3874, 4.3873],
                "lis": [4.3614, 4.3602, 4.3609, 4.3873]}
    for name, vals in recorded.items():
        np.testing.assert_allclose(got[name], vals, rtol=TABLE_RTOL,
                                   atol=5e-5, err_msg=name)


def test_training_from_jax_init_follows_jax(jax_trained, deterministic):
    twin = _twin()
    cfg, _, jlosses, _ = jax_trained
    p0 = bridge.to_torch(np_tree(jlm.init_params(cfg, jax.random.PRNGKey(0))),
                         "cpu")
    _, _, tlosses, _ = twin.trained_small_model(steps=150, params=p0,
                                                device="cpu")
    rel = np.abs(np.subtract(tlosses, jlosses)) / np.abs(jlosses)
    assert len(tlosses) == 150
    assert rel[:PART].max() <= LOSS_RTOL, (
        f"parted at step {int(np.argmax(rel > LOSS_RTOL))}")
    assert rel.max() <= LOSS_RTOL_AFTER, (
        f"step {int(rel.argmax())}: {rel.max():.2e}")


def test_example_main_on_cpu(capsys):
    """The twin as a user runs it, from its own seeded init: it trains, and
    prints the JAX script's lines in their layout."""
    _twin().main(["--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    pats = ([r"trained 4-layer model: loss \d+\.\d{3} -> \d+\.\d{3}", "",
             r"per-layer sensitivity \(higher = safer to swap\):"]
            + [rf"  layer {i}: LTS=-?\d\.\d{{4}} LRS=-?\d\.\d{{4}}"
               for i in range(4)]
            + [r"greedy LIS order: \[(\d, ){3}\d\]", "",
               r"perplexity vs #swapped \(Table-1 style\):",
               re.escape("order           k=0        k=1        k=2        "
                         "k=4       ")]
            + [rf"{name:15s}" + r"( \d+\.\d{4}\s*){4}"
               for name in ("front_to_back", "back_to_front", "random",
                            "lis")])
    assert len(out) == len(pats)
    for line, pat in zip(out, pats):
        assert re.fullmatch(pat, line), (line, pat)
    order = [int(c) for c in re.findall(r"\d", out[7][len("greedy"):])]
    assert sorted(order) == [0, 1, 2, 3]
