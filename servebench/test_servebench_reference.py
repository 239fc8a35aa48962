"""The plain reference against the port's plain route at a small size, at
swap level 0 and with every layer on its int4 variant, for both model
families the harness serves (the test imports the port; the reference
does not)."""
import copy

import pytest
import torch

from servebench import bench, weights
from servebench.conftest import TINY
from servebench.reference import model as ref


def _setup(family):
    m = dict(copy.deepcopy(TINY[family]), dtype="float32")
    conf = {"model": m, "serving": {"hbm_budget_bytes": 1 << 30,
                                    "swap_levels": [0, 1]},
            "engine": {"hw": "NVIDIA_H100_SXM", "dtype": "float32"}}
    cfg, _, _ = bench.port_configs(conf)
    from repro_torch.models import lm
    segs = lm.segment_plan(cfg)
    params = weights.make(m, segs, 1234, "cpu")
    layers = [p for _, p in weights.layer_list(params, segs)]
    misc = {k: v for k, v in params.items() if k != "segments"}
    toks = torch.randint(0, m["vocab"], (40,),
                         generator=torch.Generator().manual_seed(5))
    return m, cfg, params, layers, misc, toks


@pytest.mark.parametrize("family", ["dense", "mla"])
def test_reference_matches_the_port_plain_route(family):
    from repro_torch.core.swap_plan import build_swap_plan
    from repro_torch.models import lm
    m, cfg, params, layers, misc, toks = _setup(family)
    S = toks.shape[0]
    rows = torch.arange(S)
    n = cfg.n_layers
    order = list(range(n))[::-1]
    rank = [order.index(i) for i in range(n)]
    plan = build_swap_plan(cfg, params, order, bits=4)
    for level in (0, n):
        want = lm.forward_unrolled(cfg, params, plan.layer_list(level),
                                   toks[None], moe_cf=-1.0, plain=True)[0]
        got = ref.logits(m, layers, misc, toks,
                         torch.full((S,), level), rank, rows)
        err = (got - want.float()).abs().max() / want.abs().max()
        assert err < 2e-4, (level, float(err))


def test_levels_select_rows():
    """Rows at level 0 and rows at the top level in one sequence: each row's
    logits are those of its own level where no earlier row differs."""
    m, cfg, params, layers, misc, toks = _setup("dense")
    S, n = toks.shape[0], cfg.n_layers
    rank = list(range(n))
    lv = torch.zeros(S, dtype=torch.long)
    lv[S // 2:] = n
    rows = torch.arange(S)
    mixed = ref.logits(m, layers, misc, toks, lv, rank, rows)
    flat0 = ref.logits(m, layers, misc, toks, torch.zeros(S, dtype=torch.long),
                       rank, rows)
    flatq = ref.logits(m, layers, misc, toks, torch.full((S,), n), rank, rows)
    assert torch.allclose(mixed[:S // 2], flat0[:S // 2])
    assert not torch.allclose(mixed[S // 2:], flat0[S // 2:])
    assert not torch.allclose(mixed[S // 2:], flatq[S // 2:])
