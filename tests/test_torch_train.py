"""The port's training side against the JAX package's, on the CPU: the
data pipeline, AdamW, int8 gradient compression (and its all-reduce over a
2-process gloo group), the loss, the MoE balancing helpers and
``forward(collect_aux=True)``, one train step of every config of
``test_arch_smoke.ARCHS`` (reduced) from the same bridged params and batch,
the remat policies, a 4-step trajectory and the bitwise resume, the
checkpoint in both directions (float32 and bfloat16), the cell shapes of
every config at full width, and the training example.

Tolerances (float32 on both sides; the frameworks differ by summation
order, ~1e-6 relative at these sizes):
- the loss ``LOSS_RTOL`` relative, the grad norm ``NORM_RTOL``, the
  learning rate ``LR_RTOL``;
- each moment leaf within ``MOM_TOL`` of the leaf's max |m| (m carries
  the clipped gradient, m = (1 - b1) g at step 1), v within ``2 MOM_TOL``
  of its max (v ~ g^2 doubles a relative error);
- each parameter within ``P_ATOL`` + ``P_RTOL`` |p|, except where the JAX
  gradient is below ``MOM_TOL`` of the leaf's max |g|: there the two
  gradients are noise whose signs may differ, and Adam's first step moves
  a weight by about lr sign(g), so such an entry may part by ``2 lr``.
"""
import datetime
import importlib.util
import multiprocessing as mp
import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from test_arch_smoke import ARCHS
from torch_parity import np_tree

from repro import checkpoint as jck
from repro.configs import ALL_CONFIGS, MORPH_LLAMA2_7B, applicable_shapes
from repro.configs import get_config as j_get_config
from repro.configs import reduced
from repro.data import DataConfig as JDataConfig
from repro.data import batch_at as j_batch_at
from repro.data import stream as j_stream
from repro.distributed.sharding import path_str as j_path_str
from repro.launch import steps as jst
from repro.models import dummy_inputs, get_model
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro.optim import adamw as jad
from repro.optim import compression as jcomp
from repro_torch import bridge
from repro_torch import checkpoint as tck
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.data import DataConfig, batch_at, stream
from repro_torch.distributed.sharding import path_str
from repro_torch.launch import knobs
from repro_torch.launch import steps as tst
from repro_torch.models import get_model as t_get_model
from repro_torch.models import lm as tlm
from repro_torch.models import mamba as tmamba
from repro_torch.models import moe as tmoe
from repro_torch.optim import adamw as tad
from repro_torch.optim import compression as tcomp
from repro_torch.tree import flatten_with_path, leaves

LOSS_RTOL = 1e-5
NORM_RTOL = 1e-4
LR_RTOL = 1e-6
MOM_TOL = 1e-4
P_ATOL = 1e-6
P_RTOL = 1e-6
ROOT = pathlib.Path(__file__).resolve().parents[1]


def t(a, dtype=None):
    """A numpy / JAX array as a CPU tensor (bf16 through the bridge)."""
    out = bridge.array_to_torch(np.array(a), "cpu")
    return out if dtype is None else out.to(dtype)


def tn(x):
    """A tensor as numpy, bfloat16 as float32 (exact)."""
    return bridge.to_numpy(x)


def _jcfg(name):
    return reduced(j_get_config(name))


@pytest.fixture
def deterministic():
    """Deterministic algorithms for a bitwise comparison of two runs (with
    several threads the embedding's gradient accumulates in a varying
    order)."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(was)


def _tcfg(name):
    return t_reduced(t_get_config(name))


# ---------------------------------------------------------------------------
# data pipeline: bit-equal
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["markov", "uniform"])
def test_batches_equal_jax(kind):
    for seed, shard, step in ((0, 0, 0), (7, 2, 5), (3, 1, 11)):
        kw = dict(vocab=97, seq_len=24, batch_size=3, seed=seed, kind=kind)
        x, y = batch_at(DataConfig(**kw), shard, step)
        jx, jy = j_batch_at(JDataConfig(**kw), shard, step)
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(y, jy)
        assert x.dtype == jx.dtype
    kw = dict(vocab=64, seq_len=8, batch_size=2, seed=1)
    for (a, b), (c, d), _ in zip(stream(DataConfig(**kw), 1, 4),
                                 j_stream(JDataConfig(**kw), 1, 4), range(3)):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------
def _opt_tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((6, 5)).astype(np.float32),
            "b": {"c": rng.standard_normal((7,)).astype(np.float32)},
            "s": np.float32(rng.standard_normal())}


def test_schedule_matches_jax():
    cfg = tad.OptConfig(lr=2e-3, warmup_steps=10, total_steps=100,
                        min_lr_frac=0.1)
    jcfg = jad.OptConfig(lr=2e-3, warmup_steps=10, total_steps=100,
                         min_lr_frac=0.1)
    for s in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        got = float(tad.schedule(cfg, s))
        want = float(jad.schedule(jcfg, s))
        assert abs(got - want) <= LR_RTOL * want + 1e-12, (s, got, want)
        got_t = float(tad.schedule(cfg, torch.tensor(s, dtype=torch.int32)))
        assert got_t == got


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_apply_matches_jax(dtype):
    """Three steps on a mixed tree; one leaf's gradient is None in the port
    (zeros in JAX): its moments decay and weight decay still moves it."""
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=10, weight_decay=0.1)
    params = _opt_tree(0)
    jp = jax.tree.map(lambda a: jnp.asarray(a, dtype), params)
    tp = {"w": t(jp["w"]), "b": {"c": t(jp["b"]["c"])}, "s": t(jp["s"])}
    jo, to = jad.init(jp), tad.init(tp)
    for k in range(3):
        g = _opt_tree(10 + k)
        jg = dict(jax.tree.map(jnp.asarray, g), s=jnp.zeros((), jnp.float32))
        tg = {"w": t(g["w"]), "b": {"c": t(g["b"]["c"])}, "s": None}
        jp, jo, js = jad.apply(jad.OptConfig(**cfg), jp, jg, jo)
        tp, to, ts = tad.apply(tad.OptConfig(**cfg), tp, tg, to)
        np.testing.assert_allclose(float(ts["grad_norm"]),
                                   float(js["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(ts["lr"]), float(js["lr"]),
                                   rtol=LR_RTOL)
    assert int(to.step) == int(jo.step) == 3
    for a, b in zip(leaves(tp), jax.tree.leaves(jp)):
        assert str(a.dtype).endswith(str(b.dtype))
        np.testing.assert_allclose(tn(a), np.asarray(b, np.float32),
                                   rtol=1e-6, atol=1e-7)
    for tree_t, tree_j in ((to.m, jo.m), (to.v, jo.v)):
        for a, b in zip(leaves(tree_t), jax.tree.leaves(tree_j)):
            np.testing.assert_allclose(tn(a), np.asarray(b), rtol=1e-5,
                                       atol=1e-8)
    assert float(to.m["s"]) == 0.0 and float(tp["s"]) != float(params["s"])


def test_adamw_clips_like_jax():
    """A gradient of norm 2e6 reports its raw norm and is clipped to
    ``clip_norm`` before the moments, as in JAX."""
    cfg = dict(lr=1e-3, clip_norm=1.0, warmup_steps=0)
    jp, tp = {"w": jnp.zeros(4)}, {"w": torch.zeros(4)}
    jg, tg = {"w": jnp.full(4, 1e6)}, {"w": torch.full((4,), 1e6)}
    _, jo, js = jad.apply(jad.OptConfig(**cfg), jp, jg, jad.init(jp))
    _, to, ts = tad.apply(tad.OptConfig(**cfg), tp, tg, tad.init(tp))
    assert float(ts["grad_norm"]) == pytest.approx(2e6, rel=1e-6)
    np.testing.assert_allclose(float(ts["grad_norm"]),
                               float(js["grad_norm"]), rtol=1e-6)
    np.testing.assert_allclose(tn(to.m["w"]), np.asarray(jo.m["w"]),
                               rtol=1e-6)
    assert float(to.m["w"][0]) == pytest.approx(0.1 * 0.5, rel=1e-5)


def test_adamw_reduces_quadratic_loss():
    cfg = tad.OptConfig(lr=0.1, warmup_steps=0, total_steps=100,
                        weight_decay=0.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    opt = tad.init(params)
    l0 = float(torch.sum(params["w"] ** 2))
    for _ in range(50):
        params, opt, _ = tad.apply(cfg, params, {"w": 2 * params["w"]}, opt)
    assert float(torch.sum(params["w"] ** 2)) < 0.01 * l0


# ---------------------------------------------------------------------------
# int8 gradient compression
# ---------------------------------------------------------------------------
def test_compress_matches_jax():
    rng = np.random.default_rng(4)
    for scale in (0.01, 1.0, 300.0):
        g = (rng.standard_normal((33, 7)) * scale).astype(np.float32)
        e = (rng.standard_normal((33, 7)) * scale * 1e-3).astype(np.float32)
        q, s, err = tcomp.compress(t(g), t(e))
        jq, js, jerr = jcomp.compress(jnp.asarray(g), jnp.asarray(e))
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_allclose(float(s), float(js), rtol=1e-7)
        np.testing.assert_allclose(err.numpy(), np.asarray(jerr),
                                   rtol=1e-6, atol=1e-6 * float(js))
        # the error feedback stays within half a quantization step (plus
        # the float32 rounding of a product of up to 127 steps)
        assert float(err.abs().max()) <= (0.5 + 127 * 2.0 ** -22) * float(s)


def test_compress_tree_matches_jax():
    g = _opt_tree(5)
    jg = jax.tree.map(jnp.asarray, g)
    tg = {"w": t(g["w"]), "b": {"c": t(g["b"]["c"], torch.bfloat16)},
          "s": t(g["s"])}
    jg = dict(jg, b={"c": jnp.asarray(g["b"]["c"], jnp.bfloat16)})
    err, jerr = tcomp.init_error_state(tg), None
    for k in range(2):
        if k:         # the second round starts from JAX's carried error
            err = bridge.to_torch(np_tree(jerr), "cpu")
        tq, tsc, err = tcomp.compress_tree(tg, err)
        jq, jsc, jerr = jcomp.compress_tree(jg, jerr)
        for a, b in zip(leaves(tq), jax.tree.leaves(jq)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        for a, b in zip(leaves(err), jax.tree.leaves(jerr)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-7)
    deq = tcomp.decompress_tree(tq, tsc)
    jdeq = jcomp.decompress_tree(jq, jsc)
    for a, b in zip(leaves(deq), jax.tree.leaves(jdeq)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    assert [path_str(p) for p, _ in flatten_with_path(tq)] == \
        ["b/c", "s", "w"]


def _grads_of_rank(rank):
    rng = np.random.default_rng(100 + rank)
    return {"a": (rng.standard_normal((9, 4)) * (rank + 1)).astype(
                np.float32),
            "b": [rng.standard_normal((5,)).astype(np.float32)]}


def _allreduce_worker(rank, store_path, out_dir):
    """One rank of the 2-process gloo group (spawned): all-reduce its
    compressed gradients twice (the second from the first's error), then
    save its payloads and results for the parent to check."""
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store_path, 2), rank=rank,
        world_size=2, timeout=datetime.timedelta(seconds=60))
    try:
        g = {"a": torch.from_numpy(_grads_of_rank(rank)["a"]),
             "b": [torch.from_numpy(_grads_of_rank(rank)["b"][0])]}
        out, err = {}, None
        for it in range(2):
            q, s, _ = tcomp.compress_tree(g, err)
            mean, err = tcomp.allreduce_compressed(g, err)
            for (path, x), qx, sx in zip(flatten_with_path(mean), leaves(q),
                                         leaves(s)):
                key = f"{it}_{path_str(path)}".replace("/", "_")
                out["mean_" + key] = x.numpy()
                out["q_" + key] = qx.numpy()
                out["s_" + key] = sx.numpy()
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def test_allreduce_compressed_two_ranks(tmp_path):
    """Over a 2-process gloo group (a FileStore, no network): the mean is
    the int32 sum of both ranks' int8 payloads times the mean scale over 2,
    the formula computed here in numpy from the payloads the ranks saved."""
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_allreduce_worker,
                         args=(r, str(tmp_path / "store"), str(tmp_path)))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=120)
    alive = [p.is_alive() for p in procs]
    for p in procs:
        if p.is_alive():
            p.kill()
    assert not any(alive), "a rank hung"
    assert [p.exitcode for p in procs] == [0, 0]
    r0, r1 = (np.load(tmp_path / f"rank{r}.npz") for r in range(2))
    keys = [k[5:] for k in r0.files if k.startswith("mean_")]
    assert len(keys) == 4
    for key in keys:
        summed = r0["q_" + key].astype(np.int32) + r1["q_" + key]
        mean_scale = (r0["s_" + key] + r1["s_" + key]) / np.float32(2)
        want = summed.astype(np.float32) * mean_scale / np.float32(2)
        np.testing.assert_array_equal(r0["mean_" + key], r1["mean_" + key])
        np.testing.assert_allclose(r0["mean_" + key], want, rtol=1e-6)


# ---------------------------------------------------------------------------
# loss, MoE balancing, aux collection
# ---------------------------------------------------------------------------
def test_softmax_xent_and_grad_match_jax():
    rng = np.random.default_rng(6)
    logits = (rng.standard_normal((3, 5, 41)) * 4).astype(np.float32)
    labels = rng.integers(0, 41, size=(3, 5)).astype(np.int32)
    jl, jg = jax.value_and_grad(jst.softmax_xent)(jnp.asarray(logits),
                                                  jnp.asarray(labels))
    x = t(logits).requires_grad_(True)
    loss = tst.softmax_xent(x, t(labels))
    (g,) = torch.autograd.grad(loss, x)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-6)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-9)


def test_load_balance_and_aux_free_bias_match_jax():
    rng = np.random.default_rng(8)
    load = rng.dirichlet(np.ones(16)).astype(np.float32)
    bias = rng.standard_normal(16).astype(np.float32)
    cfg = _tcfg("deepseek-v3-671b")
    got = tmoe.load_balance_loss({"expert_load": t(load)}, cfg)
    want = jmoe.load_balance_loss({"expert_load": jnp.asarray(load)}, cfg)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    p = tmoe.update_aux_free_bias({"router_bias": t(bias), "x": 1},
                                  {"expert_load": t(load)}, lr=1e-2)
    jp = jmoe.update_aux_free_bias({"router_bias": jnp.asarray(bias)},
                                   {"expert_load": jnp.asarray(load)},
                                   lr=1e-2)
    np.testing.assert_array_equal(p["router_bias"].numpy(),
                                  np.asarray(jp["router_bias"]))
    assert p["x"] == 1


@pytest.mark.parametrize("arch", ["deepseek-v3-671b",
                                  "llama4-maverick-400b-a17b",
                                  "morph-llama2-7b", "hymba-1.5b",
                                  "whisper-small"])
def test_forward_collect_aux_matches_jax(arch):
    """Each segment's stacked ``expert_load`` (zeros((1,)) a step without
    MoE), the same shapes and values as the JAX ``forward``'s."""
    cfg, tcfg = _jcfg(arch), _tcfg(arch)
    api = get_model(cfg)
    params = api.init_params(cfg, jax.random.PRNGKey(0))
    inp = dummy_inputs(cfg, 2, 16)
    jlog, jaux = api.forward(cfg, params, inp["tokens"],
                             frontend=inp.get("frontend"), collect_aux=True)
    tp = bridge.to_torch(np_tree(params), "cpu")
    fe = inp.get("frontend")
    with torch.no_grad():
        tlog, taux = t_get_model(tcfg).forward(
            tcfg, tp, t(inp["tokens"]), frontend=None if fe is None
            else t(fe), collect_aux=True)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=1e-4,
                               atol=1e-4 * float(np.abs(jlog).max()))
    assert len(taux) == len(jaux)
    for a, b in zip(taux, jaux):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-7)


# ---------------------------------------------------------------------------
# the SSD scan: differentiable, serving values unchanged
# ---------------------------------------------------------------------------
def test_ssd_scan_same_values_with_and_without_grad():
    rng = np.random.default_rng(9)
    b, s, h, p, g, n = 2, 32, 4, 8, 2, 16
    x = t(rng.standard_normal((b, s, h, p)).astype(np.float32))
    dt = t(np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(
        np.float32))
    A = -t(np.linspace(1, 4, h).astype(np.float32))
    Bm = t(rng.standard_normal((b, s, g, n)).astype(np.float32))
    Cm = t(rng.standard_normal((b, s, g, n)).astype(np.float32))
    s0 = t(rng.standard_normal((b, h, p, n)).astype(np.float32))
    with torch.no_grad():
        y0, st0 = tmamba.ssd_chunked(x, dt, A, Bm, Cm, chunk=8,
                                     init_state=s0)
    xg = x.clone().requires_grad_(True)
    y1, st1 = tmamba.ssd_chunked(xg, dt, A, Bm, Cm, chunk=8, init_state=s0)
    assert torch.equal(y0, y1.detach()) and torch.equal(st0, st1.detach())
    (gx,) = torch.autograd.grad((y1.sum() + st1.sum()), xg)
    assert torch.isfinite(gx).all() and float(gx.abs().max()) > 0


# ---------------------------------------------------------------------------
# one train step of every config, against JAX
# ---------------------------------------------------------------------------
def _train_inputs(cfg, seed=1):
    inp = dummy_inputs(cfg, 2, 16)
    labels = jax.random.randint(jax.random.PRNGKey(seed),
                                inp["tokens"].shape, 0, cfg.vocab)
    return inp["tokens"], labels, inp.get("frontend")


def _check_step(tp, to, ts, jp, jo, js):
    """The port's step (params, opt state, stats) against JAX's, by the
    module's tolerances."""
    np.testing.assert_allclose(float(ts["loss"]), float(js["loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(ts["grad_norm"]),
                               float(js["grad_norm"]), rtol=NORM_RTOL)
    np.testing.assert_allclose(float(ts["lr"]), float(js["lr"]),
                               rtol=LR_RTOL)
    lr = float(js["lr"])
    assert int(to.step) == int(jo.step)
    jm, jv, jpl = (jax.tree.leaves(x) for x in (jo.m, jo.v, jp))
    tm, tv, tpl = (leaves(x) for x in (to.m, to.v, tp))
    assert len(tm) == len(jm) == len(tpl) == len(jpl)
    b1 = 0.9
    for a_m, b_m, a_v, b_v, a_p, b_p in zip(tm, jm, tv, jv, tpl, jpl):
        b_m, b_v, b_p = (np.asarray(x, np.float32) for x in (b_m, b_v, b_p))
        assert tuple(a_p.shape) == b_p.shape
        m_max = float(np.abs(b_m).max())
        np.testing.assert_allclose(tn(a_m), b_m, rtol=0,
                                   atol=MOM_TOL * m_max + 1e-30)
        np.testing.assert_allclose(tn(a_v), b_v, rtol=0,
                                   atol=2 * MOM_TOL * float(b_v.max())
                                   + 1e-30)
        # |g| where m = (1 - b1) g (the first step)
        g = np.abs(b_m) / (1 - b1)
        noise = g < MOM_TOL * float(g.max()) if g.max() > 0 else \
            np.zeros(g.shape, bool)
        diff = np.abs(tn(a_p) - b_p)
        tol = P_ATOL + P_RTOL * np.abs(b_p) + np.where(noise, 2 * lr, 0.0)
        assert (diff <= tol).all(), (float(diff.max()), int(noise.sum()))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(arch):
    """One train step from the same bridged params and batch: loss, grad
    norm, lr, the moments and the new params (Mamba-2 and Hymba through the
    differentiable SSD scan)."""
    cfg, tcfg = _jcfg(arch), _tcfg(arch)
    params = get_model(cfg).init_params(cfg, jax.random.PRNGKey(0))
    ocfg = dict(lr=1e-3, total_steps=10)
    tokens, labels, fe = _train_inputs(cfg)
    jp, jo, js = jax.jit(jst.make_train_step(cfg, jad.OptConfig(**ocfg)))(
        params, jad.init(params), tokens, labels, fe)
    tp0 = bridge.to_torch(np_tree(params), "cpu")
    tp, to, ts = tst.make_train_step(tcfg, tad.OptConfig(**ocfg))(
        tp0, tad.init(tp0), t(tokens), t(labels),
        None if fe is None else t(fe))
    _check_step(tp, to, ts, jp, jo, js)
    assert tp0 is not tp and all(
        a.requires_grad is False for a in leaves(tp))


@pytest.mark.parametrize("arch", ["morph-llama2-7b", "hymba-1.5b",
                                  "deepseek-v3-671b"])
def test_remat_policies_give_the_same_step(arch):
    """remat "full", "dots" and "none" give the same loss and gradients."""
    tcfg = _tcfg(arch)
    cfg = _jcfg(arch)
    params = get_model(cfg).init_params(cfg, jax.random.PRNGKey(0))
    tp = bridge.to_torch(np_tree(params), "cpu")
    tokens, labels, _ = _train_inputs(cfg)
    lg = tst.make_loss_and_grad(tcfg)
    out = {}
    try:
        for policy in ("none", "full", "dots"):
            knobs.set_knobs(remat_policy=policy)
            out[policy] = lg(tp, t(tokens), t(labels))
    finally:
        knobs.reset()
    loss0, g0 = out["none"]
    for policy in ("full", "dots"):
        loss, g = out[policy]
        assert float(loss) == float(loss0), policy
        for a, b in zip(leaves(g), leaves(g0)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                       atol=1e-9)
    from torch.utils.checkpoint import CheckpointPolicy
    assert tlm._save_dots(None, torch.ops.aten.mm.default) is \
        CheckpointPolicy.MUST_SAVE
    assert tlm._save_dots(None, torch.ops.aten.exp.default) is \
        CheckpointPolicy.PREFER_RECOMPUTE


def test_prefill_and_serve_steps_match_jax():
    cfg = _jcfg("morph-llama2-7b")
    tcfg = _tcfg("morph-llama2-7b")
    params = jlm.init_params(cfg, jax.random.PRNGKey(0))
    tp = bridge.to_torch(np_tree(params), "cpu")
    tokens, _, _ = _train_inputs(cfg)
    want = jst.make_prefill_step(cfg)(params, tokens)
    got = tst.make_prefill_step(tcfg)(tp, t(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4 * float(np.abs(want).max()))
    jcache = jlm.init_cache(cfg, 2, 8)
    tcache = tlm.init_cache(tcfg, 2, 8, device="cpu")
    step, tstep = jst.make_serve_step(cfg), tst.make_serve_step(tcfg)
    for i in range(3):
        tok = tokens[:, i:i + 1]
        jl, jcache = step(params, jcache, tok)
        tl, tcache = tstep(tp, tcache, t(tok))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4 * float(np.abs(jl).max()))


# ---------------------------------------------------------------------------
# trajectory and resume (test_substrate.test_train_resume_bitwise's setup)
# ---------------------------------------------------------------------------
def _resume_setup():
    cfg = reduced(MORPH_LLAMA2_7B).replace(n_layers=2)
    tcfg = t_reduced(t_get_config(MORPH_LLAMA2_7B.name)).replace(n_layers=2)
    ocfg = dict(lr=1e-3, total_steps=10)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=16, batch_size=2)
    return cfg, tcfg, ocfg, dcfg


def _run_torch(step_fn, dcfg, params, opt, s0, n, losses=None):
    for s in range(s0, s0 + n):
        x, y = batch_at(dcfg, 0, s)
        params, opt, stats = step_fn(params, opt, torch.from_numpy(x),
                                     torch.from_numpy(y))
        if losses is not None:
            losses.append(stats)
    return params, opt


def test_train_resume_bitwise(tmp_path, deterministic):
    """Train 4 steps; against train 2, checkpoint, restore, train 2: the
    same params and moments, bit for bit."""
    cfg, tcfg, ocfg, dcfg = _resume_setup()
    step_fn = tst.make_train_step(tcfg, tad.OptConfig(**ocfg))
    p0 = tlm.init_params(tcfg, torch.Generator().manual_seed(0))
    o0 = tad.init(p0)
    pa, oa = _run_torch(step_fn, dcfg, p0, o0, 0, 4)
    pb, ob = _run_torch(step_fn, dcfg, p0, o0, 0, 2)
    tck.save(str(tmp_path), 2, {"p": pb, "o": ob})
    restored, step = tck.load(str(tmp_path), {"p": pb, "o": ob})
    assert step == 2
    for a, b in zip(leaves({"p": pb, "o": ob}), leaves(restored)):
        assert torch.equal(a, b)
    pc, oc = _run_torch(step_fn, dcfg, restored["p"], restored["o"], 2, 2)
    for a, b in zip(leaves({"p": pa, "o": oa}), leaves({"p": pc, "o": oc})):
        assert torch.equal(a, b)


def test_four_step_trajectory_matches_jax():
    """Four steps from the same bridged start on the same batches: each
    step's loss, grad norm and lr within the module's tolerances; the
    final params within 2.01 times the summed lr (AdamW moves a weight by
    at most ~1.002 lr a step at these betas over 4 steps, so two
    trajectories part by no more unless every sign differs) and the final
    moments within 1e-3 of each leaf's max."""
    cfg, tcfg, ocfg, dcfg = _resume_setup()
    jstep = jax.jit(jst.make_train_step(cfg, jad.OptConfig(**ocfg)))
    tstep = tst.make_train_step(tcfg, tad.OptConfig(**ocfg))
    jp = jlm.init_params(cfg, jax.random.PRNGKey(0))
    jo = jad.init(jp)
    tp = bridge.to_torch(np_tree(jp), "cpu")
    to = bridge.to_opt_state(np_tree(jo), "cpu")
    lrs = []
    for s in range(4):
        x, y = batch_at(dcfg, 0, s)
        jp, jo, js = jstep(jp, jo, jnp.asarray(x), jnp.asarray(y))
        tp, to, ts = tstep(tp, to, torch.from_numpy(x), torch.from_numpy(y))
        np.testing.assert_allclose(float(ts["loss"]), float(js["loss"]),
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(ts["grad_norm"]),
                                   float(js["grad_norm"]), rtol=NORM_RTOL)
        lrs.append(float(js["lr"]))
    for a, b in zip(leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=2.01 * sum(lrs) + P_ATOL)
    for tree_t, tree_j in ((to.m, jo.m), (to.v, jo.v)):
        for a, b in zip(leaves(tree_t), jax.tree.leaves(tree_j)):
            b = np.asarray(b)
            np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                       atol=1e-3 * float(np.abs(b).max()))


# ---------------------------------------------------------------------------
# checkpoint
# ---------------------------------------------------------------------------
def _tree():
    return {"a": torch.arange(12, dtype=torch.float32).reshape(4, 3),
            "b": {"c": torch.ones((8,), dtype=torch.int32),
                  "d": torch.zeros((), dtype=torch.float32)}}


def _jtree():
    return {"a": jnp.arange(12, dtype=jnp.float32).reshape(4, 3),
            "b": {"c": jnp.ones((8,), jnp.int32),
                  "d": jnp.zeros((), jnp.float32)}}


def _same(a_tree, b_tree):
    la, lb = leaves(a_tree), leaves(b_tree)
    assert len(la) == len(lb)
    for a, b in zip(la, lb):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


def test_checkpoint_roundtrip(tmp_path):
    tree = _tree()
    tck.save(str(tmp_path), 3, tree)
    out, step = tck.load(str(tmp_path), tree)
    assert step == 3
    _same(tree, out)


def test_checkpoint_elastic_reshard(tmp_path):
    """Saved in 4 shards, loaded whole (another 'node count')."""
    tree = _tree()
    tck.save(str(tmp_path), 1, tree, shards=4)
    assert len(list((tmp_path / "step_00000001").glob("shard_*.npz"))) == 4
    out, _ = tck.load(str(tmp_path), tree)
    _same(tree, out)


def test_checkpoint_detects_corruption(tmp_path):
    tree = _tree()
    tck.save(str(tmp_path), 1, tree)
    tck.save(str(tmp_path), 2, tree)
    fn = tmp_path / "step_00000002" / "shard_0000.npz"
    with open(fn, "r+b") as f:
        f.seek(10)
        f.write(b"\x00\x00\x00\x00")
    assert tck.latest_step(str(tmp_path)) == 1      # falls back
    _, step = tck.load(str(tmp_path), tree)
    assert step == 1


def test_checkpoint_async(tmp_path):
    tree = _tree()
    th = tck.save(str(tmp_path), 5, tree, async_write=True)
    th.join(timeout=60)
    assert not th.is_alive()
    out, step = tck.load(str(tmp_path), tree)
    assert step == 5
    _same(tree, out)
    assert not (tmp_path / "step_00000005.tmp").exists()


def test_checkpoint_bf16_roundtrip(tmp_path):
    """bfloat16 leaves come back bit for bit (stored as uint16 words, named
    "bfloat16" in the manifest), also across shards."""
    g = torch.Generator().manual_seed(3)
    w = torch.randn((6, 5), generator=g).to(torch.bfloat16)
    tree = {"w": w, "v": [torch.randn((4,), generator=g)
                          .to(torch.bfloat16)], "i": torch.arange(3)}
    tck.save(str(tmp_path), 7, tree, shards=2)
    out, step = tck.load(str(tmp_path), tree)
    assert step == 7
    _same(tree, out)
    import json
    manifest = json.loads((tmp_path / "step_00000007" /
                           "manifest.json").read_text())
    assert [x["dtype"] for x in manifest["leaves"]] == \
        ["int64", "bfloat16", "bfloat16"]


def test_jax_written_checkpoint_loads_in_the_port(tmp_path):
    """A JAX train state ({"p": params, "o": OptState}, float32) and the
    mixed test tree, written by the JAX package, restore exactly in the
    port (paths, named-tuple fields included, match)."""
    cfg = reduced(MORPH_LLAMA2_7B).replace(n_layers=2)
    jp = jlm.init_params(cfg, jax.random.PRNGKey(0))
    jstate = {"p": jp, "o": jad.init(jp)}
    jstate["o"] = jstate["o"]._replace(step=jnp.asarray(3, jnp.int32))
    jck.save(str(tmp_path / "a"), 3, jstate, shards=2)
    like = {"p": bridge.to_torch(np_tree(jp), "cpu"),
            "o": bridge.to_opt_state(np_tree(jstate["o"]), "cpu")}
    out, step = tck.load(str(tmp_path / "a"), like)
    assert step == 3 and int(out["o"].step) == 3
    for a, b in zip(leaves(out), jax.tree.leaves(jstate)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    jck.save(str(tmp_path / "b"), 1, _jtree())
    out, _ = tck.load(str(tmp_path / "b"), _tree())
    _same(_tree(), out)


def test_port_written_checkpoint_loads_in_jax(tmp_path):
    tree = _tree()
    tree["a"] = tree["a"] * 0.37
    tck.save(str(tmp_path), 4, tree, shards=4)
    jtree = jax.tree.map(lambda x: np.zeros(x.shape, x.dtype), _jtree())
    out, step = jck.load(str(tmp_path), jtree)
    assert step == 4
    for a, b in zip(jax.tree.leaves(out), leaves(tree)):
        assert a.dtype == b.numpy().dtype
        np.testing.assert_array_equal(a, b.numpy())


def test_jax_written_bf16_checkpoint_reads_in_the_port(tmp_path):
    w = jax.random.normal(jax.random.PRNGKey(2), (8, 3)).astype(jnp.bfloat16)
    jtree = {"w": w, "f": jnp.ones((2,), jnp.float32)}
    jck.save(str(tmp_path), 9, jtree, shards=2)
    like = {"w": torch.zeros((8, 3), dtype=torch.bfloat16),
            "f": torch.zeros(2)}
    out, step = tck.load(str(tmp_path), like)
    assert step == 9 and out["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(out["w"].view(torch.int16).numpy(),
                                  np.asarray(w).view(np.int16))
    np.testing.assert_array_equal(out["f"].numpy(), np.ones(2, np.float32))


def test_jax_checkpoint_cannot_restore_bf16(tmp_path):
    """The reference's fault: its ``load`` casts the bf16 leaf, which numpy
    read as an opaque 2-byte array, and numpy has no such cast."""
    jtree = {"w": jnp.ones((4,), jnp.bfloat16)}
    jck.save(str(tmp_path), 1, jtree)
    with pytest.raises(ValueError, match="No cast function"):
        jck.load(str(tmp_path), jtree)
    out, _ = tck.load(str(tmp_path),
                      {"w": torch.zeros(4, dtype=torch.bfloat16)})
    assert torch.equal(out["w"], torch.ones(4, dtype=torch.bfloat16))


# ---------------------------------------------------------------------------
# cell shapes at full width: the meta tensors against jax.eval_shape
# ---------------------------------------------------------------------------
def _shapes(tree_j, tree_t):
    jl = [(j_path_str(p), tuple(x.shape), str(np.dtype(x.dtype)))
          for p, x in jax.tree_util.tree_flatten_with_path(tree_j)[0]]
    tl = [(path_str(p), tuple(x.shape), str(x.dtype).replace("torch.", ""))
          for p, x in flatten_with_path(tree_t)]
    assert all(x.is_meta for x in leaves(tree_t))
    return jl, tl


@pytest.mark.parametrize("name", sorted(ALL_CONFIGS))
def test_cell_shapes_match_eval_shape(name):
    jcfg, tcfg = ALL_CONFIGS[name], t_get_config(name)
    jl, tl = _shapes(jst.params_shape(jcfg), tst.params_shape(tcfg))
    assert jl == tl
    jl, tl = _shapes(jst.opt_state_shape(jcfg), tst.opt_state_shape(tcfg))
    assert jl == tl
    from repro_torch.configs.base import SHAPES_BY_NAME
    for shape in applicable_shapes(jcfg):
        tshape = SHAPES_BY_NAME[shape.name]
        jl, tl = _shapes(jst.input_specs(jcfg, shape),
                         tst.input_specs(tcfg, tshape))
        assert jl == tl, shape.name
        jl, tl = _shapes(jst.cache_shape(jcfg, shape),
                         tst.cache_shape(tcfg, tshape))
        assert jl == tl, shape.name


# ---------------------------------------------------------------------------
# the training example
# ---------------------------------------------------------------------------
def test_train_small_torch_example_resumes(tmp_path, capsys, deterministic):
    """``examples/train_small_torch.py --device cpu``: 6 steps with a
    checkpoint every 3, then a run to 9 that resumes from step 6; its
    step-9 checkpoint equals an uninterrupted 9-step run's, bit for bit."""
    spec = importlib.util.spec_from_file_location(
        "train_small_torch", ROOT / "examples" / "train_small_torch.py")
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    common = ["--device", "cpu", "--ckpt-every", "3"]
    ex.main(common + ["--steps", "6", "--ckpt-dir", a])
    assert tck.latest_step(a) == 6
    ex.main(common + ["--steps", "9", "--ckpt-dir", a])
    assert "resumed from step 6" in capsys.readouterr().out
    ex.main(common + ["--steps", "9", "--ckpt-dir", b])
    import json
    for d in (a, b):
        assert json.loads((pathlib.Path(d) / "step_00000009" /
                           "manifest.json").read_text())["step"] == 9
    ra, rb = (np.load(pathlib.Path(d) / "step_00000009" / "shard_0000.npz")
              for d in (a, b))
    assert ra.files == rb.files
    for k in ra.files:
        np.testing.assert_array_equal(ra[k], rb[k])
