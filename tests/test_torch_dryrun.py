"""The port's dry run (``repro_torch.launch``: ``mesh``, ``quant_specs``,
``step_analysis``, ``dryrun``) and the ``ShardCtx`` hints, against the JAX
package.

(a) Small meshes against the JAX compile. A subprocess runs the JAX
    ``build_cell`` -> ``lower`` -> ``compile`` -> ``analyze_hlo`` +
    ``memory_analysis`` on 8 forced CPU devices, a ``(2, 4)`` mesh over
    ``("data", "model")``, for the reduced Llama-2-7B, OLMo-1B, DeepSeek-V3
    and Mamba-2 at S = 64, B = 8 of each step kind, fp and (serve kinds)
    int4. Its mesh has Auto axes: ``jax.make_mesh`` in this JAX makes
    Explicit ones, on which the JAX ``ShardCtx`` hints raise. The port
    analyzes the same cells on a fake 8-rank ``DeviceMesh``. Held:
    ``argument_size_in_bytes`` equal; ``hlo_dot_flops`` and
    ``hlo_dot_bytes`` within ``RTOL`` (5 %); each collective kind's bytes
    within a factor ``COLL_FACTOR`` (4) of GSPMD's, a kind one side has and
    the other has not being a difference; the total collective bytes
    within ``COLL_FACTOR``. Every difference outside a tolerance is named
    in ``RECORDED`` with its reason (ROADMAP §3 lists them), and the test
    fails on one that is not.
(b) Every config at full width on both production meshes, shapes only:
    ``quantized_params_shape`` leaf by leaf against the JAX one, and the
    per-device argument bytes of every cell (fp, and int4 for the serve
    cells) against the JAX spec trees' shard shapes on an ``AbstractMesh``.
    Exact, but for one recorded repair: a layer's bias stacked over the
    layers (``STACKED_BIASES``), which the JAX rule quantizes and its own
    step then cannot run, stays a vector in the port (and in the JAX tree
    the bytes are held against).
(c) The CLI: ``--all-shapes`` of Mamba-2 780M at full width over the
    256-rank mesh, in a subprocess; every cell ``ok``.
(d) ``ShardCtx``: the identity without a mesh (logits and gradients bit
    for bit); under the dry run its records are the JAX hint sites' (site,
    shape, dtype, spec), read from the JAX step traced with a recording
    ``constrain``.
Also: MoE's padded dispatch against the row-sorted one and JAX, the rules
of ``step_analysis`` on hand-sized cases, and ``FlopCounterMode``'s count
on one device.
"""
import functools
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh, AxisType, NamedSharding
from jax.sharding import PartitionSpec as JP
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import ALL_CONFIGS as J_CONFIGS
from repro.configs import applicable_shapes as j_applicable
from repro.configs.archs import reduced as j_reduced
from repro.configs.base import ShapeSpec as JShape
from repro.distributed import sharding as jsh
from repro.launch import quant_specs as jqs
from repro.launch import steps as jst
from repro.models import layers as jL
from repro.models import lm as jlm
from repro.models import moe as jmo
from repro.optim import adamw as jadamw
from repro.quant.qlinear import QTensor as JQTensor
from repro_torch import bridge
from repro_torch.configs import ALL_CONFIGS, applicable_shapes, get_config
from repro_torch.configs.archs import reduced
from repro_torch.configs.base import ShapeSpec
from repro_torch.kernels import ops
from repro_torch.launch import dryrun, quant_specs
from repro_torch.launch import mesh as M
from repro_torch.launch import steps as tst
from repro_torch.launch.step_analysis import KINDS, StepAnalysis
from repro_torch.models import layers as tL
from repro_torch.models import lm as tlm
from repro_torch.models import moe as tmo
from repro_torch.quant import QTensor
from repro_torch.quant import qlinear as tq

ROOT = pathlib.Path(__file__).resolve().parents[1]
SMALL_AXES = {"data": 2, "model": 4}
SEQ, BATCH = 64, 8
SMALL_ARCHS = ("morph-llama2-7b", "olmo-1b", "deepseek-v3-671b",
               "mamba2-780m")
CELLS = [(a, k, q) for a in SMALL_ARCHS
         for k in ("train", "prefill", "decode")
         for q in ((False,) if k == "train" else (False, True))]
RTOL = 0.05
COLL_FACTOR = 4.0

_GRAD = ("train: the FSDP rule reduce-scatters each weight gradient onto "
         "its parameter's shard; GSPMD on these meshes all-reduces, or "
         "gathers the activations, and has no reduce-scatter")
_DECODE = ("decode: the analysis keeps a row-parallel weight's data split and "
           "gathers the 8-token activation (fewer bytes), so the residual "
           "add moves the output between dims (all-to-all); GSPMD gathers "
           "the weight")
_MOE = ("MoE dispatch buffers: the analysis reduce-scatters the token "
        "scatter onto the hint's capacity split and moves rows between dims "
        "(all-to-all); GSPMD all-gathers and permutes rows "
        "(collective-permute)")
_SSD = ("Mamba-2's SSD: the analysis keeps the (B, C) pieces of in_proj "
        "split over model, so the scan's contractions over d_state leave "
        "partial sums (all-reduce) and its matmul operands are smaller; "
        "GSPMD replicates B and C, and JAX's decode state update is a dot "
        "where the port's is an elementwise product")
# (arch, step kind, metric): why the port's number is outside its tolerance
RECORDED = {
    **{(a, "train", "coll_reduce-scatter"): _GRAD for a in SMALL_ARCHS},
    **{(a, "decode", "coll_all-to-all"): _DECODE for a in SMALL_ARCHS},
    **{("deepseek-v3-671b", k, m): _MOE
       for k in ("train", "prefill")
       for m in ("coll_all-to-all", "coll_collective-permute",
                 "coll_reduce-scatter")},
    **{("mamba2-780m", k, m): _SSD
       for k in ("train", "prefill", "decode")
       for m in ("hlo_dot_bytes", "coll_all-reduce", "coll_all-to-all")},
}

JAX_SCRIPT = r"""
import json, sys
import jax
from jax.sharding import AxisType
from repro.configs import get_config
from repro.configs.archs import reduced
from repro.configs.base import ShapeSpec
from repro.launch import dryrun as D
from repro.launch.hlo_analysis import analyze_hlo
cells = json.loads(sys.argv[1])
mesh = jax.make_mesh((2, 4), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
out = {}
for arch, kind, seq, batch, quant in cells:
    cfg = reduced(get_config(arch))
    with mesh:
        jf, args = D.build_cell(cfg, ShapeSpec(kind, seq, batch, kind),
                                mesh, quant=quant)
        c = jf.lower(*args).compile()
        rec = analyze_hlo(c.as_text())
        rec["argument_size_in_bytes"] = int(
            c.memory_analysis().argument_size_in_bytes)
    out["/".join([arch, kind, "int4" if quant else "fp"])] = rec
print(json.dumps(out))
"""


def _key(arch, kind, quant):
    return "/".join([arch, kind, "int4" if quant else "fp"])


def _env(**kw):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.update(kw)
    return env


@functools.lru_cache(maxsize=None)
def jax_records(arch):
    """The JAX compile's records of ``arch``'s small cells (one
    subprocess: the 8 forced devices must be set before JAX starts)."""
    cells = [[a, k, SEQ, BATCH, q] for a, k, q in CELLS if a == arch]
    r = subprocess.run(
        [sys.executable, "-c", JAX_SCRIPT, json.dumps(cells)],
        env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=8"),
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@functools.lru_cache(maxsize=None)
def port_records(arch):
    """The port's records of the same cells on a fake 8-rank mesh."""
    out = {}
    with M.fake_world(8):
        mesh = M.make_mesh((2, 4), ("data", "model"))
        for a, k, q in CELLS:
            if a == arch:
                cell = dryrun.build_cell(reduced(get_config(a)),
                                         ShapeSpec(k, SEQ, BATCH, k), mesh,
                                         quant=q)
                out[_key(a, k, q)] = dryrun.analyze_cell(cell)
    return out


def compare(port, jax_rec):
    """{metric: (port, JAX)} of each metric outside its tolerance."""
    bad = {}
    for m in ("hlo_dot_flops", "hlo_dot_bytes"):
        if abs(port[m] - jax_rec[m]) > RTOL * jax_rec[m]:
            bad[m] = (port[m], jax_rec[m])
    total_p = total_j = 0.0
    for k in KINDS:
        p, j = port.get("coll_" + k, 0.0), jax_rec.get("coll_" + k, 0.0)
        total_p, total_j = total_p + p, total_j + j
        if (p > 0) != (j > 0) or (p > 0 and not
                                  1 / COLL_FACTOR <= p / j <= COLL_FACTOR):
            bad["coll_" + k] = (p, j)
    if not 1 / COLL_FACTOR <= total_p / total_j <= COLL_FACTOR:
        bad["coll_total"] = (total_p, total_j)
    return bad


@pytest.mark.parametrize("arch,kind,quant", CELLS,
                         ids=[_key(*c) for c in CELLS])
def test_small_mesh_cell_against_jax(arch, kind, quant):
    key = _key(arch, kind, quant)
    j, t = jax_records(arch)[key], port_records(arch)[key]
    assert t["argument_size_in_bytes"] == j["argument_size_in_bytes"]
    assert t["unmodelled_ops"] == {}
    bad = compare(t, j)
    unrecorded = {m: v for m, v in bad.items()
                  if (arch, kind, m) not in RECORDED}
    assert not unrecorded, f"{key}: port vs JAX {unrecorded}"


# ---------------------------------------------------------------------------
# (b) every config at full width on both production meshes: shapes only
# ---------------------------------------------------------------------------
MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}
# (L, N) biases of stacked layers with at least MIN_SIZE elements: the JAX
# rule quantizes them, the port keeps them vectors (ROADMAP §3)
STACKED_BIASES = {
    "internvl2-1b": {("segments", 0, 0, "attn", "bq")},
    "qwen2-1.5b": {("segments", 0, 0, "attn", "bq")},
    "whisper-small": {("dec_blocks", "mlp", "b_up"),
                      ("enc_blocks", "mlp", "b_up")},
}


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@functools.lru_cache(maxsize=None)
def _jax_params(name, quant, repaired=True):
    """The JAX params shape, and its int4 tree by the JAX rule (with the
    stacked biases put back unless ``repaired=False``)."""
    cfg = J_CONFIGS[name]
    p = jst.params_shape(cfg)
    if not quant:
        return p
    q = jqs.quantized_params_shape(cfg, p)
    for path in STACKED_BIASES.get(name, ()) if repaired else ():
        _at(q, path[:-1])[path[-1]] = _at(p, path)
    return q


def _jax_arg_bytes(name, shape, axes, quant):
    """Bytes on one device of the JAX cell's arguments: each leaf's shard
    shape under its spec on an abstract mesh."""
    cfg = J_CONFIGS[name]
    mesh = AbstractMesh(tuple(axes.values()), tuple(axes),
                        axis_types=(AxisType.Auto,) * len(axes))
    pshape = _jax_params(name, quant)
    pspec = jsh.param_specs(cfg, pshape, axes, fsdp=True)
    inp = jst.input_specs(cfg, shape)
    pairs = [(pshape, pspec)]
    if shape.kind == "train":
        oshape = jax.eval_shape(jadamw.init, pshape)
        pairs.append((oshape, jadamw.OptState(JP(), pspec, pspec)))
    elif shape.kind == "decode":
        cshape = jst.cache_shape(cfg, shape)
        pairs.append((cshape, jsh.cache_specs(cshape, axes)))
    for v in inp.values():
        pairs.append((v, jsh.data_spec(v.shape, axes)))
    total = 0
    for tree, specs in pairs:
        leaves = jax.tree_util.tree_leaves(tree)
        sp = jax.tree_util.tree_leaves(
            specs, is_leaf=lambda x: isinstance(x, JP))
        assert len(leaves) == len(sp)
        for leaf, s in zip(leaves, sp):
            local = NamedSharding(mesh, s).shard_shape(leaf.shape)
            total += int(np.prod(local)) * np.dtype(leaf.dtype).itemsize
    return total


def _flat_q(tree, qt_type):
    out = []

    def walk(path, node):
        if isinstance(node, qt_type):
            out.append((path, ("q", node.bits, node.group, node.K, node.N,
                                tuple(node.packed.shape),
                                tuple(node.scales.shape),
                                tuple(node.zeros.shape),
                                str(node.packed.dtype).split(".")[-1])))
        elif isinstance(node, dict):
            for k in sorted(node):
                walk(path + (k,), node[k])
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(path + (i,), v)
        elif node is not None:
            out.append((path, (tuple(node.shape),
                               str(node.dtype).split(".")[-1])))
    walk((), tree)
    return out


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("name", sorted(ALL_CONFIGS))
def test_full_width_specs_and_argument_bytes_match_jax(name, mesh):
    axes = MESHES[mesh]
    tcfg = get_config(name)
    tq_tree = quant_specs.quantized_params_shape(tcfg,
                                                 tst.params_shape(tcfg))
    got = dict(_flat_q(tq_tree, QTensor))
    want = dict(_flat_q(_jax_params(name, True, repaired=False), JQTensor))
    assert got.keys() == want.keys()
    assert {p for p in want if got[p] != want[p]} == \
        STACKED_BIASES.get(name, set())
    assert got == dict(_flat_q(_jax_params(name, True), JQTensor))
    jshapes = {s.name: s for s in j_applicable(J_CONFIGS[name])}
    for shape in applicable_shapes(tcfg):
        for quant in (False, True) if shape.kind != "train" else (False,):
            cell = dryrun.build_cell(tcfg, shape, axes, quant=quant)
            got = dryrun.argument_bytes(cell)
            want = _jax_arg_bytes(name, jshapes[shape.name], axes, quant)
            assert got == want, (shape.name, quant)


@pytest.mark.parametrize("name", sorted(STACKED_BIASES))
def test_jax_int4_tree_of_stacked_biases_cannot_run(name):
    """The JAX prefill step traced on its own int4 tree raises (a stacked
    bias's QTensor children have other leading sizes than the layers);
    on the tree with the biases kept vectors it runs."""
    cfg = J_CONFIGS[name]
    inp = jst.input_specs(cfg, JShape("p", 64, 2, "prefill"))
    args = (inp["tokens"],) + ((inp["frontend"],) if "frontend" in inp
                               else ())
    step = jst.make_prefill_step(cfg)
    with pytest.raises(ValueError, match="leading axis sizes"):
        jax.eval_shape(step, _jax_params(name, True, repaired=False), *args)
    out = jax.eval_shape(step, _jax_params(name, True), *args)
    assert out.shape == (2, cfg.vocab)


# ---------------------------------------------------------------------------
# (c) the CLI at full width over 256 fake ranks
# ---------------------------------------------------------------------------
def test_cli_all_shapes_full_width(tmp_path):
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "mamba2-780m", "--all-shapes", "--out", str(tmp_path)],
        env=_env(), capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    recs = [json.loads(p.read_text()) for p in sorted(tmp_path.glob("*"))]
    names = sorted(p.name for p in tmp_path.glob("*"))
    assert names == sorted(f"mamba2-780m_{s.name}_16x16.json" for s in
                           applicable_shapes(get_config("mamba2-780m")))
    for rec in recs:
        assert rec["status"] == "ok" and rec["n_devices"] == 256
        assert rec["hlo_dot_flops"] > 0 and rec["argument_size_in_bytes"] > 0
        assert rec["hlo_dot_flops"] <= rec["global_dot_flops"]
        for k in ("generated_code_size_in_bytes", "temp_size_in_bytes",
                  "compile_s"):
            assert k not in rec
    train = next(r for r in recs if r["shape"] == "train_4k")
    assert train["coll_reduce-scatter"] > 0       # FSDP gradients


def test_a_failing_cell_is_recorded_and_fails_the_cli(tmp_path,
                                                      monkeypatch):
    """A cell that raises writes ``status: "fail"`` with its error and
    traceback, as the JAX dry run does, and the CLI exits 1."""
    def boom(*a, **k):
        raise ValueError("no layout")
    monkeypatch.setattr(dryrun, "build_cell", boom)
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "olmo-1b", "--shape", "decode_32k",
                     "--out", str(tmp_path)])
    assert e.value.code == 1
    rec = json.loads((tmp_path / "olmo-1b_decode_32k_16x16.json")
                     .read_text())
    assert rec["status"] == "fail"
    assert rec["error"] == "ValueError: no layout"
    assert "boom" in rec["traceback"]
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# (d) ShardCtx
# ---------------------------------------------------------------------------
def _tokens(cfg, B=2, S=16, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, cfg.vocab, (B, S))
                            .astype(np.int64))


@pytest.mark.parametrize("name", ["morph-llama2-7b", "deepseek-v3-671b"])
def test_shard_ctx_without_a_mesh_is_the_identity(name):
    """A hint without axes returns its tensor; with axes but no analysis
    too. Forward logits and train gradients are bit for bit those of the
    call without a context."""
    x = torch.randn(2, 3)
    assert tL.NO_SHARD.constrain(x, (None, None)) is x
    assert tL.ShardCtx("data", "model").constrain(x, ("data", None)) is x
    cfg = reduced(get_config(name))
    params = tlm.init_params(cfg, torch.Generator().manual_seed(0))
    tok = _tokens(cfg)
    ctx = tL.ShardCtx("data", "model")
    want = tlm.forward(cfg, params, tok)
    assert torch.equal(tlm.forward(cfg, params, tok, ctx=ctx), want)
    lg, lg_ctx = tst.make_loss_and_grad(cfg), tst.make_loss_and_grad(cfg, ctx)
    (l0, g0), (l1, g1) = lg(params, tok, tok), lg_ctx(params, tok, tok)
    assert torch.equal(l0, l1)
    for a, b in zip(jax.tree.leaves(g0, is_leaf=torch.is_tensor),
                    jax.tree.leaves(g1, is_leaf=torch.is_tensor)):
        assert torch.equal(a, b)


_JAX_SITES = {"gqa_apply": "layers.gqa_apply",
              "mla_apply": "layers.mla_apply", "forward": "lm.forward",
              "loss_fn": "steps.loss"}
_JAX_MOE_LINES = {107: "moe.dispatch", 111: "moe.hidden",
                  113: "moe.combine"}


def _spec(entries):
    """A spec's entries as None or a tuple of axis names."""
    return tuple(None if e is None else (e,) if isinstance(e, str)
                 else tuple(e) for e in entries)


def _jax_hints(cfg, shape):
    """(site, shape, dtype, spec) of every JAX hint met while tracing the
    cell's step with a ``ShardCtx`` over data and model (its
    ``constrain`` swapped for a recorder: no mesh is needed)."""
    seen = set()
    orig = jL.ShardCtx.constrain

    def record(self, x, spec):
        f = sys._getframe(1)
        site = _JAX_MOE_LINES.get(f.f_lineno) if f.f_code.co_name == \
            "moe_apply" else _JAX_SITES[f.f_code.co_name]
        seen.add((site, tuple(x.shape), str(x.dtype), _spec(spec)))
        return x

    jL.ShardCtx.constrain = record
    try:
        ctx = jL.ShardCtx("data", "model")
        pshape = jst.params_shape(cfg)
        inp = jst.input_specs(cfg, shape)
        front = (inp["frontend"],) if "frontend" in inp else ()
        if shape.kind == "train":
            fn = jst.make_train_step(cfg, jadamw.OptConfig(), ctx)
            args = (pshape, jax.eval_shape(jadamw.init, pshape),
                    inp["tokens"], inp["labels"]) + front
        else:
            fn = jst.make_prefill_step(cfg, ctx)
            args = (pshape, inp["tokens"]) + front
        jax.eval_shape(fn, *args)
    finally:
        jL.ShardCtx.constrain = orig
    return seen


@pytest.mark.parametrize("kind", ["train", "prefill"])
@pytest.mark.parametrize("name", ["morph-llama2-7b", "deepseek-v3-671b",
                                  "mamba2-780m", "whisper-small"])
def test_hint_records_match_jax_sites(name, kind):
    shape = ShapeSpec(kind, 32, 4, kind)
    cell = dryrun.build_cell(reduced(get_config(name)), shape, SMALL_AXES)
    rec = dryrun.analyze_cell(cell)
    got = {(r["site"], tuple(r["shape"]), r["dtype"], _spec(r["spec"]))
           for r in rec["hints"]}
    want = _jax_hints(j_reduced(J_CONFIGS[name]),
                      JShape(kind, 32, 4, kind))
    assert got == want
    assert {s for s, *_ in got} >= ({"lm.forward"} if name != "whisper-small"
                                    else {"layers.gqa_apply"})


# ---------------------------------------------------------------------------
# MoE: the padded dispatch
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=1)
def _moe_layer():
    jc = j_reduced(J_CONFIGS["deepseek-v3-671b"])
    tc = reduced(get_config("deepseek-v3-671b"))
    params = jlm.init_params(jc, jax.random.PRNGKey(0))
    jp = jlm.params_to_layer_list(jc, params)[1][1]["moe"]
    tp = bridge.to_torch(jax.tree.map(np.asarray, jp), "cpu")
    return jc, tc, jp, tp


@pytest.mark.parametrize("cf", [-1.0, 1.25])
def test_padded_dispatch_is_the_same_function(cf):
    """The dry run's padded dispatch against the row-sorted one and the
    JAX ``moe_apply`` (float32; 2e-5, the MoE tests' tolerance), and its
    shapes on ``meta``."""
    jc, tc, jp, tp = _moe_layer()
    x = np.random.default_rng(3).standard_normal((2, 16, 128)).astype(
        np.float32)
    xt = torch.from_numpy(x)
    got, aux = tmo.padded_dispatch(tp, tc, xt, capacity_factor=cf)
    sorted_y, sorted_aux = tmo.moe_apply(tp, tc, xt, capacity_factor=cf)
    want, waux = jmo.moe_apply(jp, jc, jnp.asarray(x), capacity_factor=cf)
    np.testing.assert_allclose(got.numpy(), sorted_y.numpy(),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)
    for k in ("expert_load", "dropped_frac", "router_entropy"):
        np.testing.assert_allclose(aux[k].numpy(), np.asarray(waux[k]),
                                   rtol=2e-5, atol=2e-5)
    meta_tp = {k: (v.to("meta") if torch.is_tensor(v) else
                   {kk: vv.to("meta") for kk, vv in v.items()})
               for k, v in tp.items()}
    y, maux = tmo.moe_apply(meta_tp, tc, xt.to("meta"), capacity_factor=cf)
    assert y.is_meta and tuple(y.shape) == x.shape
    assert tuple(maux["expert_load"].shape) == (tc.moe.n_routed_experts,)


# ---------------------------------------------------------------------------
# the mesh and the analysis's rules
# ---------------------------------------------------------------------------
def test_production_meshes_over_a_fake_world():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        M.make_production_mesh()
    for multi_pod, n, dims in ((False, 256, {"data": 16, "model": 16}),
                               (True, 512, {"pod": 2, "data": 16,
                                            "model": 16})):
        with M.fake_world(n):
            mesh = M.make_production_mesh(multi_pod=multi_pod)
            assert dict(zip(mesh.mesh_dim_names, mesh.shape)) == dims
            with pytest.raises(RuntimeError, match="ranks"):
                M.make_mesh((4, 4), ("data", "model"))
    assert not dist.is_initialized()


def test_fsdp_matmul_gathers_the_weight_and_scatters_its_gradient():
    """x (8, 16) split on data times W (16, 32) split (data, model) on a
    2 x 4 mesh: W gathered over data (its local (16, 8) f32 = 512 bytes),
    local FLOPs 2 x 4 x 16 x 8; the gradient of W (x^T over the split
    tokens: a partial sum, as many FLOPs) reduce-scattered onto W's own
    layout (local (8, 8) f32 = 256 bytes)."""
    an = StepAnalysis(SMALL_AXES)
    x = torch.empty(8, 16, device="meta")
    w = torch.empty(16, 32, device="meta", requires_grad=True)
    an.place(x, ("data", None))
    an.place(w, ("data", "model"))
    with an:
        y = x @ w
        (g,) = torch.autograd.grad((y * y).sum(), [w])
        torch.square(g)        # a non-linear use: the sum is due
    assert an.layout(y)[0] == (("data",), ("model",))
    assert an.count["all-gather"] >= 1 and an.coll["all-gather"] >= 512
    assert an.flops == 2 * 4 * 16 * 8 + 2 * 16 * 4 * 8
    assert an.global_flops == 2 * 8 * 16 * 32 * 2
    assert an.coll["reduce-scatter"] == 256
    assert an.layout(g) == ((("data",), ("model",)), ())


def test_reshape_splits_an_axis_across_dims_and_back():
    """A 4-way model split of 4 heads viewed as (2 kv heads, 2 groups):
    2 on each (sub-axes), merged back to the whole axis."""
    an = StepAnalysis(SMALL_AXES)
    q = torch.empty(8, 64, 4, 32, device="meta")
    an.place(q, ("data", None, "model", None))
    with an:
        g = q.reshape(8, 64, 2, 2, 32)
        back = g.reshape(8, 64, 4, 32)
    sg = an.layout(g)[0]
    assert [an.size[a] for a in sg[2] + sg[3]] == [2, 2]
    assert an.layout(back)[0] == (("data",), (), ("model",), ())
    assert an.coll["all-gather"] == 0


def test_one_device_counts_what_flop_counter_counts():
    """On a 1 x 1 mesh the analysis's per-device and global matmul FLOPs
    are ``FlopCounterMode``'s count of the same train step."""
    cfg = reduced(get_config("morph-llama2-7b"))
    shape = ShapeSpec("train", 64, 2, "train")
    rec = dryrun.analyze_cell(dryrun.build_cell(
        cfg, shape, {"data": 1, "model": 1}))
    cell = dryrun.build_cell(cfg, shape, {"data": 1, "model": 1})
    with FlopCounterMode(display=False) as fc:
        cell.step(*cell.args)
    assert rec["hlo_dot_flops"] == rec["global_dot_flops"] \
        == fc.get_total_flops()
    assert rec["coll_all-gather"] == rec["coll_all-reduce"] == 0


def test_wna16_route_takes_the_plain_version_on_meta():
    """A kernel-flagged int4 weight on ``meta`` (the dry run's int4 cells
    with the flag) multiplies through the plain version: shapes only."""
    w = tq.quantize_tensor(torch.randn(64, 48), bits=4, group=32,
                           use_kernel=True)
    wm = QTensor(w.packed.to("meta"), w.scales.to("meta"),
                 w.zeros.to("meta"), bits=4, group=32, K=64, N=48,
                 use_kernel=True)
    y = ops.wna16_matmul(torch.empty(5, 64, device="meta"), wm)
    assert y.is_meta and tuple(y.shape) == (5, 48)
