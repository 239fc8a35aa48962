"""The port's sharding rules (``repro_torch.distributed.sharding``) against
the JAX package's, entry by entry: parameter specs for every config at
full width (shapes from ``jax.eval_shape``, as ``meta`` tensors) and for
an int4-quantized tree, decode-cache specs over the port's own
``init_cache`` trees, data specs and batch axes, on three meshes with FSDP
on and off; the JAX unit cases; and the DTensor placements of a spec on a
``DeviceMesh`` (a fake process group: no card, no network).

Everything is compared exactly: the rules are pure functions of a leaf's
path and shape.
"""
import functools

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro.configs import ALL_CONFIGS, applicable_shapes
from repro.distributed import sharding as jsh
from repro.launch import steps as jst
from repro.launch.quant_specs import quantized_params_shape
from repro.models.registry import get_model as j_get_model
from repro.quant.qlinear import QTensor as JQTensor
from repro_torch.configs import get_config as t_get_config
from repro_torch.distributed import sharding as tsh
from repro_torch.distributed.sharding import P
from repro_torch.models import registry
from repro_torch.quant import QTensor

MESHES = {"model16": {"model": 16},
          "data16_model16": {"data": 16, "model": 16},
          "pod2_data8_model4": {"pod": 2, "data": 8, "model": 4}}
CONFIGS = sorted(ALL_CONFIGS)


def _meta(tree):
    """A JAX shape tree (ShapeDtypeStructs, JAX QTensors) as the port's tree
    of ``meta`` tensors, containers kept."""
    if isinstance(tree, dict):
        return {k: _meta(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_meta(v) for v in tree)
    if isinstance(tree, JQTensor):
        return QTensor(_meta(tree.packed), _meta(tree.scales),
                       _meta(tree.zeros), bits=tree.bits, group=tree.group,
                       K=tree.K, N=tree.N,
                       inv_act=None if tree.inv_act is None
                       else _meta(tree.inv_act))
    if tree is None:
        return None
    return torch.empty(tree.shape, device="meta")


@functools.lru_cache(maxsize=None)
def _params_shape(name, quant=False):
    shape = jst.params_shape(ALL_CONFIGS[name])
    return quantized_params_shape(ALL_CONFIGS[name], shape) if quant \
        else shape


def _jflat(tree):
    """[(path string, spec entries)] of a JAX spec or shape tree."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return [(jsh.path_str(p), tuple(s) if isinstance(
        s, jax.sharding.PartitionSpec) else tuple(s.shape)) for p, s in flat]


def _tflat(tree):
    return [(tsh.path_str(p), tuple(s) if isinstance(s, P)
             else tuple(s.shape)) for p, s in tsh.tree_flatten_with_path(tree)]


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int4"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("name", CONFIGS)
def test_param_specs_match_jax(name, mesh, quant):
    """``param_specs`` over the config's full-width tree (and its all-int4
    variant, every large weight a QTensor: leaves ``.../0``-``/2``): the
    port's leaf paths and shapes are the JAX package's, and so is every
    spec, with FSDP off and on."""
    axes = MESHES[mesh]
    jshape = _params_shape(name, quant)
    tshape = _meta(jshape)
    assert _tflat(tshape) == _jflat(jshape)
    for fsdp in (False, True):
        want = _jflat(jsh.param_specs(ALL_CONFIGS[name], jshape, axes,
                                      fsdp=fsdp))
        got = tsh.param_specs(t_get_config(name), tshape, axes, fsdp=fsdp)
        assert _tflat(got) == want
        if quant:
            assert any(p.endswith("/0") for p, _ in want)
    if quant:
        # the spec tree keeps the QTensor records, children replaced
        got = tsh.param_specs(t_get_config(name), tshape, axes)
        assert any(isinstance(x, QTensor) for x in _walk(got))


def _walk(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _walk(v)
    elif isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        for v in tree:
            yield from _walk(v)
    else:
        yield tree


def test_qtensor_leaf_paths_match_jax():
    """A real int4 layer tree from each package's quantizer: JAX flattens a
    QTensor to its children by index and drops ``inv_act=None``; the
    port's paths are the same, with ``inv_act`` as ``/3`` when present."""
    from repro.quant.qlinear import quantize_tensor as jquant
    from repro_torch import bridge
    w = np.random.default_rng(0).standard_normal((256, 128)).astype(
        np.float32)
    jq = jquant(jax.numpy.asarray(w), bits=4, group=64)
    tree = {"segments": [({"mlp": {"w_up": jq}},)]}
    ttree = bridge.to_torch(jax.tree.map(np.asarray, tree), "cpu")
    jflat = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert [jsh.path_str(p) for p, _ in jflat] == \
        [tsh.path_str(p) for p, _ in tsh.tree_flatten_with_path(ttree)] == \
        [f"segments/0/0/mlp/w_up/{i}" for i in range(3)]
    for axes in MESHES.values():
        assert _tflat(tsh.param_specs(None, ttree, axes, fsdp=True)) == \
            _jflat(jsh.param_specs(None, tree, axes, fsdp=True))
    q = ttree["segments"][0][0]["mlp"]["w_up"]
    q.inv_act = torch.ones(256)
    assert tsh.path_str(tsh.tree_flatten_with_path(ttree)[-1][0]) == \
        "segments/0/0/mlp/w_up/3"


def _cache_cases(name):
    cfg = ALL_CONFIGS[name]
    return [(s.global_batch, s.seq_len) for s in applicable_shapes(cfg)
            if s.kind == "decode"]


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("name", CONFIGS)
def test_cache_and_data_specs_match_jax(name, mesh):
    """``cache_specs`` over the port's own ``init_cache`` tree (``meta``)
    at each decode shape of the config, against JAX's over its
    ``init_cache`` shapes; ``data_spec`` of every step input; and
    ``batch_axes``."""
    axes = MESHES[mesh]
    jcfg_, tcfg_ = ALL_CONFIGS[name], t_get_config(name)
    api = registry.get_model(tcfg_)
    cases = _cache_cases(name)
    assert cases
    for B, T in cases:
        jc = jax.eval_shape(lambda: j_get_model(jcfg_).init_cache(
            jcfg_, B, T))
        tc = api.init_cache(tcfg_, B, T, device="meta")
        assert _tflat(tc) == _jflat(jc)
        assert _tflat(tsh.cache_specs(tc, axes)) == \
            _jflat(jsh.cache_specs(jc, axes))
    for shape in applicable_shapes(jcfg_):
        for leaf in jst.input_specs(jcfg_, shape).values():
            assert tuple(tsh.data_spec(leaf.shape, axes)) == \
                tuple(jsh.data_spec(leaf.shape, axes))
    assert tsh.batch_axes(axes) == jsh.batch_axes(axes)
    assert tsh.batch_axes({}) == jsh.batch_axes({}) == (None,)


AXES = {"data": 16, "model": 16}
# the JAX package's unit cases (tests/test_distributed.py), each with what
# the rule must give
UNIT = [
    ("param", ("segments/0/0/attn/wq", (4096, 4096)), {}, (None, "model")),
    ("param", ("segments/0/0/attn/wo", (4096, 4096)), {}, ("model", None)),
    ("param", ("segments/0/0/attn/wq", (1600, 1602)), {}, (None, None)),
    ("param", ("segments/1/0/moe/w_gate", (256, 7168, 2048)), {},
     (("data", "model"), None, None)),
    ("param", ("segments/0/0/attn/wq", (4096, 4096)), {"fsdp": True},
     ("data", "model")),
    ("param", ("segments/1/0/moe/w_down", (256, 2048, 7168)), {"fsdp": True},
     (("data", "model"), None, None)),
    ("cache", ("segments/0/0/k", (16, 128, 32768, 16, 64)), {},
     (None, "data", "model", None, None)),
    ("cache", ("segments/0/0/k", (32, 1, 524288, 5, 64)), {},
     (None, None, "model", None, None)),
    ("data", ((256, 4096),), {}, ("data", None)),
    ("data", ((7, 4096),), {}, (None, None)),
]


@pytest.mark.parametrize("kind,args,kw,want", UNIT)
def test_unit_rules_match_jax(kind, args, kw, want):
    fn = {"param": "spec_for_param", "cache": "cache_spec",
          "data": "data_spec"}[kind]
    got = getattr(tsh, fn)(*args, AXES, **kw)
    assert isinstance(got, P)
    assert tuple(got) == tuple(getattr(jsh, fn)(*args, AXES, **kw)) == want
    used = [a for e in got for a in (e if isinstance(e, tuple) else (e,))
            if a]
    assert len(used) == len(set(used)), got


def test_path_str_normalizes():
    tree = {"a": [{"b": torch.zeros(2)}], "c": (None, torch.zeros(1))}
    paths = [tsh.path_str(p) for p, _ in tsh.tree_flatten_with_path(tree)]
    assert paths == ["a/0/b", "c/1"]
    jflat = jax.tree_util.tree_flatten_with_path(
        {"a": [{"b": np.zeros(2)}], "c": (None, np.zeros(1))})[0]
    assert [jsh.path_str(p) for p, _ in jflat] == paths


PLACEMENTS = [
    (P(None, "model"), ("data", "model"), (Replicate(), Shard(1))),
    (P("model", None), ("data", "model"), (Replicate(), Shard(0))),
    (P(("data", "model"), None, None), ("data", "model"),
     (Shard(0), Shard(0))),
    (P("data", "model"), ("data", "model"), (Shard(0), Shard(1))),
    (P("model", "data"), ("data", "model"), (Shard(1), Shard(0))),
    (P(("pod", "data"), None), ("pod", "data", "model"),
     (Shard(0), Shard(0), Replicate())),
    (P(None, None), ("model",), (Replicate(),)),
]


@pytest.mark.parametrize("spec,names,want", PLACEMENTS)
def test_placements(spec, names, want):
    assert tsh.placements(spec, names) == want


@pytest.mark.parametrize("spec,names,msg", [
    (P("model", None), ("data",), "not a dim of the mesh"),
    (P(("model", "data"), None), ("data", "model"), "out of the mesh's"),
    (P("data", "data"), ("data", "model"), "twice"),
])
def test_placements_refuse(spec, names, msg):
    with pytest.raises(ValueError, match=msg):
        tsh.placements(spec, names)


@pytest.fixture
def fake_world():
    """A process group of 8 fake ranks in this process: a DeviceMesh can be
    built over it, and no collective leaves the process."""
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_mesh_axes_and_dtensor_placements(fake_world):
    """``mesh_axes`` of a named 2 x 4 DeviceMesh, and a spec's placements
    on it give a DTensor sharded as the spec says (local (3, 5) blocks)."""
    mesh = DeviceMesh("cpu", torch.arange(8).reshape(2, 4),
                      mesh_dim_names=("data", "model"))
    axes = tsh.mesh_axes(mesh)
    assert axes == {"data": 2, "model": 4}
    for spec, shape in [(P("data", "model"), (6, 20)),
                        (P(("data", "model"), None), (24, 5)),
                        (P(None, "model"), (3, 20)),
                        (tsh.spec_for_param("x/wq", (3, 20), axes),
                         (3, 20))]:
        t = DTensor.from_local(torch.zeros(3, 5), mesh,
                               tsh.placements(spec, mesh.mesh_dim_names),
                               run_check=False)
        assert tuple(t.shape) == shape, spec
