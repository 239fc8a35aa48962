"""The dry run: every (arch x shape) cell on the production mesh, per device.

The JAX package's ``launch/dryrun.py`` lowers and compiles each cell under
a 256- or 512-device mesh and reads FLOPs, bytes and collectives from the
partitioned HLO. Here each cell's step runs once on ``meta`` tensors (no
allocation) under ``launch/step_analysis.StepAnalysis``, over a
``DeviceMesh`` of a fake process group (``launch/mesh.fake_world``: one
process, no card, no network). Its inputs take the sharding rules of
``distributed/sharding.py`` with FSDP on, as in JAX: ZeRO-3 for training,
weight gathering for serving.

Each cell writes ``<out>/<arch>_<shape>_<mesh>[_int4][_variant].json``:

  hlo_dot_flops        per-device FLOPs of the step's matmuls (forward,
                       backward and remat recompute of a train step)
  hlo_dot_bytes        lhs + rhs + out bytes of those matmuls, per device
  global_dot_flops     the same matmuls unsharded (FlopCounterMode's count)
  coll_<kind>, count_<kind>
                       per-device output bytes and number of all-gather,
                       all-reduce, reduce-scatter, all-to-all and
                       collective-permute ops; ``collectives`` {kind: bytes}
  argument_size_in_bytes
                       local shard bytes of params, AdamW state, cache and
                       inputs on one device
  n_devices, status, error, traceback, analyze_s
  hints                the ShardCtx hints met (site, shape, dtype, spec)
  unmodelled_ops       ops the analysis has no rule for, with counts
  moe_dispatch         "padded" for an MoE config: the JAX dispatch of
                       dense (E, C, D) buffers at the capacity factor of the
                       call (the port's row-sorted dispatch needs row counts
                       a meta tensor does not hold)

The JAX record's ``generated_code_size_in_bytes``, ``temp_size_in_bytes``,
``alias_size_in_bytes``, ``output_size_in_bytes``, ``cost_*``,
``lower_s`` and ``compile_s`` come from XLA's compiler and are not carried.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo-1b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo-1b --all-shapes
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes
Flags: --multi-pod (2x16x16 mesh), --both-meshes, --quant (the all-layers
int4 variant of every serve cell; a train cell stays fp: an int4 weight has
no gradient), --variant NAME (a ``knobs.VARIANTS`` entry), --jobs N (cells
in N processes), --out DIR (default experiments/dryrun_torch).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Any, Callable, Tuple

from repro_torch.configs import (ALL_CONFIGS, SHAPES_BY_NAME,
                                 applicable_shapes, get_config)
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import P
from repro_torch.launch import knobs as K
from repro_torch.launch import mesh as M
from repro_torch.launch import steps as st
from repro_torch.launch.step_analysis import StepAnalysis, place_tree
from repro_torch.models.layers import ShardCtx
from repro_torch.optim import adamw

OUT_DIR = os.path.join("experiments", "dryrun_torch")


@dataclasses.dataclass
class Cell:
    """One cell ready to analyze: ``step(*args)`` runs it; ``specs`` are
    ``args``' partition specs; ``analysis`` is the mode its hints feed."""
    step: Callable
    args: Tuple[Any, ...]
    specs: Tuple[Any, ...]
    analysis: StepAnalysis


def build_cell(cfg, shape, mesh, *, quant: bool = False) -> Cell:
    """The JAX ``build_cell``'s three step kinds: train (loss, gradient,
    AdamW; moments laid out as their parameter), prefill, and a decode
    step against a full-length cache; parameters by ``param_specs(...,
    fsdp=True)``, inputs by ``data_spec``, the cache by ``cache_specs``.
    ``mesh``: a DeviceMesh with named dims, or its {axis: size}."""
    axes = dict(mesh) if isinstance(mesh, dict) else shd.mesh_axes(mesh)
    an = StepAnalysis(axes)
    ctx = ShardCtx(data_axis="data" if "data" in axes else None,
                   model_axis="model" if "model" in axes else None,
                   sink=an)
    pshape = st.params_shape(cfg)
    if quant:
        from repro_torch.launch.quant_specs import quantized_params_shape
        pshape = quantized_params_shape(cfg, pshape)
    pspec = shd.param_specs(cfg, pshape, axes, fsdp=True)
    inp = st.input_specs(cfg, shape)
    ispec = {k: shd.data_spec(tuple(v.shape), axes) for k, v in inp.items()}
    front = ("frontend",) if "frontend" in inp else ()
    if shape.kind == "train":
        fn = st.make_train_step(cfg, adamw.OptConfig(), ctx)
        ospec = adamw.OptState(P(), pspec, pspec)
        names = ("tokens", "labels") + front
        return Cell(fn, (pshape, adamw.init(pshape))
                    + tuple(inp[k] for k in names),
                    (pspec, ospec) + tuple(ispec[k] for k in names), an)
    if shape.kind == "prefill":
        fn = st.make_prefill_step(cfg, ctx)
        names = ("tokens",) + front
        return Cell(fn, (pshape,) + tuple(inp[k] for k in names),
                    (pspec,) + tuple(ispec[k] for k in names), an)
    fn = st.make_serve_step(cfg, ctx)
    cshape = st.cache_shape(cfg, shape)
    return Cell(fn, (pshape, cshape, inp["tokens"]),
                (pspec, shd.cache_specs(cshape, axes), ispec["tokens"]), an)


def argument_bytes(cell: Cell) -> int:
    """Place the cell's inputs on its mesh; their bytes on one device."""
    return sum(place_tree(cell.analysis, a, s)
               for a, s in zip(cell.args, cell.specs))


def analyze_cell(cell: Cell) -> dict:
    """Place the cell's inputs and run its step under the analysis."""
    an = cell.analysis
    arg_bytes = argument_bytes(cell)
    with an:
        cell.step(*cell.args)
    rec = an.result()
    rec["collectives"] = {k[len("coll_"):]: v for k, v in rec.items()
                          if k.startswith("coll_")}
    rec["argument_size_in_bytes"] = arg_bytes
    rec["hints"] = an.records
    rec["unmodelled_ops"] = dict(an.unmodelled)
    return rec


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             quant: bool = False, variant: str = "baseline",
             out_dir: str = OUT_DIR):
    """Analyze one cell on the production mesh (over the process group in
    place, which needs as many ranks as the mesh has devices) and write
    its record."""
    K.set_knobs(**K.VARIANTS[variant])
    cfg = get_config(arch)
    shape = SHAPES_BY_NAME[shape_name]
    mesh_name = "2x16x16" if multi_pod else "16x16"
    name = (f"{arch}_{shape_name}_{mesh_name}" + ("_int4" if quant else "")
            + (f"_{variant}" if variant != "baseline" else ""))
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "quant": quant, "variant": variant, "status": "ok"}
    try:
        mesh = M.make_production_mesh(multi_pod=multi_pod)
        t0 = time.time()
        rec.update(analyze_cell(build_cell(cfg, shape, mesh, quant=quant)))
        rec["analyze_s"] = round(time.time() - t0, 2)
        rec["n_devices"] = math.prod(shd.mesh_axes(mesh).values())
        rec["moe_dispatch"] = "padded" if cfg.moe is not None else None
        print(f"[{name}] OK analyze={rec['analyze_s']:.1f}s "
              f"flops={rec['hlo_dot_flops']:.4g} "
              f"arg_bytes={rec['argument_size_in_bytes']:,}", flush=True)
    except Exception as e:  # noqa: BLE001 — a failing cell is a bug report
        rec["status"] = "fail"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
        print(f"[{name}] FAIL: {rec['error']}", flush=True)
    finally:
        K.reset()
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, name + ".json"), "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def _run_in_world(task):
    """One cell in a fake process group of its mesh's size (a pool
    worker's entry)."""
    arch, shape_name, mp, quant, variant, out_dir = task
    with M.fake_world(512 if mp else 256):
        return run_cell(arch, shape_name, multi_pod=mp, quant=quant,
                        variant=variant, out_dir=out_dir)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all-shapes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--quant", action="store_true")
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--jobs", type=int, default=1)
    ap.add_argument("--out", default=OUT_DIR)
    args = ap.parse_args(argv)

    if args.all:
        cells = [(name, s.name) for name, cfg in ALL_CONFIGS.items()
                 for s in applicable_shapes(cfg)]
    elif args.all_shapes:
        cells = [(args.arch, s.name)
                 for s in applicable_shapes(get_config(args.arch))]
    else:
        cells = [(args.arch, args.shape)]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    tasks = [(arch, shape, mp,
              args.quant and SHAPES_BY_NAME[shape].kind != "train",
              args.variant, args.out)
             for mp in meshes for arch, shape in cells]
    t0 = time.time()
    if args.jobs > 1:
        import multiprocessing as mp_
        with mp_.get_context("spawn").Pool(args.jobs) as pool:
            recs = pool.map(_run_in_world, tasks, chunksize=1)
    else:
        recs = [_run_in_world(t) for t in tasks]
    fails = sum(r["status"] != "ok" for r in recs)
    ok = [r for r in recs if r["status"] == "ok"]
    slow = max(ok, key=lambda r: r["analyze_s"]) if ok else None
    print(f"dry-run done: {len(recs) - fails} ok, {fails} failed, "
          f"{time.time() - t0:.1f}s"
          + (f"; slowest {slow['arch']}_{slow['shape']}_{slow['mesh']} "
             f"analyze_s={slow['analyze_s']}" if slow else ""))
    raise SystemExit(1 if fails else 0)


if __name__ == "__main__":
    main()
