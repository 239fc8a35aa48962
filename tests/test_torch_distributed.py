"""The port's serving cluster (``repro_torch.distributed``) against the JAX
package: the seeded fault plans, the KV migration channel, the control
plane in simulated compute under chaos plans, a real-compute cluster whose
drain migrates live requests, and one export -> channel -> import on a
bfloat16 pool.

Tolerance: the fault draws, the channel's results and received arrays, the
sim-compute cluster's report, counters and streams, and the bf16
destination pools are compared exactly (numpy host logic, or the same
bytes moved). Real compute agrees across frameworks only to ~1e-5, so its
logits are held to 1e-4 (as in ``test_torch_model.py``) and its greedy
streams exactly, on a trace checked free of near-ties (``MIN_GAP``).
"""
import dataclasses
import gc
import inspect

import numpy as np
import pytest
from torch_parity import MIN_GAP, jcfg, llama_params, record_gaps, tcfg

from repro.configs import MORPH_LLAMA2_7B as J_LLAMA
from repro.configs import ServingConfig as JSC
from repro.configs import reduced as j_reduced
from repro.core import tree_bytes
from repro.distributed import cluster as jcl
from repro.distributed import faults as jfa
from repro.distributed import migration as jmi
from repro.engine import EngineConfig as JEC
from repro.engine import MorphServeEngine as JEngine
from repro.engine import NVIDIA_L4 as J_L4
from repro.engine import azure_like as j_azure
from repro.engine import shared_prefix_multiturn as j_multiturn
from repro.engine.cost_model import CostModel as JCost
from repro.engine.cost_model import HardwareProfile as JHW
from repro.engine.kv_cache import kv_block_bytes
from repro.engine.traces import TraceRequest as JTR
from repro_torch import bridge
from repro_torch.configs import MORPH_LLAMA2_7B as T_LLAMA
from repro_torch.configs import ServingConfig as TSC
from repro_torch.configs import reduced as t_reduced
from repro_torch.distributed import cluster as tcl
from repro_torch.distributed import faults as tfa
from repro_torch.distributed import migration as tmi
from repro_torch.engine import EngineConfig as TEC
from repro_torch.engine import MorphServeEngine as TEngine
from repro_torch.engine import NVIDIA_L4 as T_L4
from repro_torch.engine import azure_like as t_azure
from repro_torch.engine import shared_prefix_multiturn as t_multiturn
from repro_torch.engine.cost_model import CostModel as TCost
from repro_torch.engine.cost_model import HardwareProfile as THW
from repro_torch.engine.traces import TraceRequest as TTR

TOL = dict(rtol=1e-4, atol=1e-4)

# each side of a comparison: the JAX package's names, then the port's
J = dict(fa=jfa, mi=jmi, cl=jcl, SC=JSC, EC=JEC, L4=J_L4, HW=JHW, TR=JTR,
         azure=j_azure, multiturn=j_multiturn, Cost=JCost, Engine=JEngine,
         cfg=lambda: j_reduced(J_LLAMA), kw={})
T = dict(fa=tfa, mi=tmi, cl=tcl, SC=TSC, EC=TEC, L4=T_L4, HW=THW, TR=TTR,
         azure=t_azure, multiturn=t_multiturn, Cost=TCost, Engine=TEngine,
         cfg=lambda: t_reduced(T_LLAMA), kw={"device": "cpu"})


# --------------------------------------------------------------------------
# fault plans: the same seeded draws in both packages
# --------------------------------------------------------------------------
def _specs(fa, name):
    S = fa.FaultSpec
    if name == "every_kind":
        return (S("kill", 3.0, replica=1, restart_delay_s=2.0),
                S("slow", 1.0, replica=0, factor=4.0, duration_s=3.0),
                S("heal", 6.0, replica=0),
                S("heartbeat_loss", 5.0, replica=2, duration_s=1.5),
                S("drain", 2.0, replica=0), S("add", 7.0),
                S("alloc_fail", 0.5, duration_s=4.0, p=0.3),
                S("swap_delay", 1.0, replica=1, duration_s=2.0, delay_s=0.4),
                S("swap_fail", 0.0, replica=2, duration_s=5.0, p=0.5),
                S("step_spike", 2.0, duration_s=1.0, factor=3.0),
                S("migration_stall", 1.0, duration_s=4.0, p=0.4,
                  delay_s=2.0),
                S("migration_corrupt", 0.0, duration_s=6.0, p=0.3),
                S("migration_dest_kill", 2.0, duration_s=3.0, p=0.2))
    if name == "flap_add":
        return (S("flap", 1.0, replica=0, count=3, period_s=2.0),
                S("flap", 2.5, replica=1, count=2, period_s=1.0,
                  restart_delay_s=0.25),
                S("add", 0.5), S("add", 4.0),
                S("slow", 3.0, replica=2, factor=10.0),
                S("alloc_fail", 0.0, replica=1, p=0.7))
    return (S("swap_fail", 0.0, p=0.25), S("step_spike", 0.0, factor=1.5),
            S("migration_corrupt", 0.0, p=0.5),
            S("migration_stall", 0.0, p=0.5, delay_s=0.7),
            S("migration_dest_kill", 0.0, p=0.5))


def _draws(plan):
    """Every injector query over a grid of times, in a fixed order."""
    out = []
    mig = plan.migration_faults()
    for now in np.linspace(0.0, 9.0, 37):
        for i in range(4):
            inj = plan.for_replica(i)
            out.append((inj.alloc_should_fail(now), inj.swap_delay_s(now),
                        inj.swap_should_fail(now),
                        inj.step_time_factor(now)))
        out.append((mig.stall_seconds(now), mig.corrupt_should_fire(now),
                    mig.dest_kill_should_fire(now)))
    return out, plan.injector_stats(), plan.migration_stats()


@pytest.mark.parametrize("name", ["every_kind", "flap_add", "unbounded"])
def test_fault_plans_match_jax(name):
    """``cluster_events()``, every engine and migration injector draw and
    the injectors' counters are equal, exactly."""
    jp = jfa.FaultPlan(_specs(jfa, name), seed=7)
    tp = tfa.FaultPlan(_specs(tfa, name), seed=7)
    je = [dataclasses.asdict(e) for e in jp.cluster_events()]
    assert je == [dataclasses.asdict(e) for e in tp.cluster_events()]
    jd, td = _draws(jp), _draws(tp)
    assert jd == td
    assert any(d[0] or d[2] for d in jd[0] if len(d) == 4), "no draw fired"
    with pytest.raises(ValueError):
        tfa.FaultSpec("meltdown", 0.0)


# --------------------------------------------------------------------------
# the migration channel
# --------------------------------------------------------------------------
def _payload(n, dtype=np.float32):
    rng = np.random.default_rng(n)
    shape = (2, n, 16, 2, 8)            # (L, blocks, bs, KVH, Dh)
    return (rng.standard_normal(shape).astype(dtype),
            rng.standard_normal(shape).astype(dtype))


def _quant(n, bits):
    rng = np.random.default_rng(100 + bits)
    lo, hi = (-8, 8) if bits == 4 else (-127, 128)
    q = [rng.integers(lo, hi, (2, n, 16, 2, 8)).astype(np.int8)
         for _ in range(2)]
    p = [rng.standard_normal((2, n)).astype(np.float32) for _ in range(4)]
    return tuple(q + p)


CHANNEL_CASES = {
    "clean": dict(cfg={"chunk_blocks": 4}, n=10),
    "compress_int8": dict(cfg={"compress_int8": True}, n=9),
    "corrupt": dict(cfg={}, n=6, specs=[("migration_corrupt", dict(
        duration_s=100.0, p=1.0))]),
    "stall": dict(cfg={"stall_timeout_s": 1.0}, n=6, specs=[(
        "migration_stall", dict(duration_s=100.0, p=1.0, delay_s=10.0))]),
    "stall_within_timeout": dict(cfg={}, n=5, specs=[(
        "migration_stall", dict(duration_s=100.0, p=1.0, delay_s=0.5))]),
    "quant_int8": dict(cfg={"chunk_blocks": 3}, n=7, quant=(8, 3)),
    "quant_int4": dict(cfg={}, n=7, quant=(4, 4)),
    "sim": dict(cfg={"compress_int8": True}, n=12, sim=True),
}


def _transfer(side, case):
    cost = side["Cost"](side["cfg"](), side["L4"])
    ch = side["mi"].MigrationChannel(side["mi"].MigrationConfig(
        **case["cfg"]), cost, dtype_bytes=2)
    faults = None
    if "specs" in case:
        faults = side["fa"].MigrationFaults(
            [side["fa"].FaultSpec(k, 0.0, **kw) for k, kw in case["specs"]],
            seed=0)
    k = v = quant = None
    bits, nq = case.get("quant", (8, 0))
    if not case.get("sim"):
        k, v = _payload(case["n"])
    if nq:
        quant = _quant(nq, bits)
    res, k2, v2 = ch.transfer(case["n"], k, v, quant=quant, quant_bits=bits,
                              quant_blocks=nq, faults=faults, now=1.0)
    fields = {f.name: getattr(res, f.name)
              for f in dataclasses.fields(res) if f.name != "quant"}
    return fields, res.quant, k2, v2, ch.stats()


@pytest.mark.parametrize("name", list(CHANNEL_CASES))
def test_channel_matches_jax(name):
    """``MigrationChannel.transfer`` on seeded payloads: the result's
    fields, the channel's counters and every received array (the quant
    payload's included) are equal, exactly."""
    case = CHANNEL_CASES[name]
    jf, jq, jk, jv, js = _transfer(J, case)
    tf, tq, tk, tv, ts = _transfer(T, case)
    assert jf == tf and js == ts
    for a, b in [(jk, tk), (jv, tv)] + list(zip(jq or (), tq or ())):
        assert (a is None) == (b is None)
        if a is not None:
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert (jq is None) == (tq is None)
    ok = name not in ("corrupt", "stall")
    assert tf["ok"] == ok and (tk is not None) == (ok and name != "sim")


# --------------------------------------------------------------------------
# the control plane in simulated compute
# --------------------------------------------------------------------------
def _cluster(side, n=3, mig=True, prefix=False, **kw):
    # test_migration.py's reduced setup (RCFG, 256 MiB a replica)
    sc = side["SC"](hbm_budget_bytes=256 * 2**20, kv_block_size=16,
                    max_batch_slots=8, max_seq_len=1024,
                    swap_levels=(0, 1, 2, 4), mode="performance")
    ec = side["EC"](policy="morph", compute="sim", hw=side["L4"],
                    dtype="float32", seed=0, prefix_caching=prefix)
    return side["cl"].ServingCluster(
        side["cfg"](), None, sc, ec, n_replicas=n,
        migration=side["mi"].MigrationConfig() if mig else None,
        **kw, **side["kw"])


def _slow_all(S, n=3, factor=60.0):
    return tuple(S("slow", 0.0, replica=i, factor=factor) for i in range(n))


def _plan(fa, name):
    """test_migration.py's storm plans, a kill / restart plan with engine
    seams and migration stalls, and a prefix-migration storm."""
    S = fa.FaultSpec
    extra = {
        "storm": (S("drain", 2.0, replica=0),
                  S("heartbeat_loss", 5.0, replica=1, duration_s=2.0)),
        "corrupt": (S("drain", 2.0, replica=0),
                    S("migration_corrupt", 0.0, duration_s=1e9, p=1.0)),
        "dest_kill": (S("drain", 2.0, replica=0),
                      S("migration_dest_kill", 0.0, duration_s=1e9, p=1.0)),
        "kill_restart": (S("kill", 2.25, replica=1, restart_delay_s=2.0),
                         S("add", 5.0),
                         S("drain", 7.25, replica=0),
                         S("heartbeat_loss", 9.0, replica=2, duration_s=1.0),
                         S("migration_stall", 0.0, duration_s=1e9, p=0.3,
                           delay_s=2.0),
                         S("alloc_fail", 6.5, duration_s=3.0, p=0.05),
                         S("swap_delay", 0.0, duration_s=10.0, delay_s=0.3),
                         S("step_spike", 8.0, replica=2, duration_s=1.0,
                           factor=2.0)),
        "prefix": (S("drain", 3.5, replica=1),
                   S("heartbeat_loss", 3.75, replica=2, duration_s=2.0)),
    }[name]
    return fa.FaultPlan(seed=9, specs=_slow_all(S) + extra)


SIM_CASES = {
    "storm": dict(trace=(16, 10.0), kw=dict(heartbeat_timeout_s=0.5,
                                            restart_delay_s=3.0)),
    "corrupt": dict(trace=(12, 8.0), kw=dict(heartbeat_timeout_s=0.5)),
    "dest_kill": dict(trace=(12, 8.0), kw=dict(heartbeat_timeout_s=0.5,
                                               restart_delay_s=2.0)),
    "kill_restart": dict(trace=(16, 10.0), kw=dict(heartbeat_timeout_s=0.5,
                                                   restart_delay_s=3.0)),
    "prefix": dict(trace=None, prefix=True,
                   kw=dict(heartbeat_timeout_s=0.5, restart_delay_s=3.0)),
}


def _trace(side, case):
    if case["trace"] is None:
        return side["multiturn"](duration_s=8.0, n_conversations=4,
                                 turns_per_conv=3, system_len=64,
                                 conv_header_len=32, turn_len=32,
                                 tail_max=48, gen_mean=24, gen_max=48,
                                 vocab=512, seed=4)
    n, dur = case["trace"]
    return side["azure"](duration_s=dur, base_rps=n / dur / 2, seed=5,
                         prompt_mean=128, gen_mean=48, prompt_max=384,
                         gen_max=96)


def _outcome(cl, rep):
    """Everything a sim run reports: the report, counters, fault-injector
    stats, each logical request's finished streams and terminal records."""
    streams, terminal = {}, {}
    for q in cl.collect_requests():
        if q.cluster_id is None:
            continue
        if q.state.name == "FINISHED":
            streams.setdefault(q.cluster_id, []).append(
                tuple(q.logical_stream()))
        if q.state.name in ("FINISHED", "FAILED"):
            terminal[q.cluster_id] = terminal.get(q.cluster_id, 0) + 1
    plan = cl.fault_plan
    return dict(report=dataclasses.asdict(rep), row=rep.row(),
                migration=cl.migration_stats(), redispatched=cl.redispatched,
                detected=cl.detected_failures, drains=cl.drains,
                streams=streams, terminal=terminal,
                injectors=plan.injector_stats(),
                migration_faults=plan.migration_stats(),
                replicas=[(r.alive, r.drained, r.engine is not None)
                          for r in cl.replicas])


def _sim_run(side, name):
    case = SIM_CASES[name]
    cl = _cluster(side, 3, prefix=case.get("prefix", False), **case["kw"])
    rep = cl.run(list(_trace(side, case)), _plan(side["fa"], name),
                 horizon_s=150.0)
    out = _outcome(cl, rep)
    devices = {str(r.engine.device) for r in cl.replicas
               if r.engine and side is T}
    del cl
    gc.collect()
    return out, devices


@pytest.mark.parametrize("name", list(SIM_CASES))
def test_sim_cluster_matches_jax(name):
    """The chaos plans through a 3-replica cluster in simulated compute:
    ``ServingReport`` (its row too), ``migration_stats()``, the re-dispatch,
    detection and drain counters, the injectors' counters, and every
    logical request's finished streams and terminal count are equal,
    exactly; every request ends with exactly one terminal record."""
    want, _ = _sim_run(J, name)
    got, devices = _sim_run(T, name)     # restarts and scale-outs included
    assert got == want
    assert devices == {"cpu"}
    assert got["report"]["n_hung"] == 0
    assert got["terminal"] and max(got["terminal"].values()) == 1
    mig = got["migration"]
    if name == "storm":
        assert mig["ok"] > 0 and got["detected"] > 0 and got["drains"] > 0
    elif name == "corrupt":
        assert mig["attempted"] > 0 and mig["ok"] == 0
        assert mig["aborts"]["corrupt"] == mig["attempted"]
    elif name == "dest_kill":
        assert mig["aborts"]["dest_dead"] > 0
    elif name == "kill_restart":
        assert got["redispatched"] > 0 and mig["aborts"]["stall"] > 0
        assert len(got["replicas"]) == 4 and mig["ok"] > 0
    else:
        assert mig["prefix_migrations"] > 0 and mig["ok"] > 0


def test_cluster_defaults_to_the_card():
    """The cluster's engines run on the card unless the caller asks for
    the CPU; the JAX cluster's other arguments are the port's."""
    sig = inspect.signature(tcl.ServingCluster)
    assert sig.parameters["device"].default == "cuda"
    jsig = inspect.signature(jcl.ServingCluster)
    assert [p for p in sig.parameters if p != "device"] == \
        list(jsig.parameters)


# --------------------------------------------------------------------------
# real compute: a drain that migrates live requests
# --------------------------------------------------------------------------
# 36-40 token prompts decoding 7-10 tokens: a "slow" virtual profile keeps
# them live past the drain at 0.5 s; the budget (weights + 24 float32
# blocks) takes the migrated KV without preempting anything. Cluster seed
# 22 draws prompts whose every argmax wins by > 0.02.
REAL_SPEC = [(0.0, 36, 10), (0.01, 40, 10), (0.02, 28, 10), (0.03, 40, 10),
             (0.3, 33, 8), (0.35, 24, 7)]
REAL_SEED = 22


def _real_serving(params, cls):
    wb = tree_bytes(params)
    bb = kv_block_bytes(jcfg(), 16, 4)
    return cls(hbm_budget_bytes=int((wb + 24 * bb) / 0.95) + 2 * bb,
               kv_block_size=16, max_batch_slots=4, max_seq_len=256,
               swap_levels=(0, 1, 2, 4), mode="performance",
               kv_resize_step_frac=0.25)


def _record_decode_logits(eng, out, jax_side):
    """Collect every decode step's logits row by (cluster id, token index)
    into ``out``."""
    last = {}
    decode = eng.exec.decode

    def run_decode(*a, **k):
        res = decode(*a, **k)
        last["logits"] = res[0] if jax_side else res
        return res
    eng.exec.decode = run_decode
    inner = eng._decode_real

    def decode_real(run):
        keys = [(r.cluster_id, len(r.generated), r.slot) for r in run]
        inner(run)
        rows = np.asarray(last["logits"]) if jax_side else \
            last["logits"].float().numpy()
        for cid, n, slot in keys:
            out[cid, n] = rows[slot]
    eng._decode_real = decode_real


def _real_run(side, faults_on):
    params, _, tparams = llama_params()
    jax_side = side is J
    ec = side["EC"](policy="static_fp16", compute="real",
                    max_tokens_per_step=32, seed=REAL_SEED,
                    hw=side["HW"]("slow", 1e9, 1e7, 2**30))
    cl = side["cl"].ServingCluster(
        jcfg() if jax_side else tcfg(), params if jax_side else tparams,
        _real_serving(params, side["SC"]), ec, n_replicas=2,
        migration=side["mi"].MigrationConfig(), seed=REAL_SEED,
        **side["kw"])
    logits, gaps = {}, []
    for r in cl.replicas:
        if not jax_side:
            gaps.append(record_gaps(r.engine))
        _record_decode_logits(r.engine, logits, jax_side)
    specs = (side["fa"].FaultSpec("drain", 0.5, replica=0),) \
        if faults_on else ()
    rep = cl.run([side["TR"](*s) for s in REAL_SPEC],
                 side["fa"].FaultPlan(specs, seed=1), horizon_s=60.0)
    streams = {q.cluster_id: q.logical_stream()
               for q in cl.collect_requests() if q.state.name == "FINISHED"}
    return dict(row=rep.row(), finished=rep.n_finished,
                preempt=rep.preemptions, migration=cl.migration_stats(),
                streams=streams), logits, [g for gs in gaps for g in gs]


def test_real_cluster_drain_migrates_matches_jax():
    """Reduced Llama with real compute on 2 replicas: a drain at 0.5 s
    migrates the running requests' KV to the peer, where they resume. The
    streams equal the JAX cluster's and the port's own run without faults;
    every decode's logits equal the JAX cluster's, and the no-fault run's
    at the same request and token, within 1e-4."""
    want, jlog, _ = _real_run(J, True)
    got, tlog, gaps = _real_run(T, True)
    base, blog, bgaps = _real_run(T, False)
    assert min(gaps + bgaps) > MIN_GAP, \
        f"near-tie in the trace: {min(gaps + bgaps)}"
    assert got == want
    assert got["finished"] == len(REAL_SPEC) and got["preempt"] == 0
    assert got["migration"]["ok"] >= 1 and got["migration"]["blocks"] > 0
    assert base["migration"]["attempted"] == 0
    assert got["streams"] == base["streams"]
    assert sorted(tlog) == sorted(jlog) == sorted(blog)
    for key in tlog:
        np.testing.assert_allclose(tlog[key], jlog[key], **TOL)
        np.testing.assert_allclose(tlog[key], blog[key], **TOL)


# --------------------------------------------------------------------------
# a bfloat16 pool: the exported dtype differs, the moved values do not
# --------------------------------------------------------------------------
def _bf16_engine(side, params):
    sc = _real_serving(llama_params()[0], side["SC"])
    return side["Engine"](jcfg() if side is J else tcfg(), params, sc,
                          side["EC"](policy="static_fp16", compute="real",
                                     dtype="bfloat16",
                                     max_tokens_per_step=32),
                          **side["kw"])


@pytest.mark.parametrize("compress", [False, True])
def test_bf16_pool_migration_matches_jax(compress):
    """A request's blocks on a bf16 pool cross the channel (compression
    off, then on) into a peer's bf16 pool. The port's source pool is given
    the JAX source's contents first, so the destinations' blocks must be
    equal, exactly. The port exports float32 (the JAX pool its own bf16),
    holding the same values."""
    params, _, tparams = llama_params()
    prompt = tuple(int(t) for t in
                   np.random.default_rng(3).integers(1, 512, 40))
    out = []
    for side, p in ((J, params), (T, tparams)):
        src = _bf16_engine(side, p)
        r = src.submit(side["TR"](0.0, len(prompt), 12, prompt))
        while len(r.generated) < 5:
            src.step()
        if side is T:
            bridge.copy_pool_state(out[0]["src"], src.pool)
        st = src.export_request_state(r)
        exported = st.k
        ch = side["mi"].MigrationChannel(
            side["mi"].MigrationConfig(compress_int8=compress), src.cost,
            dtype_bytes=src.cost.dtype_bytes)
        res, st.k, st.v = ch.transfer(st.n_blocks, st.k, st.v)
        dst = _bf16_engine(side, p)
        r2 = dst.import_request_state(st)
        assert res.ok and r2 is not None
        host = bridge.to_numpy if side is T else \
            (lambda a: np.asarray(a).astype(np.float32))
        ids = r2.block_ids
        out.append(dict(src=src.pool, exported=exported,
                        res=dataclasses.asdict(res),
                        k=host(dst.pool.k[:, ids]),
                        v=host(dst.pool.v[:, ids])))
    jo, to = out
    assert jo["res"] == to["res"]
    assert jo["exported"].dtype.name == "bfloat16"
    assert to["exported"].dtype == np.float32
    np.testing.assert_array_equal(jo["exported"].astype(np.float32),
                                  to["exported"])
    np.testing.assert_array_equal(jo["k"], to["k"])
    np.testing.assert_array_equal(jo["v"], to["v"])
