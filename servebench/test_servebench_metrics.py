"""The end-to-end arithmetic on worked cases: the nearest-rank p95, failed
and undecided requests, TPOT over the window's tokens, the per-layer
readers."""
import math
import importlib.util
from pathlib import Path
from types import SimpleNamespace

import pytest

from servebench import bench, traffic

RS = SimpleNamespace(FAILED="failed", SHED="shed", FINISHED="finished",
                     RUNNING="running")


def _track(due, first=None, win=(), state="finished"):
    tr = bench.Track(traffic.Req(due, [1, 2], 4),
                     SimpleNamespace(state=state), due)
    tr.first_t = first
    if win:
        tr.win_n, tr.win_first, tr.win_last = len(win), win[0], win[-1]
    return tr


def test_p95_nearest_rank():
    assert bench.p95(list(range(1, 21))) == 19
    assert bench.p95(list(range(1, 101))) == 95
    assert bench.p95([3.0]) == 3.0


def test_ttft_rules():
    W = 10.0
    tracks = [_track(1.0, 1.5, (1.5, 2.5, 3.5)),       # 0.5 s, met
              _track(2.0, 5.0, (5.0, 6.0)),            # 3.0 s, missed
              _track(3.0, state="failed"),             # failed: inf, missed
              _track(6.0),                             # 4 s waiting: inf
              _track(9.0),                             # 1 s waiting: left out
              _track(-1.0, 0.5, (0.5, 1.0)),           # lead-in: not counted
              _track(9.5, 10.2)]                       # token after close:
    e = bench.end_to_end(tracks, W, 2.0, RS)           # still inside: out
    assert e["_counted"] == 4 and e["_failed"] == 1
    assert e["slo_attain"] == pytest.approx(1 / 4)
    assert math.isinf(e["ttft_p95_s"])
    # TPOT over the window's tokens of every request, lead-in ones too
    assert e["_tpot_n"] == 3
    assert e["tpot_p95_ms"] == pytest.approx(1000.0)
    assert e["out_tok_per_s"] == pytest.approx(7 / W)


def test_ttft_p95_finite():
    tracks = [_track(float(i) / 10, float(i) / 10 + 0.1 * (i + 1))
              for i in range(20)]
    e = bench.end_to_end(tracks, 10.0, 2.0, RS)
    assert e["ttft_p95_s"] == pytest.approx(1.9)
    assert e["slo_attain"] == 1.0


def _reader(name):
    path = Path(bench.ROOT) / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("m_" + name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_readers_on_a_worked_record():
    steps = [bench.StepRec(0.0, 0.1, "decode", 0, out=10, flops=1e12),
             bench.StepRec(0.1, 0.3, "mixed", 2, out=6, degraded=6,
                           flops=3e12),
             bench.StepRec(0.3, 0.4, "decode", 2, out=4, degraded=4,
                           flops=1e12)]
    run = {"steps": steps, "window_s": 1.0, "kv_history": [(0.1, 5, 10),
                                                          (0.2, 9, 12)],
           "peak_bytes": 5e10, "trace": None, "k1_calls": [],
           "span_steps": [], "model": {}, "kinds": [],
           "e2e": {"ttft_p95_s": 1.5, "tpot_p95_ms": float("inf")}}
    assert _reader("engine.step_ms.decode")(run) == pytest.approx(100.0)
    assert _reader("engine.step_ms.mixed")(run) == pytest.approx(200.0)
    assert _reader("morph.degraded_tok_share")(run) == pytest.approx(0.5)
    assert _reader("kv.peak_use")(run) == pytest.approx(0.75)
    assert _reader("step.mfu")(run) == pytest.approx(5e12 / 989e12 * 100)
    assert _reader("device.peak_mem_gb")(run) == pytest.approx(50.0)
    assert _reader("ttft_p95_s")(run) == 1.5
    assert _reader("tpot_p95_ms")(run) == 1e9
    # nothing traced: the device readers find nothing and say so
    for name in ("device.idle_share", "wna16_kernel_roofline",
                 "paged_decode_kernel_roofline",
                 "paged_chunk_kernel_roofline"):
        assert _reader(name)(run) is None


def test_trace_readers():
    trace = {"busy_s": 0.6, "window_s": 1.0,
             "kernel_s": {"wna16_kernel": 0.002, "paged_decode_kernel": 1e-3,
                          "paged_chunk_kernel": 1e-3}}
    model = {"d_model": 4096, "n_heads": 32, "n_kv_heads": 8,
             "head_dim": 128}
    run = {"trace": trace, "k1_calls": [(8, 4096, 11008, 4, 128, 2)],
           "model": model, "kinds": ["dense"] * 2, "block_size": 16,
           "span_steps": [bench.StepRec(0, 1, "mixed", 0,
                                        decode_pos=[100, 200],
                                        chunk_calls=[(32, 64)])]}
    assert _reader("device.idle_share")(run) == pytest.approx(0.4)
    k1 = _reader("wna16_kernel_roofline")(run)
    nbytes = 8 * 4096 * 2 + 4096 * 11008 // 2 + 2 * 32 * 11008 * 4 \
        + 8 * 11008 * 2
    assert k1 == pytest.approx(nbytes / 3.35e12 / 0.002 * 100)
    assert 0 < _reader("paged_decode_kernel_roofline")(run) < 100
    assert 0 < _reader("paged_chunk_kernel_roofline")(run) < 100
