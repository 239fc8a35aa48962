"""A run of the harness on the CPU, past its look for a card, on tiny
configurations of both model families it serves: its last line, a mix
found by name, and ``correct`` false under each planted fault."""
import json
import re

import pytest

from servebench.conftest import run_cpu

KEYS = {"correct", "attempted", "failed", "metrics", "device", "compared"}


def _last(lines):
    line = json.loads(lines[-1])
    assert KEYS <= set(line)
    assert list(line)[-1] == "compared"
    return line


@pytest.mark.parametrize("family", ["dense", "mla"])
def test_run_to_its_last_line(tiny_repo, family):
    root = tiny_repo(family)
    rc, out, err = run_cpu(root)
    assert rc == 0, err[-3000:]
    line = _last(out)
    assert line["correct"] is True, err[-3000:]
    assert set(line["metrics"]) == {"out_tok_per_s", "setup_s"}
    assert line["attempted"] > 20 and line["failed"] == 0
    assert line["metrics"]["out_tok_per_s"]["value"] > 0
    gap = line["compared"]["widest_logit_gap"]
    assert 0 <= gap["value"] <= gap["limit"]
    # the numbers compared are the last lines of standard error too
    assert err.strip().splitlines()[-1].startswith("compared widest_logit_gap")
    # the window swapped layers, so the check held int4 rows too
    assert "window swaps (engine s, from, to): [(" in err


def test_traced_run_profiles_after_the_close(tiny_repo):
    """A traced run reads its window untraced, as an untraced run does,
    and profiles a span of the traffic after the close, which it serves
    until the span has held a K1 launch and a chunked prefill."""
    root = tiny_repo("dense")
    rc, out, err = run_cpu(root, trace=True)
    assert rc == 0, err[-3000:]
    line = _last(out)
    assert line["correct"] is True, err[-3000:]
    window = {"slo_attain", "ttft_p95_s", "tpot_p95_ms",
              "engine.step_ms.decode", "engine.step_ms.mixed",
              "morph.degraded_tok_share", "kv.peak_use", "step.mfu"}
    assert window <= set(line["metrics"]), sorted(line["metrics"])
    assert "out_tok_per_s" not in line["metrics"]
    m = re.search(r"profiled span ([0-9.]+)-([0-9.]+) s \(window time; the "
                  r"window closed at ([0-9.]+) s\).*held \[([^]]*)\]", err)
    assert m, err[-3000:]
    t0, t1, close = (float(m.group(i)) for i in (1, 2, 3))
    # the mix opens the span 1 s after the close; the profiler's first
    # start was paid in set-up, so the span opens on time
    assert close + 1.0 <= t0 < close + 1.5 and t0 < t1
    assert m.group(4) == "'chunk', 'k1'" or t1 - t0 >= 4.0


@pytest.mark.parametrize("fault", ["altered_token", "half_batch",
                                   "stale_pool"])
def test_planted_fault_is_not_correct(tiny_repo, fault):
    rc, out, err = run_cpu(tiny_repo("dense"), fault=fault)
    assert rc == 0, err[-3000:]
    line = _last(out)
    assert line["correct"] is False
    gap = line["compared"]["widest_logit_gap"]
    assert gap["value"] > gap["limit"]


def test_new_mix_is_found_by_name(tiny_repo):
    root = tiny_repo("dense")
    mix = json.loads((root / "servebench/mixes/tiny-burst.json").read_text())
    mix.update(name="tiny-steady", spikes=[], base_rate_knee=0.5)
    (root / "servebench/mixes/tiny-steady.json").write_text(json.dumps(mix))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = dict(bench["workloads"][0], name="tiny.steady",
                traffic="tiny-steady")
    bench["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    rc, out, err = run_cpu(root, workload="tiny.steady")
    assert rc == 0, err[-3000:]
    line = _last(out)
    assert line["correct"] is True
    # half the knee, no surges: fewer requests than the burst mix offers
    rc2, out2, _ = run_cpu(root)
    assert line["attempted"] < _last(out2)["attempted"]


def test_unknown_workload_fails(tiny_repo):
    rc, out, err = run_cpu(tiny_repo("dense"), workload="no.such-cell")
    assert rc != 0 and not any(l.startswith("{") for l in out)
