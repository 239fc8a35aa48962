"""The frozen generator: the same seed gives the same requests, every seed
the same arrivals and lengths in another order, the surges inside the
window, the lead-in before it."""
import json
from pathlib import Path

import numpy as np
import pytest

from servebench import traffic

MIXES = Path(__file__).resolve().parent / "mixes"
KNEE = {"knee_rps": 6.0, "highest_rps_no_swap": 4.0}


def _mix(name):
    return json.loads((MIXES / f"{name}.json").read_text())


@pytest.mark.parametrize("name", ["chat-burst", "chat-steady",
                                  "chat-overload"])
def test_same_seed_same_requests(name):
    a = traffic.requests(_mix(name), KNEE, 40.0, 2 ** 31 + 11, 256000)
    b = traffic.requests(_mix(name), KNEE, 40.0, 2 ** 31 + 11, 256000)
    assert [(q.due_s, q.prompt, q.out_len) for q in a] == \
        [(q.due_s, q.prompt, q.out_len) for q in b]


def test_seeds_permute_the_same_work():
    mix = _mix("chat-burst")
    a = traffic.requests(mix, KNEE, 40.0, 1, 1000)
    b = traffic.requests(mix, KNEE, 40.0, 2, 1000)
    assert [q.due_s for q in a] == [q.due_s for q in b]
    assert sorted((len(q.prompt), q.out_len) for q in a) == \
        sorted((len(q.prompt), q.out_len) for q in b)
    assert [len(q.prompt) for q in a] != [len(q.prompt) for q in b]
    assert [q.prompt for q in a] != [q.prompt for q in b]


def test_fixed_lengths_change_only_the_tokens():
    """A mix that keeps each arrival's lengths offers every seed the same
    work in the same order; only the token ids differ."""
    mix = _mix("chat-overload")
    assert mix["permute_lengths"] is False
    a = traffic.requests(mix, KNEE, 40.0, 1, 1000)
    b = traffic.requests(mix, KNEE, 40.0, 2, 1000)
    assert [(q.due_s, len(q.prompt), q.out_len) for q in a] == \
        [(q.due_s, len(q.prompt), q.out_len) for q in b]
    assert [q.prompt for q in a] != [q.prompt for q in b]


def test_surges_sit_in_the_window():
    mix = _mix("chat-burst")
    W = 51.0
    due = np.array([q.due_s for q in traffic.requests(mix, KNEE, W, 5, 100)])
    base = mix["base_rate_knee"] * KNEE["knee_rps"]
    centres = [s["at"] * W for s in mix["spikes"]]
    assert len(centres) == 2 and all(s["height_base"] >= 3.0
                                     for s in mix["spikes"])
    assert all(0 < c < W for c in centres)
    near = sum(np.sum(np.abs(due - c) < 1.5) for c in centres)
    # base alone would bring 3 s * base a surge; each surge adds more
    assert near > 1.5 * 3.0 * base * len(centres)
    gaps = [(a + b) / 2 for a, b in zip(centres, centres[1:])]
    calm = sum(np.sum(np.abs(due - g) < 1.5) for g in gaps)
    assert calm < near / 1.5
    assert due.min() < 0 < W < due.max()
    assert due.min() >= -mix["lead_in_s"]


def test_lengths_and_rates():
    mix = _mix("chat-burst")
    sched = traffic.schedule(mix, KNEE, 40.0)
    p = np.array([s[1] for s in sched])
    g = np.array([s[2] for s in sched])
    assert p.min() >= 8 and p.max() <= 2048 and g.min() >= 4 and g.max() <= 512
    assert 350 < np.median(p) < 700 and 180 < np.median(g) < 350
    steady = _mix("chat-steady")
    # capped at the highest rate that stayed at level 0
    assert traffic.base_rate(steady, KNEE) == 4.0
    assert traffic.base_rate(dict(steady, cap_to_no_swap=False), KNEE) == \
        pytest.approx(0.8 * 6.0)


def test_profile_span():
    mix = _mix("chat-burst")
    pr = mix["profile"]
    span = traffic.profile_span(mix, 40.0)
    assert span["t0"] == 40.0 + pr["start_after_close_s"] >= 40.0
    assert span["t0"] < span["t_min"] < span["t_max"]
    assert set(span["until"]) == {"k1", "chunk"}
    # the span's own surge rises after the close and is on at the span's start
    (c, h, _), = [s for s in traffic.spikes(mix, 40.0) if s[0] > 40.0]
    assert 40.0 < span["t0"] <= c
    rate = traffic.rate_fn(mix, KNEE, 40.0)
    base = traffic.base_rate(mix, KNEE)
    assert rate(span["t0"]) > 2 * base and rate(40.0) < 1.05 * base
    steady = traffic.profile_span(_mix("chat-steady"), 40.0)
    assert (steady["t0"], steady["t_max"]) == (40.0, 50.0)


def test_schedule_reaches_the_span():
    """Arrivals run on past the close to the span's latest end, the same
    for every seed, so a traced run serves the span's surge."""
    mix = _mix("chat-burst")
    due = [s[0] for s in traffic.schedule(mix, KNEE, 40.0)]
    span = traffic.profile_span(mix, 40.0)
    assert max(due) > span["t0"] and max(due) < span["t_max"]
