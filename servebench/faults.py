"""Faults planted under the timed path, for the benchmark's own tests: each
breaks what the engine serves in one way a later change could, and the
check has to come out not correct. ``BY_NAME[name](engine)`` plants one
before the window."""
from __future__ import annotations


def altered_token(engine) -> None:
    """A token altered where it is produced: every decode step serves one
    running request the next id after the one the model chose."""
    orig = engine._decode_real

    def decode(run):
        orig(run)
        for r in run:
            if len(r.generated) > 3:
                r.generated[-1] = (r.generated[-1] + 1) % engine.cfg.vocab
                break
    engine._decode_real = decode


def half_batch(engine) -> None:
    """Half of the batch left out: the decode step computes the upper half
    of its live rows (by slot) from token 0 instead of their own last
    tokens."""
    orig = engine._decode_real

    def decode(run):
        half = sorted(run, key=lambda r: r.slot)[len(run) // 2:]
        saved = [(r, r.generated[-1]) for r in half]
        for r, _ in saved:
            r.generated[-1] = 0
        orig(run)
        for r, tok in saved:
            r.generated[-2] = tok
    engine._decode_real = decode


def stale_pool(engine) -> None:
    """A step that leaves its state unchanged: decode appends no key or
    value to the paged pool, so later steps attend to stale rows."""
    from repro_torch.engine import model_exec
    model_exec._append_kv = lambda *a, **kw: None


BY_NAME = {"altered_token": altered_token, "half_batch": half_batch,
           "stale_pool": stale_pool}
