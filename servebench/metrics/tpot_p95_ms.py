"""The window's p95 time per output token over the requests with two or
more tokens in it (``bench.end_to_end``); untraced, and unbounded for the
reason ``ttft_p95_s.py`` gives."""


def read(run):
    v = run["e2e"]["tpot_p95_ms"]
    return v if v != float("inf") else 1e9
