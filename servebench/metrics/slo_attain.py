"""The window's share of requests whose first token came within the limit
(2 s, ``ServingConfig.ttft_slo_s``), as the end-to-end rule decides it
(``bench.end_to_end``): failed, shed and late requests are misses, and one
still inside the limit at close is left out. Untraced, and unbounded: it
swings with how high each surge drives the ladder (PERF.md §2)."""


def read(run):
    return run["e2e"]["slo_attain"]
