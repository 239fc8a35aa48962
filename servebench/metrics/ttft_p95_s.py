"""The window's p95 time to first token, as the end-to-end rule computes it
(``bench.end_to_end``). The window of a traced run is untraced too (its
profiled span comes after the close), so this reads what an untraced run
reads. A tail of a bursty window swings with the smallest change, so it is
watched here, beside the bounded metrics, and not bounded (PERF.md §2)."""


def read(run):
    v = run["e2e"]["ttft_p95_s"]
    return v if v != float("inf") else 1e9
