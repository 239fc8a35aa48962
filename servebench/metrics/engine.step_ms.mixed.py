"""Mean wall time of the window's steps that carried prompt tokens (whole
prompts or chunks, beside the decodes), in ms, on the harness's clock."""


def read(run):
    ts = [s.t1 - s.t0 for s in run["steps"] if s.kind == "mixed"]
    return sum(ts) / len(ts) * 1e3 if ts else None
