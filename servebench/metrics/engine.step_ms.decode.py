"""Mean wall time of the window's decode-only steps, in ms: the harness's
clock around ``MorphServeEngine.step()`` on steps that carried no prompt
token, summed over the window, over their count."""


def read(run):
    ts = [s.t1 - s.t0 for s in run["steps"] if s.kind == "decode"]
    return sum(ts) / len(ts) * 1e3 if ts else None
