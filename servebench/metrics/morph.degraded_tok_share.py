"""Share of the output tokens delivered in the window that a step produced
at swap level > 0 (some layers on their int4 variant); the level is the
actuator's at the step's start, the one ``Request.token_levels`` records."""


def read(run):
    out = sum(s.out for s in run["steps"])
    return sum(s.degraded for s in run["steps"]) / out if out else None
