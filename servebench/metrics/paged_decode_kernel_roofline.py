"""K2's share of its roofline over the profiled span, in %: for every
decode step in the span, one launch a GQA layer over the live rows at the
positions they decoded (``rooflines.paged_decode_work``; idle slots and
table padding count nothing), over the device time of the
``paged_decode_kernel`` launches in the trace."""
from servebench import profiling, rooflines


def read(run):
    m = run["model"]
    dev = profiling.kernel_seconds(run["trace"], "paged_decode_kernel")
    if m.get("mla") or dev <= 0:
        return None
    H, KVH = m["n_heads"], m["n_kv_heads"]
    Dh = m.get("head_dim") or m["d_model"] // H
    least = 0.0
    for s in run["span_steps"]:
        if s.decode_pos:
            least += len(run["kinds"]) * rooflines.least_s(
                *rooflines.paged_decode_work(s.decode_pos, H, KVH, Dh,
                                             run["block_size"]))
    return least / dev * 100.0 if least > 0 else None
