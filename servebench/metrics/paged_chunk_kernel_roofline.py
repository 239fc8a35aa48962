"""K3's (GQA) or K3-mla's (MLA) share of its roofline over the profiled
span, in %: for every chunked-prefill call in the span, one launch an
attention layer over the chunk's causal pairs and the context it walks
(``rooflines.paged_chunk_work`` / ``paged_chunk_mla_work``), over the device
time of the ``paged_chunk_kernel`` launches in the trace."""
from servebench import profiling, rooflines


def read(run):
    m = run["model"]
    dev = profiling.kernel_seconds(run["trace"], "paged_chunk_kernel")
    calls = [c for s in run["span_steps"] for c in s.chunk_calls]
    if not calls or dev <= 0:
        return None
    H, bs, n = m["n_heads"], run["block_size"], len(run["kinds"])
    a = m.get("mla")
    least = 0.0
    for pos0, clen in calls:
        if a:
            w = rooflines.paged_chunk_mla_work(
                pos0, clen, H, a["kv_lora_rank"] + a["qk_rope_head_dim"],
                a["kv_lora_rank"], bs)
        else:
            Dh = m.get("head_dim") or m["d_model"] // H
            w = rooflines.paged_chunk_work(pos0, clen, H, m["n_kv_heads"],
                                           Dh, bs)
        least += n * rooflines.least_s(*w)
    return least / dev * 100.0
