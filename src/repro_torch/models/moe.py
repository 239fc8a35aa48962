"""Mixture-of-Experts FFN: DeepSeek-V3's sigmoid router with a selection
bias and shared expert, and Llama-4's top-1 softmax router, in torch.

The function is the JAX package's ``moe_apply``: the same routing, gates,
capacity (each (token, k) pair ranked in its expert's queue in flat order
``t·K + k``, pairs ranked at or past C dropped) and aux statistics. The
dispatch is not its TPU one. There, every expert multiplies a dense
(C, D) buffer, which at no-drop capacity (C = T·K) is E times the rows
that route to it. Here the kept pairs are sorted by expert and each expert
that has rows multiplies those rows only; the results are combined with
``index_add_`` in ``x.dtype``. The padding rows of the reference contribute
exactly zero, so this is the same function.

An expert stack is a dense (E, K, N) tensor or a stacked int4/int8
``QTensor``. Each expert's product goes through ``qlinear.matmul`` on its
2-D slice (``QTensor.expert``): one wNa16 GEMM (K1) launch for each expert
that has rows when the stack is kernel-flagged, a dequantization of that
expert alone otherwise. K1 takes M as a host integer, so the per-expert
row counts reach the host once per call: ``moe_apply.host_syncs`` counts
those copies.

A ``meta`` input has no row counts to read. There ``moe_apply`` takes the
JAX package's own dispatch (:func:`padded_dispatch`): every expert
multiplies a dense (C, D) buffer at the capacity C of the call, as the
JAX dry run sees it, with the ``ShardCtx`` hints on the buffers at the
JAX sites. Its values are the same function's.
"""
from __future__ import annotations

import torch

from repro_torch.models import layers as L
from repro_torch.quant import qlinear


def moe_init(gen: torch.Generator, cfg, dtype):
    """The JAX package's keys and shapes: ``router`` (D, E) float32,
    ``w_gate``/``w_up`` (E, D, F), ``w_down`` (E, F, D), ``router_bias``
    (E,) zeros with the selection bias, ``shared`` an MLP of d_ff
    F · n_shared_experts. Each expert is drawn on its own, so that no
    float32 copy of a whole stack is ever held."""
    mc = cfg.moe
    D, E, F = cfg.d_model, mc.n_routed_experts, mc.d_ff_expert

    def stack(shape):
        w = torch.empty((E, *shape), dtype=dtype, device=gen.device)
        if w.is_meta:                    # shapes only: nothing to draw
            return w
        for e in range(E):
            w[e] = L.dense_init(gen, shape, dtype=dtype)
        return w

    p = {"router": L.dense_init(gen, (D, E), scale=0.02, dtype=torch.float32),
         "w_gate": stack((D, F)),
         "w_up": stack((D, F)),
         "w_down": stack((F, D))}
    if mc.router_aux_free_bias:
        p["router_bias"] = torch.zeros((E,), dtype=torch.float32,
                                       device=gen.device)
    if mc.n_shared_experts:
        p["shared"] = L.mlp_init(gen, cfg, d_ff=F * mc.n_shared_experts,
                                 dtype=dtype)
    return p


def _expert_matmul(xs, w, rows, plain: bool = False):
    """Rows of ``xs`` grouped by expert (``rows[e]`` of them for expert e,
    in expert order) times each expert's (K, N) weight of the stack ``w``,
    a dense (E, K, N) tensor or a stacked QTensor; experts without rows are
    skipped."""
    quantized = qlinear.is_quantized(w)
    out = xs.new_empty((xs.shape[0], w.N if quantized else w.shape[-1]))
    o = 0
    for e, n in enumerate(rows):
        if n:
            we = w.expert(e) if quantized else w[e]
            out[o:o + n] = qlinear.matmul(xs[o:o + n], we, plain=plain)
            o += n
    return out


def route(p, cfg, xf):
    """The router: xf (T, D) -> each token's top-K experts (T, K), their
    combine gates (T, K) and the gate scores (T, E), in float32.
    DeepSeek-V3 selects by ``sigmoid(logits) + router_bias`` (the bias
    steers the choice, never the combine) and gates by the sigmoid of the
    chosen, normalized and scaled; the softmax router selects by the logits
    and gates by the softmax, normalized only when K > 1."""
    mc = cfg.moe
    K = mc.top_k
    logits = torch.matmul(xf.to(torch.float32), p["router"])       # (T, E)
    if mc.router_aux_free_bias:
        gate_scores = torch.sigmoid(logits)
        sel_scores = gate_scores + p["router_bias"]
    else:
        gate_scores = torch.softmax(logits, dim=-1)
        sel_scores = logits
    top_idx = torch.topk(sel_scores, K, dim=-1).indices
    gates = torch.gather(gate_scores, 1, top_idx)
    if mc.router_aux_free_bias:
        gates = gates / (gates.sum(dim=-1, keepdim=True) + 1e-9)
        gates = gates * mc.routed_scaling_factor
    elif K > 1:
        gates = gates / (gates.sum(dim=-1, keepdim=True) + 1e-9)
    return top_idx, gates, gate_scores


def _capacity(T: int, K: int, E: int, capacity_factor: float) -> int:
    if capacity_factor <= 0:
        return T * K
    return min(max(int(T * K / E * capacity_factor + 0.999), 1), T * K)


def moe_apply(p, cfg, x, *, capacity_factor: float = 1.25,
              plain: bool = False, ctx: L.ShardCtx = L.NO_SHARD):
    """x: (B, S, D) -> ((B, S, D), aux), aux holding ``expert_load``,
    ``dropped_frac`` and ``router_entropy``. ``capacity_factor <= 0`` means
    no-drop capacity (C = T·K), what the engine and the LIS profile use.
    ``plain=True`` asks every kernel route for its plain version. A
    ``meta`` input takes :func:`padded_dispatch`, where ``ctx``'s hints
    sit."""
    if x.is_meta:
        return padded_dispatch(p, cfg, x, capacity_factor=capacity_factor,
                               ctx=ctx)
    mc = cfg.moe
    B, S, D = x.shape
    E, K = mc.n_routed_experts, mc.top_k
    T = B * S
    xf = x.reshape(T, D)
    top_idx, gates, gate_scores = route(p, cfg, xf)
    C = _capacity(T, K, E, capacity_factor)
    # rank each (token, k) pair in its expert's queue by a stable sort
    flat_e = top_idx.reshape(-1)                                     # (T*K,)
    order = torch.argsort(flat_e, stable=True)
    counts = torch.bincount(flat_e, minlength=E)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(T * K, device=x.device) - starts[flat_e[order]]
    keep = rank < C                       # in expert-sorted order
    pairs = order[keep]                   # kept pairs, grouped by expert
    rows = torch.clamp(counts, max=C).tolist()
    moe_apply.host_syncs += 1

    act = L._ACTS[cfg.act]
    xs = xf[pairs // K]
    h = act(_expert_matmul(xs, p["w_gate"], rows, plain)) \
        * _expert_matmul(xs, p["w_up"], rows, plain)
    ys = _expert_matmul(h, p["w_down"], rows, plain)
    g = gates.reshape(-1)[pairs].to(x.dtype)
    y = torch.zeros((T, D), dtype=x.dtype, device=x.device)
    y.index_add_(0, pairs // K, ys * g[:, None])

    if mc.n_shared_experts:
        y = y + L.mlp_apply(p["shared"], cfg, xf, plain=plain)

    aux = {"expert_load": counts.to(torch.float32) / (T * K),
           "dropped_frac": 1.0 - keep.to(torch.float32).mean(),
           "router_entropy": -(gate_scores * torch.log(gate_scores + 1e-9))
           .sum(dim=-1).mean()}
    return y.reshape(B, S, D), aux


moe_apply.host_syncs = 0


def _dense_expert_matmul(xg, w):
    """(E, C, K) x every expert's (K, N) of the stack ``w`` (dense, or a
    QTensor dequantized to ``xg.dtype``, as the JAX package multiplies a
    QTensor without the kernel flag) -> (E, C, N)."""
    if qlinear.is_quantized(w):
        w = w.dequantize(xg.dtype)
    return torch.einsum("ecd,edf->ecf", xg, w.to(xg.dtype))


def padded_dispatch(p, cfg, x, *, capacity_factor: float = 1.25,
                    ctx: L.ShardCtx = L.NO_SHARD):
    """:func:`moe_apply` by the JAX package's dispatch: each (token, k)
    pair ranked in its expert's queue by a stable sort, the kept pairs
    scattered into a zero (E, C, D) buffer, every expert multiplying its
    whole buffer, the rows gathered back and combined with their gates.
    Nothing reads a value on the host, so it runs on ``meta``. The
    buffers carry the JAX hints: experts over model, capacity over data
    (``knobs.KNOBS.moe_ep_align``: experts over data x model)."""
    from repro_torch.launch import knobs
    mc = cfg.moe
    B, S, D = x.shape
    E, K = mc.n_routed_experts, mc.top_k
    T = B * S
    dev = x.device
    xf = x.reshape(T, D)
    top_idx, gates, gate_scores = route(p, cfg, xf)
    C = _capacity(T, K, E, capacity_factor)
    flat_e = top_idx.reshape(-1)                                     # (T*K,)
    flat_tok = torch.arange(T, device=dev).repeat_interleave(K)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    starts = torch.searchsorted(sorted_e, torch.arange(E, device=dev))
    rank_sorted = torch.arange(T * K, device=dev) - starts[sorted_e]
    pos = torch.zeros_like(rank_sorted).scatter(0, order, rank_sorted)
    keep = pos < C
    dest = flat_e * C + torch.where(keep, pos, 0)

    rows = torch.where(keep[:, None], xf[flat_tok], 0)
    xg = torch.zeros((E * C, D), dtype=x.dtype, device=dev) \
        .index_add(0, dest, rows).reshape(E, C, D)
    if knobs.KNOBS.moe_ep_align and ctx.data_axis and ctx.model_axis:
        espec = ((ctx.data_axis, ctx.model_axis), None, None)
    else:
        espec = (ctx.model_axis, ctx.data_axis, None)
    xg = ctx.constrain(xg, espec, "moe.dispatch")
    act = L._ACTS[cfg.act]
    h = act(_dense_expert_matmul(xg, p["w_gate"])) \
        * _dense_expert_matmul(xg, p["w_up"])
    h = ctx.constrain(h, espec, "moe.hidden")
    yg = _dense_expert_matmul(h, p["w_down"]).reshape(E * C, D)
    yg = ctx.constrain(yg, (espec[0], None), "moe.combine")

    contrib = yg[dest] * (keep * gates.reshape(-1))[:, None].to(x.dtype)
    y = torch.zeros((T, D), dtype=x.dtype, device=dev) \
        .index_add(0, flat_tok, contrib)
    if mc.n_shared_experts:
        y = y + L.mlp_apply(p["shared"], cfg, xf)
    load = torch.zeros((E,), dtype=torch.float32, device=dev) \
        .index_add(0, flat_e, torch.ones((T * K,), device=dev)) / (T * K)
    aux = {"expert_load": load,
           "dropped_frac": 1.0 - keep.to(torch.float32).mean(),
           "router_entropy": -(gate_scores * torch.log(gate_scores + 1e-9))
           .sum(dim=-1).mean()}
    return y.reshape(B, S, D), aux


def load_balance_loss(aux, cfg) -> torch.Tensor:
    """Switch-style aux loss as the JAX package computes it: E times the
    sum of the squared expert loads (the load standing in for the mean
    gate fraction)."""
    load = aux["expert_load"]
    return load.shape[0] * torch.sum(load * load)


def update_aux_free_bias(p, aux, *, lr: float = 1e-3):
    """DeepSeek-V3 aux-loss-free balancing: nudge the selection bias toward
    underloaded experts (outside the gradient path). Returns a new layer
    dict."""
    load = aux["expert_load"]
    target = 1.0 / load.shape[0]
    return dict(p, router_bias=p["router_bias"]
                + lr * torch.sign(target - load))
