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


def moe_apply(p, cfg, x, *, capacity_factor: float = 1.25,
              plain: bool = False):
    """x: (B, S, D) -> ((B, S, D), aux), aux holding ``expert_load``,
    ``dropped_frac`` and ``router_entropy``. ``capacity_factor <= 0`` means
    no-drop capacity (C = T·K), what the engine and the LIS profile use.
    ``plain=True`` asks every kernel route for its plain version."""
    mc = cfg.moe
    B, S, D = x.shape
    E, K = mc.n_routed_experts, mc.top_k
    T = B * S
    xf = x.reshape(T, D)
    top_idx, gates, gate_scores = route(p, cfg, xf)

    if capacity_factor <= 0:
        C = T * K
    else:
        C = min(max(int(T * K / E * capacity_factor + 0.999), 1), T * K)
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
