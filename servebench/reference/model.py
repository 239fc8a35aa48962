"""The plain reference: the served model's forward pass in float32.

Plain torch, one sequence at a time, no cache, no kernels, no batching. It
imports nothing of the program and is handed only the benchmark's own
weights and tokens. It follows the port's layer equations (GQA with partial
rotary embeddings, layer norm and a squared-ReLU MLP for Nemotron-4; MLA,
RMS norm, SwiGLU MLPs and a sigmoid-routed MoE with a shared expert for
DeepSeek-V3), and it works out again what the program derives from the
weights: the int4 variant of each swapped layer (``quant.int4_dequant``).

Swap levels: row i of a sequence was processed by the engine at swap level
``row_level[i]``, where the first ``level`` layers of the swap order run
int4. Every matmul of row i in layer l uses the int4 weight when
``rank[l] < row_level[i]``. Keys and values are those row j wrote at its
own level, as the paged pool keeps them; an MLA layer expands its latent
through ``w_ukv`` at the level of the querying row, as the engine's
absorbed decode and chunk steps do.

``stats``, when given, receives ``route_margin``: per row, the smallest
margin over the MoE layers between the last expert the router selects and
the first it does not (in selection-score units; inf without MoE). A row
whose margin is within rounding of zero may route either way in a sound
bf16 program, which changes its output by a whole expert's share.

``mode="fp8"`` is the control: every matmul's operands are rounded to
float8 e4m3 (per-row activation scales, per-column weight scales), the
precision step below the configuration's bf16.
"""
from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Sequence

import torch

from servebench.reference.quant import int4_dequant, quantized

F32 = torch.float32
E4M3_MAX = 448.0


def kinds(model: Dict) -> List[str]:
    """The layer kinds of a configuration's ``model`` section."""
    mo = model.get("moe")
    mla = bool(model.get("mla"))
    out = []
    for i in range(model["n_layers"]):
        moe_here = bool(mo) and i >= mo["first_k_dense"] and \
            (i - mo["first_k_dense"]) % mo["moe_layer_step"] \
            == mo["moe_layer_step"] - 1
        if moe_here:
            out.append("mla_moe" if mla else "moe")
        else:
            out.append("mla_dense" if mla else "dense")
    return out


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale per slice along ``dim``."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12)
    s = amax / E4M3_MAX
    return (x / s).to(torch.float8_e4m3fn).to(F32) * s


class _Lin:
    """Matmuls of one layer for rows split by precision."""

    def __init__(self, qrows: Optional[torch.Tensor], mode: str):
        self.qrows = qrows            # bool (S,): rows on the int4 variant
        self.mode = mode

    def weight(self, w: torch.Tensor, q: bool) -> torch.Tensor:
        wf = int4_dequant(w) if q and quantized(w) else w.to(F32)
        return _fp8(wf, 0) if self.mode == "fp8" else wf

    def __call__(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        m = self.qrows
        if self.mode == "fp8":
            x = _fp8(x, -1)
        if m is None or not bool(m.any()) or not quantized(w):
            return x @ self.weight(w, False)
        if bool(m.all()):
            return x @ self.weight(w, True)
        out = x.new_empty((x.shape[0], w.shape[-1]))
        out[~m] = x[~m] @ self.weight(w, False)
        out[m] = x[m] @ self.weight(w, True)
        return out


def _norm(kind: str, p: Dict, x: torch.Tensor, eps: float = 1e-5):
    if kind == "rmsnorm":
        y = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
        return y * p["scale"].to(F32)
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return y * p["scale"].to(F32) + p["bias"].to(F32)


def _rope(x: torch.Tensor, theta: float, fraction: float) -> torch.Tensor:
    """x (S, heads, D): rotate-half embeddings on the first
    ``int(D * fraction) // 2 * 2`` lanes, at positions 0..S-1."""
    S, _, D = x.shape
    rot = int(D * fraction) // 2 * 2
    if rot == 0:
        return x
    inv = 1.0 / (theta ** (torch.arange(0, rot, 2, dtype=F32,
                                         device=x.device) / rot))
    ang = torch.arange(S, dtype=F32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :rot // 2], x[..., rot // 2:rot]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos, x[..., rot:]],
                     dim=-1)


def _causal(q, k, v, scale: float) -> torch.Tensor:
    """q (S, H, dk), k (S, KVH, dk), v (S, KVH, dv) -> (S, H, dv)."""
    S, H, _ = q.shape
    G = H // k.shape[1]
    k = k.repeat_interleave(G, dim=1)
    v = v.repeat_interleave(G, dim=1)
    s = torch.einsum("shd,thd->hst", q, k) * scale
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~mask, float("-inf"))
    return torch.einsum("hst,thd->shd", torch.softmax(s, dim=-1), v)


def _gqa(m, p, h, lin: _Lin):
    S = h.shape[0]
    H, KVH = m["n_heads"], m["n_kv_heads"]
    Dh = m.get("head_dim") or m["d_model"] // H
    th, fr = m.get("rope_theta", 1e4), m.get("rope_fraction", 1.0)
    q = _rope(lin(h, p["wq"]).reshape(S, H, Dh), th, fr)
    k = _rope(lin(h, p["wk"]).reshape(S, KVH, Dh), th, fr)
    v = lin(h, p["wv"]).reshape(S, KVH, Dh)
    out = _causal(q, k, v, Dh ** -0.5).reshape(S, H * Dh)
    return lin(out, p["wo"])


def _mla(m, p, h, lin: _Lin):
    a = m["mla"]
    S, H = h.shape[0], m["n_heads"]
    nope, rope, r, dv = (a["qk_nope_head_dim"], a["qk_rope_head_dim"],
                         a["kv_lora_rank"], a["v_head_dim"])
    th = m.get("rope_theta", 1e4)
    cq = _norm("rmsnorm", p["q_norm"], lin(h, p["w_dq"]))
    q = lin(cq, p["w_uq"]).reshape(S, H, nope + rope)
    q = torch.cat([q[..., :nope], _rope(q[..., nope:], th, 1.0)], dim=-1)
    ckv = lin(h, p["w_dkv"])
    c = _norm("rmsnorm", p["kv_norm"], ckv[:, :r])
    k_rope = _rope(ckv[:, None, r:], th, 1.0).expand(S, H, rope)
    out = torch.empty((S, H, dv), dtype=F32, device=h.device)
    # the latent is expanded at the level of the querying row
    groups = [(None, None)] if lin.qrows is None else \
        [(g, lin.qrows == g) for g in (False, True)]
    for g, rows in groups:
        if rows is not None and not bool(rows.any()):
            continue
        wl = _Lin(None if g is None else
                  torch.full((S,), g, dtype=torch.bool, device=h.device),
                  lin.mode)
        kv = wl(c, p["w_ukv"]).reshape(S, H, nope + dv)
        k = torch.cat([kv[..., :nope], k_rope], dim=-1)
        o = _causal(q, k, kv[..., nope:], (nope + rope) ** -0.5)
        if rows is None:
            out = o
        else:
            out[rows] = o[rows]
    return lin(out.reshape(S, H * dv), p["wo"])


_ACT = {"silu": torch.nn.functional.silu,
        "sqrelu": lambda x: torch.square(torch.relu(x))}


def _mlp(m, p, h, lin: _Lin):
    act = _ACT[m["act"]]
    up = lin(h, p["w_up"])
    if "w_gate" in p:
        return lin(act(lin(h, p["w_gate"])) * up, p["w_down"])
    return lin(act(up), p["w_down"])


def _route(m, p, h):
    """Each row's K+1 best selection scores and their experts, and the
    sigmoid gate scores of every expert."""
    mo = m["moe"]
    score = torch.sigmoid(h @ p["router"].to(F32))
    sel = score + p["router_bias"].to(F32) if "router_bias" in p else score
    top = torch.topk(sel, mo["top_k"] + 1, dim=-1)
    return top.values, top.indices, score


def _gates(m, score, chosen):
    g = torch.gather(score, 1, chosen)
    return g / (g.sum(dim=-1, keepdim=True) + 1e-9) * \
        m["moe"]["routed_scaling_factor"]


def _experts(m, p, h, lin: _Lin, chosen, gates):
    y = torch.zeros_like(h)
    act = _ACT[m["act"]]
    for e in torch.unique(chosen).tolist():
        tok, slot = torch.nonzero(chosen == e, as_tuple=True)
        el = _Lin(None if lin.qrows is None else lin.qrows[tok], lin.mode)
        x = h[tok]
        he = act(el(x, p["w_gate"][e])) * el(x, p["w_up"][e])
        y.index_add_(0, tok, el(he, p["w_down"][e]) * gates[tok, slot, None])
    if "shared" in p:
        y = y + _mlp(m, p["shared"], h, lin)
    return y


def _moe(m, p, h, lin: _Lin, margin: torch.Tensor):
    """The MoE FFN; ``margin`` takes each row's routing margin (minimum
    over the layers): the K-th selection score less the (K+1)-th."""
    K = m["moe"]["top_k"]
    best, idx, score = _route(m, p, h)
    torch.minimum(margin, best[:, K - 1] - best[:, K], out=margin)
    chosen = idx[:, :K]
    return _experts(m, p, h, lin, chosen, _gates(m, score, chosen))


MAX_UNSURE = 8


def _moe_alternatives(m, p, h, lin: _Lin, tau: float):
    """The other routings a bf16 program may take at a near-tie. For each
    row, the experts whose selection score lies within ``tau`` of the
    boundary between the reference's K-th and (K+1)-th (at most
    ``MAX_UNSURE``, the nearest) are unsure; every other choice of the
    unsure ones that keeps K experts is an alternative. Returns (row of
    each alternative, its MoE output)."""
    K = m["moe"]["top_k"]
    score = torch.sigmoid(h @ p["router"].to(F32))
    sel = score + p["router_bias"].to(F32) if "router_bias" in p else score
    top = torch.topk(sel, min(K + MAX_UNSURE, sel.shape[-1]), dim=-1)
    bound = (top.values[:, K - 1] + top.values[:, K]) / 2
    near = (top.values - bound[:, None]).abs() < tau
    rows, sets = [], []
    for r in torch.nonzero(near[:, K - 1] | near[:, K], as_tuple=True)[0] \
            .tolist():
        unsure = torch.nonzero(near[r], as_tuple=True)[0].tolist()
        unsure = sorted(unsure, key=lambda i: abs(float(top.values[r, i])
                                                  - float(bound[r])))
        unsure = sorted(unsure[:MAX_UNSURE])
        sure = [i for i in range(K) if i not in unsure]
        own = tuple(i for i in unsure if i < K)
        for pick in itertools.combinations(unsure, K - len(sure)):
            if pick != own:
                rows.append(r)
                sets.append(top.indices[r, sure + list(pick)])
    if not rows:
        return None
    rows_t = torch.tensor(rows, device=h.device)
    chosen = torch.stack(sets)
    lr = _Lin(None if lin.qrows is None else lin.qrows[rows_t], lin.mode)
    return rows_t, _experts(m, p, h[rows_t], lr, chosen,
                            _gates(m, score[rows_t], chosen))


def _head(model, misc, x, mode):
    xr = _norm(model["norm"], misc["final_norm"], x)
    if mode == "fp8":
        xr = _fp8(xr, -1)
    head = misc["lm_head"]
    out = torch.empty((xr.shape[0], head.shape[1]), dtype=F32,
                      device=xr.device)
    step = 1 << 15
    for i in range(0, head.shape[1], step):
        w = head[:, i:i + step].to(F32)
        out[:, i:i + step] = xr @ (_fp8(w, 0) if mode == "fp8" else w)
    return out


def logits(model: Dict, layers: Sequence[Dict], misc: Dict,
           tokens: torch.Tensor, row_level: torch.Tensor,
           rank: Sequence[int], rows: torch.Tensor,
           mode: str = "fp32", stats: Optional[Dict] = None,
           alt_margin: Optional[float] = None,
           alt_pick: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Float32 logits (len(rows), vocab) at ``rows`` of the sequence
    ``tokens`` (S,), each row processed at swap level ``row_level`` (S,);
    ``rank[l]`` is layer l's place in the swap order. With ``alt_margin``
    and ``alt_pick`` (a token per row), when the last layer is an MoE
    layer, each requested row near a routing tie there
    (``_moe_alternatives``) is also run under each other routing, and
    ``stats["alt_gap"]`` = (indices into ``rows``, for each the smallest
    over its alternatives of how far its pick lies below the best)."""
    ks = kinds(model)
    x = misc["embed"][tokens.long()].to(F32)
    margin = torch.full((x.shape[0],), float("inf"), device=x.device)
    rows = rows.long()
    alt = None
    for li, (kind, p) in enumerate(zip(ks, layers)):
        qrows = row_level > rank[li]
        lin = _Lin(qrows, mode)
        h = _norm(model["norm"], p["ln1"], x)
        attn = _mla if model.get("mla") else _gqa
        x = x + attn(model, p["attn"], h, lin)
        h2 = _norm(model["norm"], p["ln2"], x)
        if not kind.endswith("moe"):
            x = x + _mlp(model, p["mlp"], h2, lin)
            continue
        if alt_margin is not None and li == len(ks) - 1:
            found = _moe_alternatives(model, p["moe"], h2[rows],
                                      _Lin(qrows[rows], mode), alt_margin)
            if found is not None:
                alt = (found[0], x[rows][found[0]] + found[1])
        x = x + _moe(model, p["moe"], h2, lin, margin)
    if stats is not None:
        stats["route_margin"] = margin[rows]
        if alt is not None:
            pos, xa = alt
            gap = torch.empty(len(pos), dtype=F32, device=x.device)
            for i in range(0, len(pos), 256):
                la = _head(model, misc, xa[i:i + 256], mode)
                pk = alt_pick[pos[i:i + 256]][:, None]
                gap[i:i + 256] = la.max(dim=-1).values - la.gather(1, pk)[:, 0]
            best = torch.full((len(rows),), float("inf"), device=x.device)
            best.scatter_reduce_(0, pos, gap, reduce="amin")
            hit = torch.nonzero(best < float("inf"), as_tuple=True)[0]
            stats["alt_gap"] = (hit, best[hit])
    return _head(model, misc, x[rows], mode)
