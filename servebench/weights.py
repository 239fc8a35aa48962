"""Seeded weights in the port's parameter tree, made on the device.

The benchmark makes the weights itself and hands the same tensors to the
engine and, after the window, to the plain reference. Each leaf is drawn
from one ``torch.Generator`` on the device, in float32 chunks of at most
``CHUNK`` elements, scaled and stored in the served dtype, so a model of
tens of GB is made in some tens of calls with no float32 copy of a whole
leaf. The tree is the one ``repro_torch.models.lm.init_params`` gives
(``{"embed", "final_norm", "lm_head", "segments"}``, a segment's layers
stacked along a leading dim when its pattern repeats), with the same
scales: N(0, 1) / sqrt(fan_in) for a matmul weight, N(0, 1) * 0.02 for the
embedding and the MoE router (float32), ones and zeros for the norms.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

CHUNK = 1 << 28


class _Maker:
    def __init__(self, seed: int, device, dtype):
        self.gen = torch.Generator(device=device).manual_seed(int(seed))
        self.device = torch.device(device)
        self.dtype = dtype

    def normal(self, shape, scale: float, dtype=None) -> torch.Tensor:
        out = torch.empty(shape, dtype=dtype or self.dtype,
                          device=self.device)
        flat = out.view(-1)
        for i in range(0, flat.numel(), CHUNK):
            n = min(CHUNK, flat.numel() - i)
            tmp = torch.randn(n, generator=self.gen, device=self.device,
                              dtype=torch.float32)
            flat[i:i + n].copy_(tmp.mul_(scale))
        return out

    def dense(self, lead: Tuple[int, ...], k: int, n: int) -> torch.Tensor:
        return self.normal((*lead, k, n), k ** -0.5)

    def const(self, shape, value: float, dtype=None) -> torch.Tensor:
        return torch.full(shape, value, dtype=dtype or self.dtype,
                          device=self.device)


def _norm(mk: _Maker, lead, kind: str, dim: int) -> Dict[str, torch.Tensor]:
    if kind == "rmsnorm":
        return {"scale": mk.const((*lead, dim), 1.0)}
    return {"scale": mk.const((*lead, dim), 1.0),
            "bias": mk.const((*lead, dim), 0.0)}


def _mlp(mk: _Maker, lead, m: Dict, d_ff: int) -> Dict[str, torch.Tensor]:
    D = m["d_model"]
    p = {"w_up": mk.dense(lead, D, d_ff), "w_down": mk.dense(lead, d_ff, D)}
    if m.get("gated_mlp", True):
        p["w_gate"] = mk.dense(lead, D, d_ff)
    return p


def _attn(mk: _Maker, lead, m: Dict) -> Dict[str, torch.Tensor]:
    D, H = m["d_model"], m["n_heads"]
    mla = m.get("mla")
    if mla:
        qk = mla["qk_nope_head_dim"] + mla["qk_rope_head_dim"]
        r = mla["kv_lora_rank"]
        return {"w_dq": mk.dense(lead, D, mla["q_lora_rank"]),
                "q_norm": _norm(mk, lead, "rmsnorm", mla["q_lora_rank"]),
                "w_uq": mk.dense(lead, mla["q_lora_rank"], H * qk),
                "w_dkv": mk.dense(lead, D, r + mla["qk_rope_head_dim"]),
                "kv_norm": _norm(mk, lead, "rmsnorm", r),
                "w_ukv": mk.dense(lead, r, H * (mla["qk_nope_head_dim"]
                                                + mla["v_head_dim"])),
                "wo": mk.dense(lead, H * mla["v_head_dim"], D)}
    Dh = m.get("head_dim") or D // H
    KVH = m["n_kv_heads"]
    return {"wq": mk.dense(lead, D, H * Dh), "wk": mk.dense(lead, D, KVH * Dh),
            "wv": mk.dense(lead, D, KVH * Dh), "wo": mk.dense(lead, H * Dh, D)}


def _moe(mk: _Maker, lead, m: Dict) -> Dict[str, torch.Tensor]:
    mo = m["moe"]
    D, E, F = m["d_model"], mo["n_routed_experts"], mo["d_ff_expert"]
    p = {"router": mk.normal((*lead, D, E), 0.02, dtype=torch.float32),
         "w_gate": mk.dense((*lead, E), D, F),
         "w_up": mk.dense((*lead, E), D, F),
         "w_down": mk.dense((*lead, E), F, D)}
    if mo.get("router_aux_free_bias"):
        p["router_bias"] = mk.const((*lead, E), 0.0, dtype=torch.float32)
    if mo.get("n_shared_experts"):
        p["shared"] = _mlp(mk, lead, m, F * mo["n_shared_experts"])
    return p


def _block(mk: _Maker, lead, kind: str, m: Dict) -> Dict:
    p = {"ln1": _norm(mk, lead, m["norm"], m["d_model"]),
         "attn": _attn(mk, lead, m),
         "ln2": _norm(mk, lead, m["norm"], m["d_model"])}
    if kind in ("moe", "mla_moe"):
        p["moe"] = _moe(mk, lead, m)
    elif kind in ("dense", "mla_dense"):
        p["mlp"] = _mlp(mk, lead, m, m["d_ff"])
    else:
        raise ValueError(f"no weights for layer kind {kind!r}")
    return p


def make(model: Dict, segments: List[Tuple[Tuple[str, ...], int]], seed: int,
         device) -> Dict:
    """The parameter tree of ``model`` (a configuration's ``model``
    section) for the port's ``segments`` (``lm.segment_plan``): layers in
    segment order, then the embedding, the final norm and the head."""
    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32,
             "float16": torch.float16}[model["dtype"]]
    mk = _Maker(seed, device, dtype)
    segs = []
    for pattern, reps in segments:
        lead = (reps,) if reps > 1 else ()
        segs.append(tuple(_block(mk, lead, kind, model) for kind in pattern))
    D, V = model["d_model"], model["vocab"]
    params = {"segments": segs,
              "embed": mk.normal((V, D), 0.02),
              "final_norm": _norm(mk, (), model["norm"], D)}
    if not model.get("tie_embeddings"):
        params["lm_head"] = mk.dense((), D, V)
    return params


def layer_list(params: Dict, segments) -> List[Tuple[str, Dict]]:
    """The tree's layers in order, [(kind, per-layer dict of views)]."""
    out = []
    for (pattern, reps), seg in zip(segments, params["segments"]):
        for r in range(reps):
            for kind, p in zip(pattern, seg):
                out.append((kind, _index(p, r) if reps > 1 else p))
    return out


def _index(tree, r):
    if isinstance(tree, dict):
        return {k: _index(v, r) for k, v in tree.items()}
    return tree[r]
