"""The comparison that decides ``correct`` for a served model.

Once the window has closed, a sample drawn from the seed of the requests
the engine finished, with the longest among them, is run through the plain
reference (``reference/model.py``) once each, over its prompt and the
tokens it was served, each row at the swap level the engine processed it at.
For every served token the reference's logits say how far its logit lies
below the reference's best; the number compared is the widest such gap.
Under greedy decoding a sound program serves the reference's top token up
to rounding, so its gaps are rounding-sized; a wrong layer, a wrong level,
a corrupted pool or an altered token shows as a gap of the logits' own
scale.

A served model with sparse experts routes each token to its top-K
experts; where two selection scores at the boundary of the reference's
top K lie within rounding of each other, a sound bf16 program may take
either expert, and the token's logits then differ by a whole expert's
share. For a row near such a tie at the last layer (experts within ``route_alt_margin`` of
the boundary, the configuration's ``check`` section, in selection-score
units), the reference also computes the logits under every other choice
of those experts, and the token's gap is the smallest of them. The rule reads only
the reference's own routing; how many rows it reached is printed.

The control (``control.py``) reads the same number for the reference run
in float8 in place of the program: at each position the token the float8
run puts first, and how far the float32 reference puts it below its best.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from servebench.reference import model as ref


@dataclasses.dataclass
class Served:
    """One finished request as the check sees it: the original prompt, the
    tokens served, the epoch (preemption count) each was produced in, and
    per epoch the swap level of each written position as run-length
    segments ``[start, end, level]``."""
    prompt: List[int]
    tokens: List[int]
    tok_epoch: List[int]
    segments: Dict[int, List[List[int]]]


def sample(served: Sequence[Served], seed: int, min_tokens: int,
           max_requests: int) -> List[Served]:
    """The longest request, then others drawn from ``seed`` until
    ``min_tokens`` served tokens or ``max_requests`` requests."""
    if not served:
        return []
    order = sorted(range(len(served)), key=lambda i: -len(served[i].tokens))
    rest = order[1:]
    np.random.default_rng([int(seed) % 2 ** 63, 29]).shuffle(rest)
    picked, n = [], 0
    for i in [order[0]] + rest:
        if len(picked) >= max_requests or n >= min_tokens:
            break
        picked.append(served[i])
        n += len(served[i].tokens)
    return picked


def _row_levels(segs: List[List[int]], n: int, device) -> torch.Tensor:
    lv = torch.full((n,), -1, dtype=torch.int64)
    for a, b, level in segs:
        lv[a:min(b, n)] = level
    if bool((lv < 0).any()):
        raise AssertionError("a position the check needs has no recorded "
                             "swap level")
    return lv.to(device)


def _jobs(s: Served):
    """(epoch, rows, targets, sequence prefix) per epoch of ``s``: row p's
    logits predict token p + 1 of prompt + served tokens."""
    seq = list(s.prompt) + list(s.tokens)
    n0 = len(s.prompt)
    for e in sorted(set(s.tok_epoch)):
        ks = [k for k, te in enumerate(s.tok_epoch) if te == e]
        rows = [n0 - 1 + k for k in ks]
        yield e, rows, [seq[p + 1] for p in rows], seq[:max(rows) + 1]


@torch.no_grad()
def gaps(model: Dict, layers, misc, samples: Sequence[Served],
         rank: Sequence[int], device, control: bool = False,
         alt_margin: Optional[float] = None
         ) -> List[Tuple[float, float]]:
    """Per served token of ``samples``: (how far the reference puts it
    below its best logit, the reference's routing margin at its row). With
    ``control``, the token is the one the float8 run of the reference puts
    first at that position. With ``alt_margin``, a token whose row routes
    within that margin of a tie at the last (MoE) layer takes the smallest
    of its gaps under the sides of the tie."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out: List[Tuple[float, float]] = []
    for s in samples:
        for e, rows, targets, seq in _jobs(s):
            toks = torch.tensor(seq, dtype=torch.int64, device=device)
            lv = _row_levels(s.segments[e], len(seq), device)
            r = torch.tensor(rows, dtype=torch.int64, device=device)
            if control:
                lc = ref.logits(model, layers, misc, toks, lv, rank, r,
                                mode="fp8")
                pick = lc.argmax(dim=-1)
                del lc
            else:
                pick = torch.tensor(targets, dtype=torch.int64,
                                    device=device)
            st: Dict = {}
            lg = ref.logits(model, layers, misc, toks, lv, rank, r,
                            stats=st, alt_margin=alt_margin, alt_pick=pick)
            gap = lg.max(dim=-1).values - lg.gather(1, pick[:, None])[:, 0]
            del lg
            if "alt_gap" in st:
                pos, ga = st["alt_gap"]
                gap[pos] = torch.minimum(gap[pos], ga)
            out.extend(zip(gap.tolist(), st["route_margin"].tolist()))
    return out


def verdict(widest: Optional[float], limit: Optional[float]
            ) -> Tuple[bool, str]:
    """(correct, why) for the widest gap against its limit."""
    if widest is None:
        return False, "no finished request to compare"
    if limit is None:
        return False, "no limit set for this configuration"
    return widest <= limit, ""
