"""Per-device matmul FLOPs, matmul bytes and collectives of one step on a
mesh: the port's counterpart of the JAX package's ``launch/hlo_analysis.py``.

JAX reads these from the partitioned HLO that GSPMD compiles. Torch has
no such compiler here, so the step itself is run once on ``meta`` tensors
(no data, no allocation) under :class:`StepAnalysis`, a dispatch mode that
carries a layout beside every tensor and applies, op by op, the rules
below. Each number is what one device would do.

Layouts. A layout is, per tensor dim, the mesh axes the dim is split over
(major first), plus the axes over which the tensor is a *partial sum*
still to be reduced. A reshape may split an axis across two dims (a
16-way model split of the heads of a (KVH, G) grouped-query view: 8 on
KVH, 2 on G), as GSPMD tiles it: the two pieces are sub-axes
``model/8@2`` and ``model/2@1`` (size @ stride), one again when merged. The step's inputs take the cell's specs
(``distributed/sharding.py``: ``param_specs(fsdp=True)``, ``data_spec``,
``cache_specs``; AdamW's moments their parameter's). A tensor an op makes
from nothing (``zeros``, ``arange``) is replicated. The ``ShardCtx`` hints
reshard to the spec they name.

Rules.
  * Elementwise: each output dim takes the first operand's split of it; an
    operand split otherwise is gathered (or moved: all-to-all).
  * Views (reshape, permute, expand, slice, split, ...): the splits follow
    the dims; a split a reshape cannot carry is gathered.
  * Matmuls (``mm``, ``bmm``, ``addmm``, ``baddbmm``): the output keeps the
    batch, row and column splits; an operand whose contraction dim is
    split on an axis the output already uses (FSDP: a weight split on
    data times activations split on data) is all-gathered; a contraction
    split on a free axis leaves a partial sum, unless that sum is more
    than ``PARTIAL_OVER_GATHER`` times the bytes of gathering the
    operands instead (attention scores over a split head dim). Local
    FLOPs and bytes are those of the operands' local shapes after these
    gathers.
  * Reductions over a split dim: a sum leaves a partial sum; a max, a
    softmax, a sort or a scan gathers or all-reduces.
  * Gathers by index (``embed[tokens]``) from a table split on the indexed
    dim leave a partial sum (masked local lookup); scatters of rows split
    over an axis (``index_add``, ``index_put(accumulate)``, the embedding
    gradient) leave a partial sum over it. An index made by ``arange``
    (and its views and repeats: the MoE dispatch's token of each pair)
    gathers and scatters in place: the rows stay split, as GSPMD finds
    such iota indices.
  * A partial sum is kept through linear ops and reduced where the values
    are needed: reduce-scatter when it is the gradient of a parameter split
    on a batch axis (FSDP: a tensor of that parameter's shape whose splits
    and partial axes its layout holds; it takes that layout), else
    all-reduce.

Each collective is booked by kind with the bytes of its output on one
device (the JAX record's convention). Ops without a rule are booked as
elementwise when their output has an input's shape, else replicated, and
named in ``unmodelled_ops``.

What the record leaves out, having no honest counterpart without a
compiler: ``generated_code_size_in_bytes``, ``temp_size_in_bytes``,
``alias_size_in_bytes``, ``output_size_in_bytes``, the ``cost_*`` keys and
``compile_s``.
"""
from __future__ import annotations

import math
from collections import Counter
from typing import Dict, Iterable, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

aten = torch.ops.aten
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")
BATCH_AXES = ("pod", "data")
# a partial sum this many times the bytes of gathering the contraction's
# operands is not left: the contraction is gathered (see ``_dot``)
PARTIAL_OVER_GATHER = 4

Layout = Tuple[Tuple[Tuple[str, ...], ...], Tuple[str, ...]]


def norm_spec(spec, ndim: int):
    """A partition spec (per dim None, an axis name or a tuple of names)
    as a tuple of axis tuples, padded with () to ``ndim``."""
    out = []
    for e in tuple(spec)[:ndim]:
        out.append(() if e is None else (e,) if isinstance(e, str)
                   else tuple(e))
    return tuple(out) + ((),) * (ndim - len(out))


def _axes(spec) -> set:
    return {a for d in spec for a in d}


def _tensors(tree) -> List[torch.Tensor]:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _dims(dim, ndim: int) -> List[int]:
    """A dim argument (None, an int, a list; empty = every dim) as sorted
    non-negative dims."""
    if dim is None or (isinstance(dim, (list, tuple)) and not dim):
        return list(range(ndim))
    if isinstance(dim, int):
        dim = [dim]
    return sorted(d % ndim if ndim else 0 for d in dim)


class StepAnalysis(TorchDispatchMode):
    """The dispatch mode that carries layouts and books FLOPs, matmul bytes
    and collectives. ``axes``: {mesh axis: size}. Place the step's inputs
    with :meth:`place`, run the step under the mode, read :meth:`result`.
    ``records`` holds the ``ShardCtx`` hints met outside the backward pass
    (site, shape, dtype, spec)."""

    def __init__(self, axes: Dict[str, int]):
        super().__init__()
        self.size = dict(axes)
        self.table = WeakIdKeyDictionary()
        self.flops = 0.0
        self.dot_bytes = 0.0
        self.global_flops = 0.0
        self.coll = {k: 0.0 for k in KINDS}
        self.count = {k: 0 for k in KINDS}
        self.records: List[dict] = []
        self.unmodelled: Counter = Counter()
        self._fsdp: Dict[tuple, list] = {}
        self._parts: Dict[str, tuple] = {}
        self._merges: Dict[tuple, list] = {}
        # index tensors made by arange (and its views and repeats): GSPMD
        # finds such iota indices and gathers or scatters along them where
        # the rows already are
        self.iota = WeakIdKeyDictionary()

    # ------------------------------------------------------------------
    # layouts
    # ------------------------------------------------------------------
    def _n(self, axes: Iterable[str]) -> int:
        n = 1
        for a in axes:
            n *= self.size[a]
        return n

    # sub-axes: a token is a mesh axis or "axis/size@stride", a factor of it
    def _part(self, tok: str):
        """(axis, lo, hi): the token covers factors [lo, hi) of its axis."""
        p = self._parts.get(tok)
        if p is None:
            root, _, rest = tok.partition("/")
            if rest:
                size, stride = (int(x) for x in rest.split("@"))
            else:
                size, stride = self.size[root], 1
            p = self._parts[tok] = (root, stride, stride * size)
        return p

    def overlap(self, a: str, b: str) -> bool:
        if a == b:
            return True
        ra, la, ha = self._part(a)
        rb, lb, hb = self._part(b)
        return ra == rb and max(la, lb) < min(ha, hb)

    def hits(self, axes, used) -> bool:
        """Some token of ``axes`` shares devices with one of ``used``."""
        return any(self.overlap(a, u) for a in axes for u in used)

    def within(self, a: str, axes) -> bool:
        """Token ``a`` is a factor of one of ``axes``."""
        ra, la, ha = self._part(a)
        for b in axes:
            rb, lb, hb = self._part(b)
            if ra == rb and lb <= la and ha <= hb:
                return True
        return False

    def _sub(self, root: str, lo: int, hi: int) -> str:
        if lo == 1 and hi == self.size[root]:
            return root
        tok = f"{root}/{hi // lo}@{lo}"
        self.size[tok] = hi // lo
        return tok

    def split_token(self, tok: str, g: int):
        """(major piece of size g, minor piece) of a token."""
        root, lo, hi = self._part(tok)
        return self._sub(root, hi // g, hi), self._sub(root, lo, hi // g)

    def canon(self, axes) -> tuple:
        """Merge adjacent major/minor pieces of one axis."""
        out: list = []
        for a in axes:
            if out:
                r0, l0, h0 = self._part(out[-1])
                r1, l1, h1 = self._part(a)
                if r0 == r1 and l0 == h1:
                    out[-1] = self._sub(r0, l1, h0)
                    continue
            out.append(a)
        return tuple(out)

    def local_numel(self, shape, spec) -> int:
        n = 1
        for s, ax in zip(shape, spec):
            n *= -(-int(s) // self._n(ax))
        return n

    def local_bytes(self, t: torch.Tensor, spec=None) -> int:
        spec = self.layout(t)[0] if spec is None else spec
        return self.local_numel(t.shape, spec) * t.element_size()

    def layout(self, t: torch.Tensor) -> Layout:
        lay = self.table.get(t)
        if lay is None or len(lay[0]) != t.ndim:
            return ((),) * t.ndim, ()
        return lay

    def _set(self, t, spec, partial=()):
        if isinstance(t, torch.Tensor):
            self.table[t] = (tuple(spec), tuple(partial))

    def place(self, t: torch.Tensor, spec) -> None:
        """Lay out a step input as ``spec``. An input of at least two dims
        split on a batch axis (an FSDP parameter) is remembered by shape,
        with a stacked one's per-layer shape: a gradient of that shape is
        reduce-scattered to its layout."""
        sp = self._spec(spec, t.ndim)
        self._set(t, sp)
        if any(a in BATCH_AXES for a in _axes(sp)) and t.ndim >= 2:
            for shape, s in ((tuple(t.shape), sp),
                             (tuple(t.shape[1:]), sp[1:])):
                if len(shape) >= 2 and any(a in BATCH_AXES
                                           for a in _axes(s)):
                    known = self._fsdp.setdefault(shape, [])
                    if s not in known:
                        known.append(s)

    def _spec(self, spec, ndim: int):
        """``norm_spec`` without the axes of size 1 (they split nothing)."""
        return tuple(tuple(a for a in d if self.size[a] > 1)
                     for d in norm_spec(spec, ndim))

    def _comm(self, kind: str, nbytes: float) -> None:
        self.coll[kind] += float(nbytes)
        self.count[kind] += 1

    def settle(self, t: torch.Tensor):
        """Reduce a partial sum (see the module's rules); returns the spec
        the values then have."""
        spec, part = self.layout(t)
        if not part:
            return spec
        # a weight gradient: the layout of a parameter of its shape that
        # holds its splits and its partial batch axes
        param = next((c for c in self._fsdp.get(tuple(t.shape), ())
                      if all(self.within(a, c[d]) for d in range(t.ndim)
                             for a in spec[d])
                      and all(self.within(a, _axes(c)) for a in part)),
                     None)
        if param is not None:
            self._comm("reduce-scatter", self.local_bytes(t, param))
            self._set(t, param)
            return param
        self._comm("all-reduce", self.local_bytes(t, spec))
        self._set(t, spec)
        return spec

    def reshard(self, t: torch.Tensor, target) -> None:
        """Lay ``t`` out as ``target`` (a hint), booking the collective:
        a partial sum reduce-scattered onto a dim the target splits on its
        axis (else all-reduced), an axis moved between dims an all-to-all,
        an axis dropped an all-gather. Splitting further is local."""
        tgt = self._spec(target, t.ndim)
        spec, part = self.layout(t)
        if part:
            spec = list(spec)
            scatter = []
            for a in part:
                hit = [d for d in range(t.ndim) if self.within(a, tgt[d])]
                if hit and not self.hits((a,), _axes(spec)):
                    spec[hit[0]] = spec[hit[0]] + (a,)
                    scatter.append(a)
            if len(scatter) < len(part):
                self._comm("all-reduce", self.local_bytes(t))
                scatter = []
                spec = list(self.layout(t)[0])
            if scatter:
                self._comm("reduce-scatter", self.local_bytes(t, spec))
            spec = tuple(spec)
            self._set(t, spec)
        want = _axes(tgt)
        moved = dropped = False
        for d in range(t.ndim):
            for a in spec[d]:
                if not self.within(a, tgt[d]):
                    if self.hits((a,), want):
                        moved = True
                    else:
                        dropped = True
        if moved:
            self._comm("all-to-all", self.local_bytes(t, spec))
        elif dropped:
            self._comm("all-gather", self.local_bytes(t, tgt))
        self._set(t, tgt)

    def constrain(self, x: torch.Tensor, spec, site: str = ""):
        """``ShardCtx.constrain`` under the dry run: record the hint (once,
        outside the backward pass, where a remat recompute meets it again)
        and reshard ``x`` and, in the backward pass, its gradient."""
        if torch._C._current_graph_task_id() == -1:
            self.records.append({
                "site": site, "shape": list(x.shape),
                "dtype": str(x.dtype).replace("torch.", ""),
                "spec": [list(a) if a else None
                         for a in norm_spec(spec, x.ndim)]})
        return _Constrain.apply(x, self, spec)

    # ------------------------------------------------------------------
    # dispatch
    # ------------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        rule = _RULES.get(func.overloadpacket)
        if rule is None:
            name = func.overloadpacket.__name__
            if name.endswith("_backward") \
                    or name in _POINTWISE_NAMES \
                    or name.rstrip("_") in _POINTWISE_NAMES:
                rule = _pointwise
            else:
                rule = _default
        rule(self, func, args, kwargs, out)
        return out

    def result(self) -> Dict[str, float]:
        out = {"hlo_dot_flops": self.flops, "hlo_dot_bytes": self.dot_bytes,
               "global_dot_flops": self.global_flops}
        for k in KINDS:
            out["coll_" + k] = self.coll[k]
            out["count_" + k] = self.count[k]
        return out


class _Constrain(torch.autograd.Function):
    """Identity whose output (and, backward, whose gradient) the analysis
    lays out as the hint's spec, as JAX constrains a cotangent too."""

    @staticmethod
    def forward(ctx, x, an, spec):
        ctx.an, ctx.spec = an, spec
        y = x.view_as(x)
        an.reshard(y, spec)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.view_as(g)
        ctx.an.reshard(g, ctx.spec)
        return g, None, None


# ----------------------------------------------------------------------
# rules: rule(an, func, args, kwargs, out)
# ----------------------------------------------------------------------
def _merge(an, out_shape, ins):
    """Per output dim, the first input's split of it (inputs aligned from
    the right, size-1 dims ignored); each axis used once. Returns (spec,
    inputs whose splits disagree)."""
    nd = len(out_shape)
    spec = [()] * nd
    used: list = []
    for t in ins:
        s = an.layout(t)[0]
        off = nd - t.ndim
        for i, ax in enumerate(s):
            d = off + i
            if not ax or d < 0 or t.shape[i] != out_shape[d]:
                continue
            if not spec[d] and not an.hits(ax, used):
                spec[d] = ax
                used += ax
    bad = []
    for t in ins:
        s = an.layout(t)[0]
        off = nd - t.ndim
        if any(ax and (off + i < 0 or t.shape[i] != out_shape[off + i]
                       or spec[off + i] != ax)
               for i, ax in enumerate(s)):
            bad.append(t)
    return spec, bad


def _realign(an, t, spec_out, out_shape):
    """Book what it costs to bring input ``t`` to the output's layout: an
    axis it splits that the output uses on another dim is moved
    (all-to-all), one the output does not use is gathered."""
    s = an.layout(t)[0]
    off = len(out_shape) - t.ndim
    used = _axes(spec_out)
    moved = dropped = False
    for i, ax in enumerate(s):
        d = off + i
        keep = spec_out[d] if 0 <= d < len(out_shape) \
            and t.shape[i] == out_shape[d] else ()
        for a in ax:
            if not an.within(a, keep):
                if an.hits((a,), used):
                    moved = True
                else:
                    dropped = True
    if moved:
        an._comm("all-to-all", an.local_bytes(t))
    elif dropped:
        kept = tuple(tuple(a for a in ax if an.within(a, (
            spec_out[off + i] if 0 <= off + i < len(out_shape)
            and t.shape[i] == out_shape[off + i] else ()))) for i, ax in
            enumerate(s))
        an._comm("all-gather", an.local_bytes(t, kept))


_LINEAR_ADD = {aten.add, aten.sub, aten.add_, aten.sub_}
_LINEAR_MUL = {aten.mul, aten.div, aten.mul_, aten.div_}
_LINEAR_UNARY = {aten.neg, aten._to_copy, aten.clone, aten.alias,
                 aten.detach, aten.lift_fresh, aten.copy}


def _pointwise(an, func, args, kwargs, out):
    outs = _tensors(out)
    if not outs:
        return
    ins = _tensors((args, kwargs))
    pkt = func.overloadpacket
    parts = [an.layout(t)[1] for t in ins]
    partial = ()
    pend = [p for p in parts if p]
    if pend:
        first = pend[0]
        linear = False
        if pkt in _LINEAR_UNARY:
            linear = len(ins) == 1
        elif pkt in _LINEAR_ADD:
            linear = all(p == first for p in parts)
        elif pkt in _LINEAR_MUL:
            linear = len(pend) == 1 and (parts[0] or pkt in (
                aten.mul, aten.mul_)) and not any(
                an.hits(first, _axes(an.layout(t)[0])) for t in ins)
        elif pkt.__name__.endswith("_backward"):
            linear = len(pend) == 1 and bool(parts[0])
        if linear:
            partial = first
        else:
            for t in ins:
                an.settle(t)
    spec, bad = _merge(an, tuple(outs[0].shape), ins)
    for t in bad:
        _realign(an, t, spec, tuple(outs[0].shape))
    for o in outs:
        if tuple(o.shape) == tuple(outs[0].shape):
            an._set(o, spec, partial)
        else:
            an._set(o, ((),) * o.ndim)


def _default(an, func, args, kwargs, out):
    outs = _tensors(out)
    ins = _tensors((args, kwargs))
    if outs and any(t.shape == outs[0].shape for t in ins):
        an.unmodelled[func.overloadpacket.__name__] += 1
        _pointwise(an, func, args, kwargs, out)
        return
    for t in ins:
        an.settle(t)
    if ins and outs:
        an.unmodelled[func.overloadpacket.__name__] += 1
    for o in outs:
        an._set(o, ((),) * o.ndim)


def _inplace_keep(an, func, args, kwargs, out):
    """``copy_``, ``fill_``, ``zero_``: the destination keeps its layout."""
    dst = args[0]
    spec, _ = an.layout(dst)
    for o in _tensors(out):
        an._set(o, spec)


def _factory(an, func, args, kwargs, out):
    for o in _tensors(out):
        an._set(o, ((),) * o.ndim)
        if func.overloadpacket is aten.arange:
            an.iota[o] = True


def _carry_iota(an, args, out):
    t = args[0]
    if isinstance(t, torch.Tensor) and t in an.iota:
        for o in _tensors(out):
            an.iota[o] = True


def _like(an, func, args, kwargs, out):
    spec = an.layout(args[0])[0]
    for o in _tensors(out):
        an._set(o, spec if o.shape == args[0].shape else ((),) * o.ndim)


# ------------------------------- views ---------------------------------
def _reshape_spec(an, in_shape, spec, out_shape):
    """Carry the splits of ``in_shape`` onto ``out_shape``: dims grouped
    by equal products, each group's axes laid major first on its output
    dims while the sizes divide. Returns (spec, axes dropped)."""
    out = [()] * len(out_shape)
    ins = [d for d in range(len(in_shape)) if in_shape[d] != 1]
    outs = [d for d in range(len(out_shape)) if out_shape[d] != 1]
    dropped = []
    a = b = 0
    while a < len(ins) and b < len(outs):
        gi, gj = [ins[a]], [outs[b]]
        pi, pj = in_shape[ins[a]], out_shape[outs[b]]
        a += 1
        b += 1
        while pi != pj:
            if pi < pj and a < len(ins):
                gi.append(ins[a])
                pi *= in_shape[ins[a]]
                a += 1
            elif b < len(outs):
                gj.append(outs[b])
                pj *= out_shape[outs[b]]
                b += 1
            else:
                break
        rem = list(an.canon([x for d in gi for x in spec[d]]))
        sizes = tuple(out_shape[d] for d in gj)
        if len(gi) > 1 and len(gj) == 1 and rem:
            # remember which dim each axis came from, for the split back
            an._merges[(tuple(rem), tuple(in_shape[d] for d in gi))] = \
                [spec[d] for d in gi]
        back = an._merges.get((tuple(rem), sizes)) \
            if len(gi) == 1 and len(gj) > 1 else None
        if back is not None:
            for d, ax in zip(gj, back):
                out[d] = ax
            continue
        for d in gj:
            left, put = out_shape[d], []
            while rem:
                n = an.size[rem[0]]
                if left % n == 0:
                    left //= n
                    put.append(rem.pop(0))
                    continue
                g = math.gcd(left, n)
                if g > 1:                # split the axis across two dims
                    major, rem[0] = an.split_token(rem[0], g)
                    put.append(major)
                    left //= g
                break
            out[d] = an.canon(put)
        dropped += rem
    for d in ins[a:]:
        dropped += list(spec[d])
    return tuple(out), dropped


def _view(an, func, args, kwargs, out):
    t = args[0]
    o = out
    _carry_iota(an, args, out)
    spec, part = an.layout(t)
    new, dropped = _reshape_spec(an, tuple(t.shape), spec, tuple(o.shape))
    if dropped:
        an._comm("all-gather", an.local_bytes(o, new))
    an._set(o, new, part)


def _same(an, func, args, kwargs, out):
    _carry_iota(an, args, out)
    spec, part = an.layout(args[0])
    for o in _tensors(out):
        an._set(o, spec if o.ndim == len(spec) else ((),) * o.ndim, part)


def _permute(an, func, args, kwargs, out):
    spec, part = an.layout(args[0])
    dims = [d % len(spec) for d in args[1]]
    an._set(out, tuple(spec[d] for d in dims), part)


def _transpose(an, func, args, kwargs, out):
    spec, part = an.layout(args[0])
    spec = list(spec)
    if func.overloadpacket is aten.t:
        spec = spec[::-1]
    else:
        d0, d1 = (args[1] % len(spec), args[2] % len(spec)) if spec \
            else (0, 0)
        spec[d0], spec[d1] = spec[d1], spec[d0]
    an._set(out, tuple(spec), part)


def _expand(an, func, args, kwargs, out):
    _carry_iota(an, args, out)
    t = args[0]
    spec, part = an.layout(t)
    off = out.ndim - t.ndim
    new = [()] * off + [ax if t.shape[i] == out.shape[off + i] else ()
                        for i, ax in enumerate(spec)]
    an._set(out, tuple(new), part)


def _unsqueeze(an, func, args, kwargs, out):
    _carry_iota(an, args, out)
    spec, part = an.layout(args[0])
    d = args[1] % (len(spec) + 1)
    an._set(out, spec[:d] + ((),) + spec[d:], part)


def _squeeze(an, func, args, kwargs, out):
    t = args[0]
    spec, part = an.layout(t)
    dims = _dims(args[1] if len(args) > 1 else None, t.ndim)
    new = tuple(ax for i, ax in enumerate(spec)
                if not (i in dims and t.shape[i] == 1))
    an._set(out, new if len(new) == out.ndim else ((),) * out.ndim, part)


def _select(an, func, args, kwargs, out):
    t = args[0]
    spec, part = an.layout(t)
    d = args[1] % t.ndim
    if spec[d]:
        an._comm("all-gather", an.local_bytes(out, spec[:d] + spec[d + 1:]))
    an._set(out, spec[:d] + spec[d + 1:], part)


def _slice(an, func, args, kwargs, out):
    t = args[0]
    spec, part = an.layout(t)
    d = (args[1] if len(args) > 1 else kwargs.get("dim", 0)) % max(t.ndim, 1)
    spec = list(spec)
    if spec[d] and out.shape[d] != t.shape[d] and out.numel():
        if out.shape[d] % an._n(spec[d]) == 0:
            an._comm("collective-permute", an.local_bytes(out, spec))
        else:
            spec[d] = ()
            an._comm("all-gather", an.local_bytes(out, spec))
    an._set(out, tuple(spec), part)


def _split(an, func, args, kwargs, out):
    """Pieces of a split dim: a piece whose size the dim's split divides
    stays split, its rows moved to their new owners (collective-permute);
    the others are gathered."""
    t = args[0]
    spec, part = an.layout(t)
    d = (args[2] if len(args) > 2 else kwargs.get("dim", 0)) % t.ndim
    for o in _tensors(out):
        sp = list(spec)
        if sp[d] and o.shape[d] != t.shape[d] and o.numel():
            if o.shape[d] % an._n(sp[d]) == 0:
                an._comm("collective-permute", an.local_bytes(o, sp))
            else:
                sp[d] = ()
                an._comm("all-gather", an.local_bytes(o, sp))
        an._set(o, tuple(sp), part)


def _unbind(an, func, args, kwargs, out):
    t = args[0]
    spec, part = an.layout(t)
    d = (args[1] if len(args) > 1 else kwargs.get("dim", 0)) % t.ndim
    if spec[d]:
        an._comm("all-gather", an.local_bytes(t, spec[:d] + ((),)
                                              + spec[d + 1:]))
    for o in _tensors(out):
        an._set(o, spec[:d] + spec[d + 1:], part)


def _cat(an, func, args, kwargs, out):
    ts = [t for t in args[0] if t.ndim == out.ndim and t.numel()]
    d = (args[1] if len(args) > 1 else kwargs.get("dim", 0)) % out.ndim
    _join(an, ts, out, d)


def _stack(an, func, args, kwargs, out):
    ts = list(args[0])
    d = (args[1] if len(args) > 1 else kwargs.get("dim", 0)) % out.ndim
    views = []
    for t in ts:
        spec, part = an.layout(t)
        views.append((spec[:d] + ((),) + spec[d:], part))
    parts = [p for _, p in views]
    partial = parts[0] if parts and all(p == parts[0] for p in parts) \
        else ()
    if not partial:
        for t in ts:
            an.settle(t)
        views = [(an.layout(t)[0][:d] + ((),) + an.layout(t)[0][d:], ())
                 for t in ts]
    spec = [()] * out.ndim
    used: list = []
    for s, _ in views:
        for i, ax in enumerate(s):
            if ax and not spec[i] and not an.hits(ax, used):
                spec[i] = ax
                used += ax
    an._set(out, tuple(spec), partial)


def _join(an, ts, out, d):
    parts = [an.layout(t)[1] for t in ts]
    partial = parts[0] if parts and all(p == parts[0] for p in parts) \
        else ()
    if not partial:
        for t in ts:
            an.settle(t)
    spec = [()] * out.ndim
    used: list = []
    # pieces split alike on the joined dim, each divisible: the result stays
    # split, rows moved to their new owners (collective-permute)
    cat_ax = an.layout(ts[0])[0][d] if ts else ()
    keep = bool(cat_ax) and all(
        an.layout(t)[0][d] == cat_ax and t.shape[d] % an._n(cat_ax) == 0
        for t in ts)
    if keep:
        spec[d] = cat_ax
        used += cat_ax
    for t in ts:
        s = an.layout(t)[0]
        for i, ax in enumerate(s):
            if i == d and ax:
                if not keep:
                    an._comm("all-gather", an.local_bytes(
                        t, s[:d] + ((),) + s[d + 1:]))
            elif ax and not spec[i] and not an.hits(ax, used):
                spec[i] = ax
                used += ax
    if keep and len(ts) > 1:
        an._comm("collective-permute", an.local_bytes(out, spec))
    an._set(out, tuple(spec), partial)


def _pad(an, func, args, kwargs, out):
    t = args[0]
    spec, part = an.layout(t)
    spec = list(spec)
    pad = list(args[1])
    for k in range(len(pad) // 2):
        d = t.ndim - 1 - k
        if (pad[2 * k] or pad[2 * k + 1]) and spec[d]:
            spec[d] = ()
            an._comm("all-gather", an.local_bytes(t, spec))
    an._set(out, tuple(spec), part)


def _slice_backward(an, func, args, kwargs, out):
    g = args[0]
    spec, part = an.layout(g)
    d = args[2] % g.ndim
    spec = list(spec)
    if spec[d] and out.shape[d] % an._n(spec[d]):
        spec[d] = ()
    an._set(out, tuple(spec), part)


def _select_backward(an, func, args, kwargs, out):
    spec, part = an.layout(args[0])
    d = args[2] % out.ndim
    an._set(out, spec[:d] + ((),) + spec[d:], part)


# ----------------------------- reductions ------------------------------
_SUMS = {aten.sum, aten.mean}


def _reduction(an, func, args, kwargs, out):
    t = args[0]
    outs = _tensors(out)
    dim = kwargs.get("dim", args[1] if len(args) > 1 and isinstance(
        args[1], (int, list, tuple)) else None)
    dims = _dims(dim, t.ndim)
    linear = func.overloadpacket in _SUMS
    if not linear:
        an.settle(t)
    spec, part = an.layout(t)
    red = [a for d in dims for a in spec[d]]
    o0 = outs[0]
    if o0.ndim == t.ndim:
        new = tuple(() if d in dims else ax for d, ax in enumerate(spec))
    else:
        new = tuple(ax for d, ax in enumerate(spec) if d not in dims)
        if len(new) != o0.ndim:
            new = ((),) * o0.ndim
    partial = part
    if red:
        if linear:
            partial = tuple(part) + tuple(a for a in red if a not in part)
        else:
            an._comm("all-reduce", an.local_bytes(o0, new))
    for o in outs:
        an._set(o, new if o.ndim == len(new) else ((),) * o.ndim, partial)


_ALONG_DIM_ARG = {aten._softmax: 1, aten._log_softmax: 1, aten.cumsum: 1,
                  aten.cumprod: 1, aten.logcumsumexp: 1, aten.topk: 2,
                  aten.sort: 1, aten.argsort: 1, aten._softmax_backward_data: 2,
                  aten._log_softmax_backward_data: 2}


def _along_dim(an, func, args, kwargs, out):
    """Ops along one dim (softmax, scans, sorts): a split of that dim is
    gathered first."""
    pkt = func.overloadpacket
    t = args[0]
    ins = [x for x in _tensors(args) if x.shape == t.shape]
    for x in ins:
        an.settle(x)
    i = _ALONG_DIM_ARG.get(pkt, 1)
    dim = kwargs.get("dim", args[i] if len(args) > i and isinstance(
        args[i], int) else -1)
    d = dim % t.ndim if t.ndim else 0
    spec = tuple(_merge(an, tuple(t.shape), ins)[0])
    if t.ndim and spec[d]:
        an._comm("all-gather", an.local_bytes(t, spec[:d] + ((),)
                                              + spec[d + 1:]))
        spec = spec[:d] + ((),) + spec[d + 1:]
    for o in _tensors(out):
        an._set(o, spec if o.ndim == len(spec) else ((),) * o.ndim)


def _searchsorted(an, func, args, kwargs, out):
    seq, vals = args[0], args[1]
    an.settle(seq)
    if any(an.layout(seq)[0]):
        an._comm("all-gather", an.local_bytes(seq, ((),) * seq.ndim))
    spec = an.layout(vals)[0] if isinstance(vals, torch.Tensor) \
        else ((),) * out.ndim
    an._set(out, spec if len(spec) == out.ndim else ((),) * out.ndim)


# ------------------------------ matmuls --------------------------------
def _plan_dot(an, sa, sb, ma: int, nb_: int, nb: int):
    """Layout of a (batch.., m, k) @ b (batch.., k, n) with a's splits
    taking precedence: (batch, m, n, k, axes a is gathered on, axes b is
    gathered on). ``ma``/``nb_``: a's row and b's column sizes."""
    ga, gb = [], []
    used: list = []
    ob = []

    def free(axes):
        return tuple(x for x in axes if not an.hits((x,), used))

    for i in range(nb):
        x, y = sa[i], sb[i]
        if x and y and x != y:
            gb += y
        d = free(x if x else y)
        ob.append(d)
        used += d
    m = free(sa[nb])
    ga += [x for x in sa[nb] if x not in m]
    used += m
    n = free(sb[nb + 1])
    gb += [x for x in sb[nb + 1] if x not in n]
    used += n
    ka, kb = sa[nb + 1], sb[nb]
    # a contraction split finer on one side: the other is sliced to match
    if ka and kb and ka != kb and not an.hits(kb, used) \
            and all(an.within(x, kb) for x in ka):
        ka = kb
    elif ka and kb and ka != kb and not an.hits(ka, used) \
            and all(an.within(x, ka) for x in kb):
        kb = ka
    if ka == kb or not kb or not ka:
        k = ka or kb
        if an.hits(k, used):
            (ga if ka else gb).extend(k)
            if ka == kb:
                gb += k
            k = ()
    else:
        k = free(ka)
        ga += [x for x in ka if x not in k]
        gb += kb
    # a row or column split on part of an axis whose rest is free takes the
    # whole axis (the operand is replicated over the rest: a local slice)
    used += list(k)
    m = _promote(an, m, ma, used)
    n = _promote(an, n, nb_, used)
    return tuple(ob), m, n, k, ga, gb


def _dot(an, a, b, out, nb: int):
    """a (batch.., m, k) @ b (batch.., k, n), as the module's rules say.
    Where the operands' splits clash, the plan that gathers fewer bytes
    wins (a's splits first, or b's: GSPMD moves the smaller operand)."""
    sa, pa = an.layout(a)
    sb, pb = an.layout(b)
    if pa and pb:
        an.settle(b)
        sb, pb = an.layout(b)
    plans = []
    for rhs_first in (False, True):
        if rhs_first:
            tb = sb[:nb] + (sb[nb + 1], sb[nb])
            ta = sa[:nb] + (sa[nb + 1], sa[nb])
            ob, n, m, k, gb, ga = _plan_dot(an, tb, ta, b.shape[nb + 1],
                                            a.shape[nb], nb)
        else:
            ob, m, n, k, ga, gb = _plan_dot(an, sa, sb, a.shape[nb],
                                            b.shape[nb + 1], nb)
        la, lb = ob + (m, k), ob + (k, n)
        cost = (an.local_bytes(a, la) if ga else 0) \
            + (an.local_bytes(b, lb) if gb else 0)
        plans.append((cost, ob, m, n, k, ga, gb))
    cost, ob, m, n, k, ga, gb = min(plans, key=lambda p: p[0])
    if k:
        # a split contraction leaves a partial sum, reduced later at the
        # output's size; where that is many times the operands' gather
        # (attention scores over a split head dim), gather instead
        gather = sum(an.local_bytes(t, tuple(() if x == k else x
                                             for x in loc))
                     for t, loc in ((a, ob + (m, k)), (b, ob + (k, n))))
        if an.local_numel(out.shape, ob + (m, n)) * out.element_size() \
                > PARTIAL_OVER_GATHER * gather:
            ga, gb, k = list(ga) + list(k), list(gb) + list(k), ()
    la = ob + (m, k)
    lb = ob + (k, n)
    lo = ob + (m, n)
    for t, g, loc in ((a, ga, la), (b, gb, lb)):
        if g:
            an._comm("all-gather", an.local_bytes(t, loc))
    a_loc = [-(-s // an._n(ax)) for s, ax in zip(a.shape, la)]
    b_loc = [-(-s // an._n(ax)) for s, ax in zip(b.shape, lb)]
    fn = flop_registry[aten.bmm if nb else aten.mm]
    an.flops += fn(a_loc, b_loc)
    an.global_flops += fn(list(a.shape), list(b.shape))
    an.dot_bytes += (math.prod(a_loc) * a.element_size()
                     + math.prod(b_loc) * b.element_size()
                     + an.local_numel(out.shape, lo) * out.element_size())
    partial = tuple(pa) + tuple(pb) + tuple(ax for ax in k
                                            if ax not in pa + pb)
    an._set(out, lo, partial)


def _promote(an, axes, size: int, used) -> tuple:
    out = list(axes)
    for i, x in enumerate(out):
        root = an._part(x)[0]
        if root == x:
            continue
        rest = [u for u in used if u != x]
        trial = out[:i] + [root] + out[i + 1:]
        if not an.hits((root,), rest) and size % an._n(trial) == 0:
            out = trial
    return an.canon(out)


def _mm(an, func, args, kwargs, out):
    pkt = func.overloadpacket
    if pkt in (aten.addmm, aten.baddbmm):
        an.settle(args[0])
        a, b = args[1], args[2]
    else:
        a, b = args[0], args[1]
    _dot(an, a, b, out, 1 if pkt in (aten.bmm, aten.baddbmm) else 0)


# ------------------------- gathers and scatters ------------------------
def _index(an, func, args, kwargs, out):
    """``self[idx, ...]`` with index tensors at some dims."""
    t, idx = args[0], list(args[1])
    spec, part = an.layout(t)
    pos = [i for i, x in enumerate(idx) if x is not None]
    its = [x for x in idx if x is not None]
    for x in its:
        an.settle(x)
    nb = out.ndim - (t.ndim - len(pos))
    ishape = tuple(out.shape[pos[0]:pos[0] + nb]) \
        if pos == list(range(pos[0], pos[0] + len(pos))) \
        else tuple(out.shape[:nb])
    ispec, _ = _merge(an, ishape, its)
    rest = [spec[d] for d in range(t.ndim) if d not in pos]
    if pos == list(range(pos[0], pos[0] + len(pos))):
        new = rest[:pos[0]] + list(ispec) + rest[pos[0]:]
    else:
        new = list(ispec) + rest
    seen: list = []
    clash = False
    for d, ax in enumerate(new):
        keep = tuple(a for a in ax if not an.hits((a,), seen))
        clash |= keep != ax
        seen += keep
        new[d] = keep
    gathered = tuple(a for d in pos for a in spec[d])
    at = pos[0] if pos == list(range(pos[0], pos[0] + len(pos))) else 0
    if (len(its) == 1 and its[0] in an.iota and gathered and not new[at]
            and not an.hits(gathered, seen)
            and out.shape[at] % an._n(gathered) == 0):
        new[at] = gathered                # rows gathered where they are
        seen += gathered
        gathered = ()
    if clash:
        an._comm("all-gather", an.local_bytes(t, tuple(
            () if an.hits(ax, seen) and d not in pos else ax
            for d, ax in enumerate(spec))))
    partial = tuple(part)
    if gathered:
        if an.hits(gathered, seen):
            an._comm("all-gather", an.local_bytes(t, tuple(
                () if d in pos else ax for d, ax in enumerate(spec))))
        else:
            partial += tuple(a for a in gathered if a not in partial)
    an._set(out, tuple(new), partial)


def _embedding(an, func, args, kwargs, out):
    _index(an, func, (args[0], [args[1]]), {}, out)


def _scatter_partial(an, dst, srcs, out, accumulate: bool):
    """A scatter into ``dst``: the output keeps ``dst``'s layout; rows
    split over an axis the output does not use leave a partial sum when
    they accumulate."""
    an.settle(dst)
    spec = an.layout(dst)[0]
    used = _axes(spec)
    partial = []
    for s in srcs:
        an.settle(s)
        for a in _axes(an.layout(s)[0]):
            if not an.hits((a,), used) and a not in partial:
                if accumulate:
                    partial.append(a)
                else:
                    an._comm("all-gather", an.local_bytes(s, ((),) * s.ndim))
                    break
    an._set(out, spec, tuple(partial))


def _index_put(an, func, args, kwargs, out):
    acc = kwargs.get("accumulate", args[3] if len(args) > 3 else False)
    srcs = [x for x in args[1] if x is not None] + [args[2]]
    _scatter_partial(an, args[0], srcs, out, bool(acc))


def _index_add(an, func, args, kwargs, out):
    dst, d, index, src = args[0], args[1] % args[0].ndim, args[2], args[3]
    rows = an.layout(src)[0][d] if src.ndim == dst.ndim else ()
    if (index in an.iota and rows and not any(an.layout(dst)[0])
            and dst.shape[d] % an._n(rows) == 0):
        # rows scattered where they are: the output split like them
        an.settle(src)
        spec = list(an.layout(src)[0])
        an._set(out, tuple(spec), ())
        return
    _scatter_partial(an, dst, [index, src], out, True)


def _scatter(an, func, args, kwargs, out):
    srcs = [x for x in (args[2:4] if len(args) > 3 else args[2:3])
            if isinstance(x, torch.Tensor)]
    _scatter_partial(an, args[0], srcs, out,
                     func.overloadpacket in (aten.scatter_add,
                                             aten.scatter_add_,
                                             aten.scatter_reduce))


def _gather(an, func, args, kwargs, out):
    t, d, index = args[0], args[1] % args[0].ndim, args[2]
    an.settle(t)
    if an.layout(t)[0][d]:
        an._comm("all-gather", an.local_bytes(t, ((),) * t.ndim))
    an._set(out, an.layout(index)[0])


def _index_select(an, func, args, kwargs, out):
    t, d, index = args[0], args[1] % args[0].ndim, args[2]
    idx = [None] * d + [index]
    _index(an, func, (t, idx), {}, out)


def _embedding_backward(an, func, args, kwargs, out):
    g, idx = args[0], args[1]
    an.settle(g)
    gs = an.layout(g)[0]
    spec = ((),) * (out.ndim - 1) + (gs[-1] if gs else (),)
    used = _axes(spec)
    part = tuple(a for a in _axes(gs[:-1]) | _axes(an.layout(idx)[0])
                 if not an.hits((a,), used))
    an._set(out, spec, part)


_RULES = {}
for _ops, _rule in (
        ((aten.mm, aten.bmm, aten.addmm, aten.baddbmm), _mm),
        ((aten.view, aten._unsafe_view, aten.reshape, aten._reshape_alias),
         _view),
        ((aten.alias, aten.detach, aten.clone, aten._to_copy,
          aten.lift_fresh, aten.contiguous, aten._conj, aten.resolve_conj,
          aten.resolve_neg), _same),
        ((aten.permute,), _permute),
        ((aten.transpose, aten.t), _transpose),
        ((aten.expand,), _expand),
        ((aten.unsqueeze,), _unsqueeze),
        ((aten.squeeze,), _squeeze),
        ((aten.select,), _select),
        ((aten.slice,), _slice),
        ((aten.split, aten.split_with_sizes), _split),
        ((aten.unbind,), _unbind),
        ((aten.cat,), _cat),
        ((aten.stack,), _stack),
        ((aten.constant_pad_nd,), _pad),
        ((aten.slice_backward,), _slice_backward),
        ((aten.select_backward,), _select_backward),
        ((aten.sum, aten.mean, aten.amax, aten.amin, aten.max, aten.min,
          aten.argmax, aten.argmin, aten.var, aten.std, aten.any, aten.all,
          aten.prod, aten.logsumexp, aten.var_mean), _reduction),
        (tuple(_ALONG_DIM_ARG), _along_dim),
        ((aten.searchsorted,), _searchsorted),
        ((aten.index,), _index),
        ((aten.embedding,), _embedding),
        ((aten.index_select,), _index_select),
        ((aten.gather,), _gather),
        ((aten.index_put, aten.index_put_, aten._index_put_impl_,
          aten._unsafe_index_put), _index_put),
        ((aten.index_add, aten.index_add_), _index_add),
        ((aten.scatter, aten.scatter_, aten.scatter_add, aten.scatter_add_,
          aten.scatter_reduce), _scatter),
        ((aten.embedding_dense_backward,), _embedding_backward),
        ((aten.copy_, aten.fill_, aten.zero_), _inplace_keep),
        ((aten.zeros, aten.ones, aten.empty, aten.full, aten.arange,
          aten.scalar_tensor, aten.empty_strided, aten.new_zeros,
          aten.new_empty, aten.new_full, aten.new_ones, aten.new_empty_strided,
          aten.randn, aten.rand, aten.repeat_interleave), _factory),
        ((aten.zeros_like, aten.empty_like, aten.ones_like, aten.full_like,
          aten.rand_like, aten.randn_like), _like),
):
    for _op in _ops:
        _RULES[_op] = _rule

_POINTWISE_NAMES = {
    "add", "sub", "mul", "div", "neg", "where", "maximum", "minimum", "pow",
    "exp", "log", "sqrt", "rsqrt", "tanh", "sigmoid", "silu", "gelu", "relu",
    "clamp", "clamp_min", "clamp_max", "eq", "ne", "lt", "le", "gt", "ge",
    "logical_and", "logical_or", "logical_not", "bitwise_and",
    "bitwise_or", "bitwise_not", "bitwise_right_shift", "bitwise_left_shift",
    "__rshift__", "__lshift__", "__and__", "__or__", "abs", "sign",
    "square", "masked_fill", "addcmul", "addcdiv", "cos", "sin", "softplus",
    "tril", "triu", "reciprocal", "exp2", "log1p", "expm1", "remainder",
    "fmod", "floor_divide", "round", "floor", "ceil", "lerp", "erf",
    "isnan", "isinf", "nan_to_num", "threshold", "hardtanh", "mish",
    "sgn", "atan2", "log2", "trunc", "frac", "xlogy", "copysign", "rsub",
    "flip", "roll", "bitwise_xor", "logical_xor", "sigmoid", "erfinv"}


def place_tree(an: StepAnalysis, tree, spec_tree) -> int:
    """Lay out every leaf of ``tree`` as its spec in ``spec_tree`` (same
    structure, ``sharding.P`` leaves); returns the local bytes of them
    all (the cell's share of ``argument_size_in_bytes``)."""
    from repro_torch.distributed.sharding import tree_flatten_with_path
    leaves = tree_flatten_with_path(tree)
    specs = tree_flatten_with_path(spec_tree)
    if [p for p, _ in leaves] != [p for p, _ in specs]:
        raise ValueError("a spec tree of another structure")
    total = 0
    for (_, t), (_, s) in zip(leaves, specs):
        an.place(t, s)
        total += an.local_bytes(t)
    return total
