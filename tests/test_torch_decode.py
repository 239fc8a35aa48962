"""K2 and K2-q, the paged decode walk of the port: its launch planner, the
arithmetic of its design (context splits merged in rank order, one
softmax update a block, the per-block skip of the quantized lane) written
here in plain torch against the plain version and the JAX package's Pallas
kernel in interpret mode, and the pool invariant the skip relies on. The
kernel itself runs only on a card
(``test_torch_kernels.py::test_cuda_kernels_match_plain_versions`` and
``chip_smoke.py``).

Tolerance: float32 throughout, rtol = atol = 2e-5 (the JAX package's own
kernel tolerance): torch and XLA, and a split walk and a whole one, sum
the softmax in different orders. The skip's dequant is compared exactly.
"""
import collections
import inspect

import numpy as np
import pytest
import torch
from torch_parity import ORDER, llama_params, serving, tcfg, to_np

from repro.kernels import paged_attention as jpa
from repro_torch.configs import MORPH_LLAMA2_7B
from repro_torch.engine.kv_cache import PagedKVPool
from repro_torch.kernels import plan, ref
from repro_torch.kernels import paged_attention as k2

TOL = dict(rtol=2e-5, atol=2e-5)
SIZES = {"float32": 4, "bfloat16": 2, "float16": 2}


# ---------------------------------------------------------------------------
# the launch planner
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("G", [1, 4, 6, 12])
@pytest.mark.parametrize("Dh", [32, 64, 128, 256])
def test_decode_plan_sizes_the_splits(G, Dh):
    """For B 1..8 and table widths 1..128 (bs 16, float32 and bf16 pools):
    a row takes one split for each ``blocks_per_split`` visible blocks (at
    least ``DECODE_MIN_BLOCKS``, the plan's ``min_blocks``), at most
    ``splits`` (at most 16, enough for a row that fills the table unless
    capped), so that rows half as long as the table give no more than four
    CTAs an SM; the grid has one
    CTA per (split, kv head, sequence); the ring holds 2..3 stages of one
    block's K and V rows (the int8 rows of the quantized lane lie over
    them), and the regions fit the 227 KB a block may opt into."""
    KVH = 8 if G > 1 else 32
    cap = plan.DECODE_MAX_PER_SM * plan.N_SM
    for kv_dtype in ("float32", "bfloat16"):
        for B in range(1, 9):
            for nb_t in range(1, 129):
                p = plan.decode_plan(B=B, H=G * KVH, KVH=KVH, Dh=Dh, bs=16,
                                     nb_t=nb_t, q_dtype="bfloat16",
                                     kv_dtype=kv_dtype)
                S, bps = p.splits, p.blocks_per_split
                assert (S, bps) == plan.decode_splits(B, KVH, nb_t)
                assert 1 <= S <= plan.DECODE_MAX_SPLITS == 16
                assert bps >= plan.DECODE_MIN_BLOCKS
                assert S == max(1, min(16, -(-nb_t // bps),
                                       nb_t // plan.DECODE_MIN_BLOCKS))
                assert p.min_blocks == plan.DECODE_MIN_BLOCKS <= bps
                half = -(-nb_t // 2)
                assert B * KVH * min(S, -(-half // bps)) <= max(cap, B * KVH)
                assert p.grid == (S, KVH, B)
                assert 2 <= p.stages <= max(2, min(plan.DECODE_MAX_STAGES,
                                                   bps + 1))
                assert p.stage_bytes == 2 * 16 * Dh * SIZES[kv_dtype]
                assert 2 * 16 * Dh <= p.stage_bytes      # int8 K and V rows
                lay = plan.decode_layout(G, Dh, 16, kv_dtype, S, p.stages,
                                         p.window)
                assert lay == {k: getattr(p, k) for k in lay}
                assert p.smem == p.off_ring + p.stages * p.stage_bytes
                assert p.smem <= plan.SMEM_LIMIT == 232_448
                assert p.off_rec - p.off_tab >= 4 * p.window
                assert p.off_bar - p.off_rec == 16 * p.window
                for k in ("off_acc", "off_s", "off_p", "off_row", "off_tab",
                          "off_rec", "off_bar"):
                    assert getattr(p, k) % 16 == 0, k
                assert p.off_ring % 128 == 0 and p.stage_bytes % 256 == 0
                assert p.off_ring >= p.off_bar + 8 * p.stages
                c = plan.c_decode_plan(p)
                assert [getattr(c, f) for f, _ in c._fields_] == \
                    list(p.__dict__.values())[:-1]


def test_decode_plan_reads_no_lengths():
    """The planner takes host integers only, and the wrapper plans the same
    launch whatever the live lengths: it never reads ``lens`` (no host sync
    on the step path). B=1 at 32 heads over a 128-wide table: a row may
    take 16 splits of 4 blocks, a grid of 512 CTAs."""
    params = set(inspect.signature(plan.decode_plan).parameters)
    assert params == {"B", "H", "KVH", "Dh", "bs", "nb_t", "q_dtype",
                      "kv_dtype", "window", "n_sm"}
    p = plan.decode_plan(B=1, H=32, KVH=32, Dh=128, bs=16, nb_t=128,
                         q_dtype="bfloat16", kv_dtype="float32")
    assert (p.splits, p.blocks_per_split) == (16, 4)
    assert np.prod(p.grid) == 512
    # a window of 64 tokens spans at most 5 blocks of 16: its splits are
    # sized over those, not over the table
    pw = plan.decode_plan(B=8, H=32, KVH=32, Dh=128, bs=16, nb_t=256,
                          q_dtype="bfloat16", kv_dtype="float32", window=64)
    assert (pw.splits, pw.blocks_per_split) == plan.decode_splits(8, 32, 5)
    seen = []
    orig = plan.decode_plan

    def spy(**kw):
        seen.append(kw)
        return orig(**kw)
    q = torch.zeros((2, 4, 32))
    kp = torch.zeros((5, 8, 2, 32))
    tables = torch.tensor([[1, 2, 0], [3, 4, 0]], dtype=torch.int32)
    plan.decode_plan = spy
    try:
        for lens in ([9, 3], [16, 0]):
            with pytest.raises(ValueError, match="CUDA tensor"):
                k2.paged_decode(q, None, None, kp, kp, tables,
                                torch.tensor(lens, dtype=torch.int32),
                                scale=1.0, fused_new=False)
    finally:
        plan.decode_plan = orig
    assert len(seen) == 2 and seen[0] == seen[1]


@pytest.mark.parametrize("kw,msg", [
    (dict(Dh=96), "head dim"),
    (dict(q_dtype="float64"), "each takes"),
    (dict(kv_dtype="int8"), "each takes"),
    (dict(H=12, KVH=5), "multiple"),
    (dict(H=512, KVH=1, Dh=256), "shared memory"),
])
def test_decode_plan_refuses_what_is_not_built(kw, msg):
    """A width, dtype or head layout the decode walk is not built for (or
    whose rows do not fit its shared memory) has no plan; the wrapper
    refuses it before the device check."""
    args = dict(B=2, H=8, KVH=2, Dh=128, bs=16, nb_t=8, q_dtype="bfloat16",
                kv_dtype="float32")
    args.update(kw)
    with pytest.raises(ValueError, match=msg):
        plan.decode_plan(**args)
    if msg in ("head dim", "shared memory"):
        q = torch.zeros((1, args["H"], args["Dh"]))
        kp = torch.zeros((3, 16, args["KVH"], args["Dh"]))
        with pytest.raises(ValueError, match=msg):
            k2.paged_decode(q, None, None, kp, kp,
                            torch.ones((1, 2), dtype=torch.int32),
                            torch.ones((1,), dtype=torch.int32), scale=1.0,
                            fused_new=False)


def test_nb_buckets():
    """``launches_by_nb`` keys: the power of two at or above the table
    width, the engine's own table buckets."""
    assert [k2.nb_bucket(n) for n in (1, 2, 3, 4, 9, 32, 33, 64, 65)] == \
        ["1", "2", "4", "4", "16", "32", "64", "64", ">64"]
    assert isinstance(k2.paged_decode.launches_by_nb, collections.Counter)
    assert isinstance(k2.paged_decode.quant_launches_by_nb,
                      collections.Counter)


# ---------------------------------------------------------------------------
# the design's arithmetic in plain torch
# ---------------------------------------------------------------------------
def _block_rows(pool, qpool, scale, zero, blk, h, quantized):
    """One pool block's rows of kv head h as the skip reads them: the int8
    mirror dequantized (q * scale, then + zero) where the block's scale is
    non-zero, else the fp slot alone."""
    if quantized:
        return qpool[blk, :, h].float() * scale[blk] + zero[blk]
    return pool[blk, :, h].float()


def _merge(parts, G, Dh):
    """Partials (m, l, acc) merged in order with weights exp(m_r - M)."""
    M = torch.stack([m for m, _, _ in parts]).max(0).values
    L = torch.zeros(G)
    A = torch.zeros((G, Dh))
    for m, l, acc in parts:
        w = torch.exp(m - M)
        L = L + l * w
        A = A + acc * w[:, None]
    return M, L, A


def split_decode(q, k_new, v_new, k_pool, v_pool, tables, lens, *, splits,
                 bps, min_blocks=1, scale, window=0, softcap=0.0,
                 fused_new=True, kv_quant=None):
    """The decode walk as the kernel computes it, in plain torch: each
    (sequence, kv head) row takes one split for each ``bps`` of its visible
    blocks (below its length, inside its window), at most ``splits`` and at
    most one for each ``min_blocks`` of them, at least one, and each split
    walks an even share, with one max, one
    correction and one sum a block and row; the fused token is folded in
    by the split that holds the last visible block (split 0 when none is,
    whose partial is then the token alone, or empty); the partials merge
    in rank order with weights exp(m_r - M)."""
    B, H, Dh = q.shape
    bs, KVH = k_pool.shape[1], k_pool.shape[2]
    G = H // KVH
    nb_t = tables.shape[1]
    out = torch.zeros((B, H, Dh))

    def rows(pool, b, nb, h, quant):
        blk = int(tables[b, nb])
        if kv_quant is None:
            return pool[blk, :, h].float()
        qpool, scale_row, zero_row = quant
        return _block_rows(pool, qpool, scale_row, zero_row, blk, h,
                           bool(scale_row[blk] != 0))

    for b in range(B):
        ctx = int(lens[b])
        qpos = ctx if fused_new else ctx - 1
        n_blocks = min(nb_t, -(-ctx // bs))
        first = min((qpos - window + 1) // bs, n_blocks) \
            if window > 0 and qpos - window + 1 > 0 else 0
        live = n_blocks - first
        n_split = max(1, min(splits, -(-live // bps), live // min_blocks))
        per = -(-live // n_split)
        fold = (live - 1) // per if live > 0 else 0
        for h in range(KVH):
            qf = q[b, h * G:(h + 1) * G].float()

            def walk(s):
                state = [torch.full((G,), -1e30), torch.zeros(G),
                         torch.zeros((G, Dh))]

                def update(k, v):
                    m, l, acc = state
                    sc = qf @ k.T * scale
                    if softcap:
                        sc = torch.tanh(sc / softcap) * softcap
                    m_new = torch.maximum(m, sc.max(-1).values)
                    corr = torch.exp(m - m_new)
                    p = torch.exp(sc - m_new[:, None])
                    state[:] = [m_new, l * corr + p.sum(-1),
                                acc * corr[:, None] + p @ v]
                lo_s = first + s * per
                for nb in range(lo_s, min(n_blocks, lo_s + per)):
                    base = nb * bs
                    lo = max(0, qpos - window + 1 - base) if window else 0
                    hi = min(bs, ctx - base)
                    if hi <= lo:
                        continue
                    k = rows(k_pool, b, nb, h, None if kv_quant is None else
                             (kv_quant[0], kv_quant[2], kv_quant[4]))
                    v = rows(v_pool, b, nb, h, None if kv_quant is None else
                             (kv_quant[1], kv_quant[3], kv_quant[5]))
                    update(k[lo:hi], v[lo:hi])
                if fused_new and s == fold:
                    update(k_new[b, h][None].float(),
                           v_new[b, h][None].float())
                return tuple(state)

            parts = [walk(s) for s in range(n_split)]
            _, L, A = _merge(parts, G, Dh)         # rank order
            out[b, h * G:(h + 1) * G] = A / torch.clamp(L, min=1e-30)[:, None]
    return out


def _decode_inputs(seed, B, H, KVH, Dh, bs, lens, nb):
    """Pools whose live blocks have globally distinct ids (the engine's
    ownership contract; padding entries are scratch 0), q and the new
    token, all float32 numpy."""
    rng = np.random.default_rng(seed)
    need = [-(-int(n) // bs) for n in lens]
    cap = sum(need) + 2
    kp = rng.standard_normal((cap, bs, KVH, Dh)).astype(np.float32)
    vp = rng.standard_normal((cap, bs, KVH, Dh)).astype(np.float32)
    perm = rng.permutation(np.arange(1, cap))
    tables = np.zeros((B, nb), np.int32)
    o = 0
    for b, n in enumerate(need):
        tables[b, :n] = perm[o:o + n]
        o += n
    q = rng.standard_normal((B, H, Dh)).astype(np.float32)
    kn = rng.standard_normal((B, KVH, Dh)).astype(np.float32)
    vn = rng.standard_normal((B, KVH, Dh)).astype(np.float32)
    return q, kn, vn, kp, vp, tables, np.asarray(lens, np.int32)


def _mixed_bundle(kp, vp, tables, lens, bs):
    """Quantize every other full block of each sequence through the port's
    pool (``quantize_blocks``, int8): the fp pools with those slots zeroed
    and the layer's bundle, as numpy."""
    cap, _, KVH, Dh = kp.shape
    cfg = MORPH_LLAMA2_7B.replace(n_layers=1, n_kv_heads=KVH, n_heads=KVH,
                                  d_model=KVH * Dh)
    pool = PagedKVPool(cfg, cap, bs, bucket_capacity=False, device="cpu")
    pool.k[0].copy_(torch.from_numpy(kp))
    pool.v[0].copy_(torch.from_numpy(vp))
    qids = sorted({int(tables[b, j]) for b in range(len(lens))
                   for j in range(0, int(lens[b]) // bs, 2)})
    assert qids and pool.quantize_blocks(qids, bits=8)
    bundle = tuple(to_np(t[0]) for t in pool.kv_quant_bundle())
    return to_np(pool.k[0]), to_np(pool.v[0]), bundle


# (H, KVH): G = 1, 4, 6 and 12
HEADS = [(2, 2), (8, 2), (12, 2), (12, 1)]
@pytest.mark.parametrize("H,KVH", HEADS)
@pytest.mark.parametrize("splits", [1, 2, 3, 8])
def test_split_walk_matches_plain_and_pallas(H, KVH, splits):
    """The split walk and its rank-order merge against the plain version
    and the JAX Pallas kernel in interpret mode, fused and not, without and
    with a bundle that mixes fp and quantized blocks, over an 8-wide table
    of bs-4 blocks, one block a split: the longest row takes all of up to
    8 splits, shorter ones fewer (the third sequence lives in one block),
    and a window of 5 leaves two or three visible blocks a row."""
    bs, Dh, nb = 4, 32, 8
    lens = [29, 14, 3]
    q, kn, vn, kp, vp, tables, lens = _decode_inputs(
        7 * H + KVH + splits, 3, H, KVH, Dh, bs, lens, nb)
    for window, softcap, scale in ((0, 0.0, Dh ** -0.5), (5, 20.0, 0.3)):
        for quant in (False, True):
            kpq, vpq, bundle = (_mixed_bundle(kp, vp, tables, lens, bs)
                                if quant else (kp, vp, None))
            tb = None if bundle is None else tuple(
                torch.from_numpy(a) for a in bundle)
            for fused in (True, False):
                args = [torch.from_numpy(a) for a in
                        (q, kn, vn, kpq, vpq, tables, lens)]
                kw = dict(scale=scale, window=window, softcap=softcap,
                          fused_new=fused, kv_quant=tb)
                got = split_decode(*args, splits=splits, bps=1, **kw)
                want = ref.paged_decode_ref(*args, **kw)
                np.testing.assert_allclose(to_np(got), to_np(want), **TOL)
                jkw = dict(window=window, softcap=softcap, scale=scale,
                           interpret=True, kv_quant=bundle)
                if fused:
                    jax_out = jpa.paged_attention_fused(
                        q, kn, vn, kpq, vpq, tables, lens, **jkw)
                else:
                    jax_out = jpa.paged_attention(q, kpq, vpq, tables, lens,
                                                  **jkw)
                np.testing.assert_allclose(to_np(got), np.asarray(jax_out),
                                           **TOL)


@pytest.mark.parametrize("H,KVH", HEADS)
def test_split_walk_at_the_planned_splits(H, KVH):
    """At the splits the planner gives a 16-wide table of bs-8 blocks
    (ragged rows that take 1 to 4 splits, an idle slot of length 0 whose
    one split holds only the fused token), the split walk equals the plain
    version, and a zeroed bundle takes the fp path of every block: the same
    result, bit for bit."""
    bs, Dh, nb = 8, 32, 16
    lens = [120, 57, 0, 9, 64, 1]
    q, kn, vn, kp, vp, tables, lens = _decode_inputs(H + KVH, 6, H, KVH, Dh,
                                                    bs, lens, nb)
    p = plan.decode_plan(B=6, H=H, KVH=KVH, Dh=Dh, bs=bs, nb_t=nb,
                         q_dtype="float32", kv_dtype="float32", n_sm=32)
    assert p.splits > 1
    args = [torch.from_numpy(a) for a in (q, kn, vn, kp, vp, tables, lens)]
    kw = dict(scale=Dh ** -0.5, fused_new=True)
    got = split_decode(*args, splits=p.splits, bps=p.blocks_per_split,
                       min_blocks=p.min_blocks, **kw)
    np.testing.assert_allclose(
        to_np(got), to_np(ref.paged_decode_ref(*args, **kw)), **TOL)
    zero = (torch.zeros(kp.shape, dtype=torch.int8),) * 2 + \
        (torch.zeros(kp.shape[0]),) * 4
    again = split_decode(*args, splits=p.splits, bps=p.blocks_per_split,
                         min_blocks=p.min_blocks, kv_quant=zero, **kw)
    assert torch.equal(got, again)


# ---------------------------------------------------------------------------
# the skip and the pool invariant it relies on
# ---------------------------------------------------------------------------
def _check_invariant(pool, what):
    """A block whose scale row is non-zero has an all-zero fp slot; a block
    whose scale row is zero has a zero ``zero`` row (per layer, k and v)."""
    if pool.qk is None:
        return
    for fp, s, z, name in ((pool.k, pool.k_scale, pool.k_zero, "k"),
                           (pool.v, pool.v_scale, pool.v_zero, "v")):
        quantized = s != 0
        slot_nonzero = fp.flatten(2).ne(0).any(-1)
        assert not bool((quantized & slot_nonzero).any()), \
            f"{what}: a quantized {name} block has a non-zero fp slot"
        assert not bool(((~quantized) & (z != 0)).any()), \
            f"{what}: an fp {name} block has a non-zero zero row"


def _skip_equals_fma(pool, what):
    """The skip's rows equal the FMA's (fp + q * scale + zero) exactly, for
    every block and layer of the pool."""
    if pool.qk is None:
        return
    e = (slice(None), slice(None), None, None, None)
    for fp, qm, s, z in ((pool.k, pool.qk, pool.k_scale, pool.k_zero),
                         (pool.v, pool.qv, pool.v_scale, pool.v_zero)):
        fma = fp.float() + qm.float() * s[e] + z[e]
        skip = torch.where((s != 0)[e], qm.float() * s[e] + z[e], fp.float())
        assert torch.equal(fma, skip), what


def test_skip_equals_fma_under_every_pool_operation():
    """Quantize (int8 and int4), dequantize, clear (the block-free choke
    point, which leaves the stale int8 payload), move (tail compaction) and
    resize across capacity buckets, with fresh fp content written into
    freed blocks: after each, the pool keeps the invariant and the skip's
    dequant equals the branch-free FMA exactly."""
    cfg = tcfg()
    pool = PagedKVPool(cfg, 12, 16, device="cpu")
    rng = np.random.default_rng(4)

    def fill(ids):
        shape = (cfg.n_layers, len(ids), 16, pool.kvh, pool.dh)
        pool.scatter_blocks(list(ids),
                            rng.standard_normal(shape).astype(np.float32),
                            rng.standard_normal(shape).astype(np.float32))

    fill(range(1, 12))
    steps = [
        ("quantize int8", lambda: pool.quantize_blocks([1, 2, 5, 7], bits=8)),
        ("quantize int4", lambda: pool.quantize_blocks([3, 9], bits=4)),
        ("dequantize", lambda: pool.dequantize_blocks([2, 9])),
        ("clear_quant", lambda: pool.clear_quant([5, 4])),
        ("refill a cleared block", lambda: fill([5])),
        ("move_blocks", lambda: pool.move_blocks([7, 3, 6], [10, 11, 8])),
        ("grow across a bucket", lambda: pool.resize(40)),
        ("quantize after the grow", lambda: pool.quantize_blocks([20, 30])),
        ("shrink across a bucket", lambda: (pool.clear_quant([20, 30]),
                                            pool.resize(12))),
    ]
    for what, op in steps:
        op()
        _check_invariant(pool, what)
        _skip_equals_fma(pool, what)
    assert pool.qbits and pool.capacity == 16


def test_invariant_holds_through_the_engine_with_tier0_eviction():
    """The port's engine with the tier on, on a trace whose shared prefix
    is quantized and later evicted by the prefix cache's tier-0 relief
    (the path ``test_no_kv_write_lands_in_a_quantized_block`` takes): after
    every pool operation the invariant holds, and the skip's dequant equals
    the FMA."""
    from test_torch_kv_quant import _ecfg, _eviction_trace

    from repro_torch.configs import ServingConfig
    from repro_torch.engine import EngineConfig, KVQuantConfig
    from repro_torch.engine import MorphServeEngine
    from repro_torch.engine.cost_model import HardwareProfile
    from repro_torch.engine.traces import TraceRequest
    params, _, tparams = llama_params()
    eng = MorphServeEngine(tcfg(), tparams, serving(params, ServingConfig),
                           _ecfg(EngineConfig, KVQuantConfig, HardwareProfile,
                                 "requant"), swap_order=ORDER, device="cpu")
    pool = eng.pool
    calls = collections.Counter()
    for name in ("quantize_blocks", "dequantize_blocks", "clear_quant",
                 "move_blocks", "resize"):
        fn = getattr(pool, name)

        def run(*a, _fn=fn, _name=name, **kw):
            out = _fn(*a, **kw)
            calls[_name] += 1
            _check_invariant(pool, _name)
            _skip_equals_fma(pool, _name)
            return out
        setattr(pool, name, run)
    evicted = []
    evict = eng.prefix_cache.evict_lru

    def evict_lru(n):
        out = evict(n)
        evicted.extend(b for b in out if b in pool.qbits)
        return out
    eng.prefix_cache.evict_lru = evict_lru
    rep = eng.run_trace(_eviction_trace(TraceRequest))
    assert rep.n_finished == rep.n_requests == 6
    assert evicted, "the trace never evicted a quantized block"
    assert calls["quantize_blocks"] and calls["clear_quant"]
