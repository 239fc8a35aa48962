"""The port's kernel routes (plain versions on the CPU) against the JAX
package's oracles and its Pallas kernels in interpret mode; the wrappers'
input checks; and a parity test of the CUDA kernels, which needs a card.

Tolerance: float32 throughout; torch and XLA reduce the softmax sums and
the matmuls in different orders, so results agree to ~1e-6, not bit for
bit: rtol = atol = 2e-5 (the JAX package's own kernel tolerance).
"""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_parity import to_np

from repro.kernels import paged_attention as jpa
from repro.kernels import ref as jref
from repro_torch.kernels import AttentionSpec, ops, plan, ref
from repro_torch.kernels.paged_attention import paged_chunk, paged_decode
from repro_torch.kernels.wna16_gemm import wna16_gemm

TOL = dict(rtol=2e-5, atol=2e-5)
ROOT = Path(__file__).resolve().parents[1]


def _pools(rng, lens, KVH, Dh, bs, nb):
    """Random pools and block tables whose live ids are globally distinct
    (the engine's ownership contract); padding entries are scratch 0."""
    need = [-(-int(n) // bs) for n in lens]
    cap = sum(need) + 2
    kp = rng.standard_normal((cap, bs, KVH, Dh)).astype(np.float32)
    vp = rng.standard_normal((cap, bs, KVH, Dh)).astype(np.float32)
    perm = rng.permutation(np.arange(1, cap))
    tables = np.zeros((len(lens), nb), np.int32)
    o = 0
    for b, n in enumerate(need):
        tables[b, :n] = perm[o:o + n]
        o += n
    return kp, vp, tables


def _decode_case(seed, B, H, KVH, Dh, bs, nb):
    rng = np.random.default_rng(seed)
    lens = np.array([nb * bs - 1 - 5 * b for b in range(B)], np.int32)
    kp, vp, tables = _pools(rng, lens + 1, KVH, Dh, bs, nb)
    q = rng.standard_normal((B, H, Dh)).astype(np.float32)
    kn = rng.standard_normal((B, KVH, Dh)).astype(np.float32)
    vn = rng.standard_normal((B, KVH, Dh)).astype(np.float32)
    return q, kn, vn, kp, vp, tables, lens


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("H,KVH", [(4, 4), (4, 2), (12, 2), (12, 1)])
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (7, 0.0), (0, 25.0),
                                            (11, 25.0)])
@pytest.mark.parametrize("fused", [True, False])
def test_plain_decode_matches_jax(H, KVH, window, softcap, fused):
    """Plain paged decode (both modes) against the JAX gather oracles,
    across G in {1, 2, 6, 12}, window, softcap and ragged context lengths. The
    fused mode's pool read stops before the new token's slot, so the JAX
    xla lane (which reads it from the pool) must agree once it is there."""
    q, kn, vn, kp, vp, tables, lens = _decode_case(
        H * 7 + window + int(softcap) + fused, 3, H, KVH, 32, 8, 4)
    spec = AttentionSpec(window=window, softcap=softcap)
    tq, tkn, tvn, tkp, tvp, ttab, tlens = _t(q, kn, vn, kp, vp, tables, lens)
    if fused:
        got = ops.paged_decode_attention(tq, tkn, tvn, tkp, tvp, ttab, tlens,
                                         spec)
        want = jref.paged_attention_ref(q, kp, vp, tables, lens,
                                        window=window, softcap=softcap,
                                        k_new=kn, v_new=vn)
        kp2, vp2 = kp.copy(), vp.copy()
        for b, n in enumerate(lens):       # the caller's append, for xla
            kp2[tables[b, n // 8], n % 8] = kn[b]
            vp2[tables[b, n // 8], n % 8] = vn[b]
        want2 = jpa.paged_gather_attention(q, kp2, vp2, tables, lens,
                                           window=window, softcap=softcap)
        np.testing.assert_allclose(to_np(got), np.asarray(want2), **TOL)
    else:
        got = ops.paged_attention(tq, tkp, tvp, ttab, tlens, spec)
        want = jref.paged_attention_ref(q, kp, vp, tables, lens,
                                        window=window, softcap=softcap)
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("fused", [True, False])
def test_plain_decode_matches_pallas_interpret(fused):
    """Against the JAX Pallas decode kernel in interpret mode, with an
    explicit non-default scale (the JAX xla lane drops the scale, so only
    the kernel can be the oracle for it), GQA, window and softcap."""
    q, kn, vn, kp, vp, tables, lens = _decode_case(21 + fused, 2, 4, 2, 32,
                                                   8, 4)
    spec = AttentionSpec(window=9, softcap=20.0, scale=0.3)
    tq, tkn, tvn, tkp, tvp, ttab, tlens = _t(q, kn, vn, kp, vp, tables, lens)
    kw = dict(window=9, softcap=20.0, scale=0.3, interpret=True)
    if fused:
        got = ops.paged_decode_attention(tq, tkn, tvn, tkp, tvp, ttab, tlens,
                                         spec)
        want = jpa.paged_attention_fused(q, kn, vn, kp, vp, tables, lens,
                                         **kw)
    else:
        got = ops.paged_attention(tq, tkp, tvp, ttab, tlens, spec)
        want = jpa.paged_attention(q, kp, vp, tables, lens, **kw)
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)


def _chunk_case(seed, C, H, KVH, Dh, bs, pos0):
    rng = np.random.default_rng(seed)
    nb = 1 << (-(-(pos0 + C) // bs) - 1).bit_length()
    kp, vp, tables = _pools(rng, [pos0 + C], KVH, Dh, bs, nb)
    q = rng.standard_normal((1, C, H, Dh)).astype(np.float32)
    kn = rng.standard_normal((1, C, KVH, Dh)).astype(np.float32)
    vn = rng.standard_normal((1, C, KVH, Dh)).astype(np.float32)
    pos = pos0 + np.arange(C)
    kp[tables[0, pos // bs], pos % bs] = kn[0]       # the caller's scatter
    vp[tables[0, pos // bs], pos % bs] = vn[0]
    return q, kn, vn, kp, vp, tables


@pytest.mark.parametrize("C,H,KVH,pos0", [(8, 4, 4, 16), (16, 4, 2, 13),
                                          (16, 4, 4, 0), (8, 12, 2, 5),
                                          (8, 12, 1, 5)])
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (9, 0.0), (9, 25.0)])
@pytest.mark.parametrize("fused", [True, False])
def test_plain_chunk_matches_jax(C, H, KVH, pos0, window, softcap, fused):
    """Plain chunk prefill (both modes) against the JAX gather oracle
    ``paged_chunk_gather_attention``, across G in {1, 2, 6, 12} (at 6 and
    12 a row tile of the chunk kernel spans tokens at a fractional
    boundary), window, softcap and (un)aligned offsets. The fused mode reads the pool only below pos0,
    so scrubbing the chunk's own slots must not change its result."""
    q, kn, vn, kp, vp, tables = _chunk_case(C * H + pos0 + window + fused,
                                            C, H, KVH, 32, 8, pos0)
    want = jpa.paged_chunk_gather_attention(q, kp, vp, tables, pos0,
                                            window=window, softcap=softcap)
    spec = AttentionSpec(window=window, softcap=softcap)
    if fused:
        pos = pos0 + np.arange(C)
        kp[tables[0, pos // 8], pos % 8] = 99.0     # scrub: never read
        vp[tables[0, pos // 8], pos % 8] = 99.0
    tq, tkn, tvn, tkp, tvp, ttab = _t(q, kn, vn, kp, vp, tables)
    got = ops.paged_prefill_attention(
        tq, tkp, tvp, ttab, pos0, spec, k_new=tkn if fused else None,
        v_new=tvn if fused else None)
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("fused", [True, False])
def test_plain_chunk_matches_pallas_interpret(fused):
    """Against the JAX Pallas chunk kernel in interpret mode, with an
    explicit scale, GQA, window and softcap at an unaligned offset."""
    q, kn, vn, kp, vp, tables = _chunk_case(31 + fused, 8, 4, 2, 32, 8, 11)
    kw = dict(window=6, softcap=20.0, scale=0.25)
    if fused:
        want = jpa.paged_chunk_attention_fused(q, kn, vn, kp, vp, tables, 11,
                                               interpret=True, **kw)
    else:
        want = jpa.paged_chunk_attention(q, kp, vp, tables, 11,
                                         interpret=True, **kw)
    tq, tkn, tvn, tkp, tvp, ttab = _t(q, kn, vn, kp, vp, tables)
    got = ops.paged_prefill_attention(
        tq, tkp, tvp, ttab, 11, AttentionSpec(**kw),
        k_new=tkn if fused else None, v_new=tvn if fused else None)
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)


def test_wrappers_reject_bad_inputs():
    """The CUDA wrappers check dtype, shape and device before launching;
    on a CPU tensor they raise rather than fall back."""
    x = torch.zeros((2, 64), dtype=torch.bfloat16)
    packed = torch.zeros((32, 64), dtype=torch.uint8)
    sz = torch.zeros((2, 64), dtype=torch.float32)
    with pytest.raises(ValueError, match="packed must be uint8"):
        wna16_gemm(x, packed.to(torch.int8), sz, sz, bits=4, group=32)
    with pytest.raises(ValueError, match="packed"):
        wna16_gemm(x, packed[:16], sz, sz, bits=4, group=32)
    with pytest.raises(ValueError, match="x dtype"):
        wna16_gemm(x.to(torch.int32), packed, sz, sz, bits=4, group=32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        wna16_gemm(x, packed, sz, sz, bits=4, group=32)
    q = torch.zeros((2, 4, 32))
    kp = torch.zeros((5, 8, 2, 32))
    tables = torch.zeros((2, 2), dtype=torch.int32)
    lens = torch.ones((2,), dtype=torch.int32)
    with pytest.raises(ValueError, match="tables must be int32"):
        paged_decode(q, None, None, kp, kp, tables.long(), lens, scale=1.0,
                     fused_new=False)
    with pytest.raises(ValueError, match="head dim"):
        kp16 = kp[..., :16].contiguous()
        paged_decode(q[..., :16].contiguous(), None, None, kp16, kp16,
                     tables, lens, scale=1.0, fused_new=False)
    with pytest.raises(ValueError, match="pool's dtype"):
        paged_decode(q, torch.zeros((2, 2, 32), dtype=torch.float64),
                     torch.zeros((2, 2, 32), dtype=torch.float64), kp, kp,
                     tables, lens, scale=1.0)
    with pytest.raises(ValueError, match="CUDA tensor"):
        paged_decode(q, None, None, kp, kp, tables, lens, scale=1.0,
                     fused_new=False)
    with pytest.raises(ValueError, match="CUDA tensor"):
        paged_chunk(q[None], None, None, kp, kp, tables[:1], 0, scale=1.0,
                    fused_new=False)


def test_decode_wrapper_takes_any_g():
    """The decode wrapper no longer refuses G > 8: at G = 12 (Command R+'s
    96 / 8 layout, here 12 / 1) and G = 6 a CPU tensor gets as far as the
    device check, with and without a quantized-KV bundle."""
    for H, KVH in ((12, 1), (12, 2)):
        q = torch.zeros((2, H, 32))
        kp = torch.zeros((5, 8, KVH, 32))
        tables = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
        lens = torch.full((2,), 9, dtype=torch.int32)
        kvq = (torch.zeros(kp.shape, dtype=torch.int8),) * 2 + (
            torch.zeros(5),) * 4
        for bundle in (None, kvq):
            with pytest.raises(ValueError, match="CUDA tensor"):
                paged_decode(q, None, None, kp, kp, tables, lens, scale=1.0,
                             fused_new=False, kv_quant=bundle)
            with pytest.raises(ValueError, match="CUDA tensor"):
                paged_chunk(q[:, None], None, None, kp, kp, tables, 3,
                            scale=1.0, fused_new=False, kv_quant=bundle)


# the planned bytes of the main path's instantiations (held against the
# built libraries on the card by chip_smoke.py's plan check)
PLANNED_SMEM = {(128, 128, "float32", False): (64, 168_960),
                (128, 128, "float32", True): (64, 207_872),
                (256, 256, "float32", True): (16, 151_040),
                (576, 512, "float32", False): (16, 230_912),
                (576, 512, "bfloat16", False): (16, 194_048)}


@pytest.mark.parametrize("Dh,Dv", [(d, d) for d in plan.HEAD_DIMS]
                         + list(plan.LATENT_DIMS))
def test_chunk_plans_fit_the_card(Dh, Dv):
    """Every (q dtype, pool dtype, quantized lane) the chunk wrappers admit
    at this width has a plan that fits the 227 KB a block may opt into:
    64-row tiles over the C * G rows of each (kv head, sequence), a key
    tile of 16-64 that both lanes of a width share (so a zeroed sidecar
    reproduces the plain lane), one mma a product for bf16 q and for
    float32 and float16 q one more for each float32 operand, and 8 warps
    (two to each 16-row slice)."""
    latent = Dv != Dh
    H, KVH = (128, 1) if latent else (96, 8)
    for qd in ("float32",) if latent else plan.DTYPES:
        for kd in plan.LATENT_POOL_DTYPES if latent else plan.DTYPES:
            tiles = set()
            for kvq in (False,) if latent else (False, True):
                p = plan.chunk_plan(B=3, C=100, H=H, KVH=KVH, Dh=Dh, Dv=Dv,
                                    q_dtype=qd, kv_dtype=kd, kvq=kvq)
                assert p.smem <= plan.SMEM_LIMIT == 232_448
                assert p.row_tile == 64
                assert p.grid == (-(-100 * (H // KVH) // 64), KVH, 3)
                kv = int(kd == "float32" or kvq)
                assert (p.score_passes, p.value_passes) == (
                    (1, 1) if qd == "bfloat16"
                    else (1 + (qd == "float32") + kv, 2 + kv))
                assert p.threads == 256
                assert p.smem == plan.chunk_smem(Dh, Dv, p.key_tile, kd, kvq)
                want = PLANNED_SMEM.get((Dh, Dv, kd, kvq))
                if want is not None:
                    assert (p.key_tile, p.smem) == want
                tiles.add(p.key_tile)
            assert len(tiles) == 1 and tiles <= {16, 32, 64}
            bn = tiles.pop()
            if bn < 64:      # the next larger tile would not fit
                assert plan.chunk_smem(Dh, Dv, 2 * bn, kd,
                                       not latent) > plan.SMEM_LIMIT


@pytest.mark.parametrize("q_dtype,kv_dtype,kvq,Dv,want", [
    ("bfloat16", "float32", False, 128, (1, 1)),   # K3 on the main path
    ("bfloat16", "float32", True, 128, (1, 1)),    # K3-q
    ("float32", "float32", False, 512, (3, 3)),    # K3-mla, float32 pool
    ("float32", "bfloat16", False, 512, (2, 2)),   # K3-mla, bf16 pool
    ("float16", "float32", False, 128, (2, 3)),
    ("float16", "float16", True, 128, (2, 3)),
])
def test_chunk_passes_count_split_operands(q_dtype, kv_dtype, kvq, Dv, want):
    """The tensor-core passes of Q K^T and P V: big.big plus one mma for
    each operand split in two (3xTF32) — a float32 q, P and a float32 or
    dequantized pool where the output is float32 or float16; a 16-bit
    operand is exact and never split."""
    Dh = 576 if Dv == 512 else Dv
    p = plan.chunk_plan(B=1, C=16, H=128 if Dv == 512 else 8,
                        KVH=1 if Dv == 512 else 2, Dh=Dh, Dv=Dv,
                        q_dtype=q_dtype, kv_dtype=kv_dtype, kvq=kvq)
    assert (p.score_passes, p.value_passes) == want


@pytest.mark.parametrize("kw,msg", [
    (dict(Dh=96, Dv=96), "head dim"),
    (dict(q_dtype="float64"), "each takes"),
    (dict(kv_dtype="int8"), "each takes"),
    (dict(H=12, KVH=5), "multiple"),
    (dict(Dh=576, Dv=256, H=128, KVH=1, q_dtype="float32"), "latent width"),
    (dict(Dh=576, Dv=512, H=128, KVH=1), "float32 q"),
    (dict(Dh=576, Dv=512, H=128, KVH=1, q_dtype="float32",
          kv_dtype="float16"), "pool dtype"),
    (dict(Dh=576, Dv=512, H=128, KVH=1, q_dtype="float32", kvq=True),
     "no sidecar"),
])
def test_chunk_plan_refuses_what_is_not_built(kw, msg):
    """A width, dtype or lane the chunk kernels are not instantiated for
    has no plan: the planner raises before any device check."""
    args = dict(B=1, C=16, H=8, KVH=2, Dh=128, Dv=128, q_dtype="bfloat16",
                kv_dtype="float32", kvq=False)
    args.update(kw)
    with pytest.raises(ValueError, match=msg):
        plan.chunk_plan(**args)


def test_routes_pick_by_device():
    """A CPU tensor takes the plain version; a device with no kernel route
    raises instead of being moved anywhere."""
    q, kn, vn, kp, vp, tables, lens = _t(*_decode_case(3, 1, 4, 2, 32, 8, 2))
    got = ops.paged_decode_attention(q, kn, vn, kp, vp, tables, lens)
    want = ref.paged_decode_ref(q, kn, vn, kp, vp, tables, lens)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="no kernel route"):
        ops.paged_decode_attention(q.to("meta"), kn, vn, kp, vp, tables, lens)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_repro():
    """No module of the port, and not chip_smoke.py, imports jax or the JAX
    package (the two meet only in these tests)."""
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    for f in files:
        for name in _imports(f):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (f, name)


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions():
    """Each CUDA kernel against its plain version on the card (small
    shapes; chip_smoke.py runs the main path's shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode")
    dev = "cuda"
    for H, KVH in ((4, 2), (12, 1)):     # G = 2 and 12
        q, kn, vn, kp, vp, tables, lens = [
            t.to(dev) for t in _t(*_decode_case(5, 3, H, KVH, 32, 8, 4))]
        for fused in (True, False):
            kw = dict(scale=0.2, window=7, softcap=20.0, fused_new=fused)
            a = paged_decode(q, kn if fused else None, vn if fused else None,
                             kp, vp, tables, lens, **kw)
            b = ref.paged_decode_ref(q, kn, vn, kp, vp, tables, lens, **kw)
            torch.testing.assert_close(a, b, **TOL)
    q, kn, vn, kp, vp, tables = [
        t.to(dev) for t in _t(*_chunk_case(6, 16, 4, 2, 32, 8, 13))]
    for fused in (True, False):
        kw = dict(scale=0.2, window=9, softcap=20.0, fused_new=fused)
        a = paged_chunk(q, kn if fused else None, vn if fused else None, kp,
                        vp, tables, 13, **kw)
        b = ref.paged_chunk_ref(q, kn, vn, kp, vp, tables, 13, **kw)
        torch.testing.assert_close(a, b, **TOL)
    from repro_torch.quant import quantize_tensor
    gen = torch.Generator(device=dev).manual_seed(9)
    act = torch.rand((256,), generator=gen, device=dev) + 0.5
    for bits in (4, 8):
        for scale in (None, act):       # without and with AWQ inv_act
            qt = quantize_tensor(
                torch.randn((256, 128), generator=gen, device=dev) * 0.05,
                bits=bits, group=64, act_scale=scale)
            bias = None if scale is None else torch.randn(
                (128,), generator=gen, device=dev)
            for M in (1, 5, 12, 17, 256):   # row tiles of 8, 16 and 64
                x = torch.randn((M, 256), generator=gen, device=dev)
                args = (x, qt.packed, qt.scales, qt.zeros, qt.inv_act, bias)
                torch.testing.assert_close(
                    wna16_gemm(*args, bits=bits, group=64),
                    ref.wna16_ref(*args, bits=bits, group=64), **TOL)
