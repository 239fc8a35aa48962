"""K1, the wNa16 GEMM of the port: its launch planner, the per-group
arithmetic its tensor-core kernel does (written here in plain torch)
against the plain version and the JAX package's kernel in interpret mode,
and the M buckets of its launch counter. The kernel itself runs only on a
card (``test_torch_kernels.py::test_cuda_kernels_match_plain_versions``
and ``chip_smoke.py``).

Tolerances are chip_smoke.py's ``TOL`` for the output dtype, elementwise:
|got - want| <= rtol * |want| + atol * max|want|.
"""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.wna16_gemm import wna16_gemm as jax_wna16_gemm
from repro_torch.kernels import ref
from repro_torch.kernels import wna16_gemm as k1
from repro_torch.quant import pack as packing
from repro_torch.quant import quantize_tensor

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

# every (K, N, bits) the main path gives K1 (Llama-2-7B's and DeepSeek-V3's
# matmuls of a swapped layer); its quantisation group is 128
MAIN_PATH = sorted({(K, N, bits) for K, N, bits, *_ in
                    chip_smoke.WNA16_CASES})
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def _passes(x_dtype: str, inv_act: bool) -> int:
    return 3 if x_dtype == "float32" else (2 if inv_act else 1)


@pytest.mark.parametrize("K,N,bits", MAIN_PATH)
def test_plan_writes_every_tile_once(K, N, bits):
    """For every M from 1 to 1024, x dtype and inv_act: the grid covers
    each output row and column in exactly one tile, each split of K is
    whole groups and not empty, the splits cover K once, the pass count
    follows the x dtype and inv_act, and the ring, its regions and the
    split-reduce tile fit the launch's shared memory."""
    G = K // 128
    for M in range(1, 1025):
        for x_dtype in k1.DTYPES:
            for inv in (False, True):
                p = k1.plan(M, K, N, bits=bits, group=128, x_dtype=x_dtype,
                            inv_act=inv)
                gx, gy, gz = p.grid
                assert (gx - 1) * k1.BN < N <= gx * k1.BN
                assert (gy - 1) * p.bm < M <= gy * p.bm
                assert gz == p.splits <= k1.MAX_SPLITS
                assert (p.splits - 1) * p.groups_per_split < G \
                    <= p.splits * p.groups_per_split
                assert p.passes == _passes(x_dtype, inv)
                assert p.bm == (8 if M <= 8 else 16 if M <= 16 else 64)
                size = DTYPES[x_dtype].itemsize
                pk = (64 if bits == 4 else 128) * k1.BN
                assert p.x_stride >= 128 * size
                assert p.off_pk >= p.bm * 128 * size
                assert p.off_s - p.off_pk >= pk
                assert p.off_z - p.off_s == p.off_inv - p.off_z == k1.BN * 4
                assert p.stage_bytes - p.off_inv == (512 if inv else 0)
                assert 2 <= p.stages <= max(2, min(4, p.groups_per_split + 1))
                assert p.splits in (1, 2, 4, 8)
                assert p.stages * p.stage_bytes <= p.smem <= k1.SMEM_LIMIT
                assert p.bm * k1.RED_STRIDE * 4 <= p.smem
                for v in (p.x_stride, p.pk_stride, p.off_pk, p.off_s,
                          p.off_z, p.off_inv, p.stage_bytes):
                    assert v % 16 == 0


def test_plan_tiles_cover_the_output_once():
    """The tiles of a few grids, enumerated: every output element lies in
    exactly one (N tile, M tile), and every group in one split."""
    for M, K, N in ((1, 4096, 11008), (17, 7168, 576), (300, 4096, 4096),
                    (1000, 512, 32768)):
        p = k1.plan(M, K, N, bits=4, group=128, x_dtype="bfloat16",
                    inv_act=False)
        hits = np.zeros((M, N), np.int32)
        groups = np.zeros(K // 128, np.int32)
        for bx in range(p.grid[0]):
            for by in range(p.grid[1]):
                hits[by * p.bm:(by + 1) * p.bm, bx * k1.BN:(bx + 1) * k1.BN] += 1
        for bz in range(p.grid[2]):
            g0 = bz * p.groups_per_split
            assert g0 < K // 128
            groups[g0:g0 + p.groups_per_split] += 1
        assert (hits == 1).all() and (groups == 1).all()


@pytest.mark.parametrize("x_dtype", list(DTYPES))
@pytest.mark.parametrize("inv", [False, True])
def test_plan_passes_follow_dtype_and_inv_act(x_dtype, inv):
    for M in (1, 9, 300):
        p = k1.plan(M, 4096, 4096, bits=4, group=64, x_dtype=x_dtype,
                    inv_act=inv)
        assert p.passes == _passes(x_dtype, inv)


@pytest.mark.parametrize("kw,msg", [
    (dict(bits=3), "bits=3 is not built"),
    (dict(group=256), "group=256 is not built"),
    (dict(group=24), "group=24 is not built"),
    (dict(group=16), "group=16 is not built"),
    (dict(K=4160), "must divide K=4160"),
    (dict(N=0), "N=0: no columns"),
    (dict(M=0), "M=0: nothing to launch"),
    (dict(x_dtype="float64"), "x dtype float64 is not built"),
])
def test_plan_refuses_what_is_not_built(kw, msg):
    args = dict(M=8, K=4096, N=4096, bits=4, group=128, x_dtype="bfloat16",
                inv_act=False)
    args.update(kw)
    with pytest.raises(ValueError, match=msg):
        k1.plan(args.pop("M"), args.pop("K"), args.pop("N"), **args)


def test_wrapper_refuses_unbuilt_shapes_on_any_device():
    """A shape the kernel lacks is refused by the planner before the
    device check, so a CPU tensor names the shape, not the device; it
    never reaches the plain version."""
    x = torch.zeros((2, 64), dtype=torch.bfloat16)
    qt = quantize_tensor(torch.randn((64, 16)), bits=4, group=16)
    with pytest.raises(ValueError, match="group=16 is not built"):
        k1.wna16_gemm(x, qt.packed, qt.scales, qt.zeros, bits=4, group=16)


# the SSM and hybrid matmuls (chip_smoke's ``SSM_KN``: N = 6448, 6482 and
# the others at their groups) and an odd N, which the TPU kernel takes at
# an N block of 1
ANY_N = sorted(set(chip_smoke.SSM_KN) | {(512, 77, 64), (256, 300, 32)})


def _chunks(N, n0, vec, per_col):
    """The pieces a CTA at column ``n0`` copies of one row of ``per_col``
    bytes a column, as the kernel forms them: each of its 16-byte chunks
    holds min(16, max(0, N * per_col - chunk start)) valid bytes, copied
    in pieces of ``vec``. Returns the (row offset, valid) pieces."""
    out = []
    for c in range(k1.BN * per_col // 16):
        col = n0 + c * 16 // per_col
        valid = per_col * max(0, min(16 // per_col, N - col))
        for o in range(0, 16, vec):
            out.append((col * per_col + o, o < valid))
    return out


@pytest.mark.parametrize("K,N,group", ANY_N)
def test_plan_takes_every_n(K, N, group):
    """Every M from 1 to 1024, bf16 and float32 x: the plan covers N with
    its last column tile holding the tail, and its copy widths tile each
    packed and scale row: every piece starts on a boundary of its width
    in device memory (rows of N and 4 N bytes from a 16-byte base), the
    valid pieces cover each column's bytes exactly once, and no valid
    piece reaches past N."""
    for M in range(1, 1025):
        for x_dtype in ("bfloat16", "float32"):
            p = k1.plan(M, K, N, bits=4, group=group, x_dtype=x_dtype,
                        inv_act=False)
            assert (p.grid[0] - 1) * k1.BN < N <= p.grid[0] * k1.BN
            assert p.grid[1] == -(-M // p.bm)
    assert N % p.pk_vec == 0 and p.pk_vec in (1, 2, 4, 8, 16)
    assert (2 * p.pk_vec > 16 or N % (2 * p.pk_vec))
    assert p.sz_vec == min(16, 4 * p.pk_vec) and (4 * N) % p.sz_vec == 0
    for per_col, vec in ((1, p.pk_vec), (4, p.sz_vec)):
        seen = np.zeros(N * per_col, np.int32)
        for bx in range(p.grid[0]):
            for row in range(3):
                for off, valid in _chunks(N, bx * k1.BN, vec, per_col):
                    assert (row * N * per_col + off) % vec == 0
                    if valid:
                        assert off + vec <= N * per_col
                        if row == 0:
                            seen[off:off + vec] += 1
        assert (seen == 1).all()


def tile_numerics(x, packed, scales, zeros, *, bits, group):
    """The kernel's column tiles: each CTA's 256 columns as it stages them
    (packed, scale and zero columns past N zero-filled), the per-group
    arithmetic of ``kernel_numerics`` on the whole tile, and only the
    columns below N stored."""
    N = packed.shape[-1]
    out = torch.zeros((x.shape[0], N), dtype=x.dtype)
    for n0 in range(0, N, k1.BN):
        n = min(k1.BN, N - n0)
        pad = (lambda t: torch.nn.functional.pad(t[:, n0:n0 + n],
                                                 (0, k1.BN - n)))
        tile = kernel_numerics(x, pad(packed), pad(scales), pad(zeros),
                               bits=bits, group=group)
        out[:, n0:n0 + n] = tile[:, :n]
    return out


@pytest.mark.parametrize("N", [77, 300, 328, 648])
@pytest.mark.parametrize("x_dtype", ["bfloat16", "float32"])
def test_tail_tile_numerics_match_plain(N, x_dtype):
    """The tail tile's arithmetic at an odd N, N = 2 mod 4 (Hymba's 6482),
    N = 8 mod 16 and a tail of 136 columns (Mamba-2's 6448 leaves 48 past
    the last 64): the zero-filled columns add nothing, against
    ``ref.wna16_ref``, int4 and int8."""
    rng = np.random.default_rng(N)
    M, K, group = 3, 128, 32
    for bits in (4, 8):
        w = rng.standard_normal((K, N)).astype(np.float32) * K ** -0.5
        qt = quantize_tensor(torch.from_numpy(w), bits=bits, group=group)
        x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)
                             ).to(DTYPES[x_dtype])
        args = (x, qt.packed, qt.scales, qt.zeros)
        got = tile_numerics(*args, bits=bits, group=group)
        want = ref.wna16_ref(*args, bits=bits, group=group)
        chip_smoke.check_close(f"tail N={N} int{bits} {x_dtype}", got, want)


@pytest.mark.parametrize("M,name", [(1, "1"), (2, "2-8"), (8, "2-8"),
                                    (9, "9-16"), (16, "9-16"),
                                    (17, "17-64"), (64, "17-64"),
                                    (65, "65-256"), (256, "65-256"),
                                    (257, "257-512"), (512, "257-512"),
                                    (513, ">512"), (4096, ">512")])
def test_m_bucket(M, name):
    assert k1.m_bucket(M) == name


# ---------------------------------------------------------------------------
# the kernel's arithmetic, in plain torch
# ---------------------------------------------------------------------------
def kernel_numerics(x, packed, scales, zeros, inv_act=None, bias=None, *,
                    bits, group):
    """What the tensor-core kernel computes, step for step: the mma
    operands are the integer weight plus the kernel's offset (exact in the
    16-bit operand type) and x itself (bf16 / fp16 x without inv_act) or
    the bf16 parts of x * inv_act (two for 16-bit x, three, exact, for
    float32 x); each group g keeps P_g = parts @ (q + OFF) and the parts'
    row sums S_g and folds them in as s * (P_g - (z + OFF) * S_g)."""
    K = x.shape[-1]
    direct = x.dtype != torch.float32 and inv_act is None
    if direct:
        tc = x.dtype
        off = 1024.0 if tc == torch.float16 else (128.0 if bits == 4 else 0.0)
        parts = [x.float()]
    else:
        tc, off = torch.bfloat16, 0.0
        v = x.float() * (1.0 if inv_act is None else inv_act.float())
        parts = []
        for _ in range(3 if x.dtype == torch.float32 else 2):
            h = v.to(torch.bfloat16).float()
            parts.append(h)
            v = v - h
    q = packing.unpack(packed, bits, K).float() + off
    assert torch.equal(q.to(tc).float(), q)          # exact operands
    for h in parts:
        assert torch.equal(h.to(tc).float(), h)
    acc = torch.zeros((x.shape[0], packed.shape[-1]))
    for g in range(K // group):
        ks = slice(g * group, (g + 1) * group)
        P = sum(h[:, ks] @ q[ks] for h in parts)
        S = sum(h[:, ks].sum(dim=1, keepdim=True) for h in parts)
        acc += scales[g] * (P - (zeros[g] + off) * S)
    if bias is not None:
        acc = acc + bias
    return acc.to(x.dtype)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("x_dtype", list(DTYPES))
@pytest.mark.parametrize("inv", [False, True])
def test_kernel_numerics_match_plain_and_jax(bits, x_dtype, inv):
    """The kernel's per-group arithmetic against ``ref.wna16_ref`` and the
    JAX package's Pallas kernel (interpret mode), four groups of 32 at
    N = 64, with inv_act and a bias or without both."""
    rng = np.random.default_rng(7 + bits)
    M, K, N, group = 5, 128, 64, 32
    w = rng.standard_normal((K, N)).astype(np.float32) * K ** -0.5
    act = (rng.random(K).astype(np.float32) + 0.5) if inv else None
    qt = quantize_tensor(torch.from_numpy(w), bits=bits, group=group,
                         act_scale=None if act is None
                         else torch.from_numpy(act))
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)
                         ).to(DTYPES[x_dtype])
    bias = torch.from_numpy(rng.standard_normal(N).astype(np.float32)) \
        if inv else None
    args = (x, qt.packed, qt.scales, qt.zeros, qt.inv_act, bias)
    got = kernel_numerics(*args, bits=bits, group=group)
    want = ref.wna16_ref(*args, bits=bits, group=group)
    chip_smoke.check_close(f"plain int{bits} {x_dtype}", got, want)
    j = jax_wna16_gemm(
        jnp.asarray(x.float().numpy()).astype(getattr(jnp, x_dtype)),
        jnp.asarray(qt.packed.numpy()), jnp.asarray(qt.scales.numpy()),
        jnp.asarray(qt.zeros.numpy()),
        None if qt.inv_act is None else jnp.asarray(qt.inv_act.numpy()),
        None if bias is None else jnp.asarray(bias.numpy()),
        bits=bits, group=group, interpret=True)
    jt = torch.from_numpy(np.asarray(j.astype(jnp.float32))).to(x.dtype)
    chip_smoke.check_close(f"jax int{bits} {x_dtype}", got, jt)
