"""Launch plans of the paged-attention kernels, in pure Python.

A plan is what a launch of the chunk walk, ``csrc/paged_chunk.cu`` (K3,
K3-q) or ``csrc/paged_attention_mla.cu`` (K3-mla), asks of the card: its
grid, threads, row tile, key tile, tensor-core passes and dynamic shared
memory. The C side sizes its own launches (``csrc/paged_walk.cuh``) and
exports each instantiation's plan; chip_smoke.py holds these plans against
that export on the card, and the tests check on the CPU that each fits
the card. The wrappers plan every chunk launch, so a width or dtype the
kernels lack is refused here, before any device check.

The decode walk (``csrc/paged_attention.cu``, K2 and K2-q) is planned the
other way round, as K1 is: :func:`decode_plan` owns the launch (context
splits, the ring's depth, the shared-memory layout) and passes it to C as
the struct ``DecodePlan``, whose ctypes mirror is
:class:`CDecodePlan`; the C side checks it and executes it.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import astuple, dataclass

SMEM_LIMIT = 232_448     # H100 opt-in dynamic shared memory a block (227 KB)
ROW_TILE = 64            # chunk rows a CTA: 4 row warps x mma.sync's m16
KEY_TILES = (64, 32, 16)
HEAD_DIMS = (32, 64, 128, 256)
DTYPES = ("float32", "bfloat16", "float16")
# (key width, value width) pairs and pool dtypes of the latent mode:
# DeepSeek-V3's latent (512 + 64, 512)
LATENT_DIMS = ((576, 512),)
LATENT_POOL_DTYPES = ("float32", "bfloat16")
_ITEMSIZE = {"float32": 4, "bfloat16": 2, "float16": 2}


@dataclass(frozen=True)
class Plan:
    grid: tuple
    threads: int
    row_tile: int
    key_tile: int
    score_passes: int   # mma.sync a m16n8k8 step of Q K^T takes
    value_passes: int   # and of P V
    smem: int           # dynamic shared memory, bytes


def chunk_smem(Dh: int, Dv: int, key_tile: int, kv_dtype: str,
               kvq: bool) -> int:
    """Bytes of K3's buffers: the float32 Q tile, two stages of K (and V,
    unless latent) rows padded by 16 bytes, with ``kvq`` the int8 mirrors
    and four dequant floats a key (the GQA walk's merge of its two key
    halves, 64 x (Dv + 4) floats, is laid over the stages), and in the
    latent mode the exchange of the two value halves' partial scores."""
    size = _ITEMSIZE[kv_dtype]
    latent = Dv != Dh
    q = ROW_TILE * (Dh + 4) * 4
    kv = key_tile * (Dh + 16 // size) * size
    q8 = key_tile * (Dh + 16) if kvq else 0
    dq = key_tile * 4 * 4 if kvq else 0
    stage = kv * (1 if latent else 2) + 2 * q8 + dq
    exchange = 2 * ROW_TILE * key_tile * 4 if latent else 0
    merge = 0 if latent else ROW_TILE * (Dv + 4) * 4
    return q + max(2 * stage, merge) + exchange


def chunk_key_tile(Dh: int, Dv: int, kv_dtype: str) -> int:
    """The largest key tile whose buffers fit, sized with the quantized
    lane's mirrors (the GQA walk) whether or not the lane is on."""
    for bn in KEY_TILES:
        if chunk_smem(Dh, Dv, bn, kv_dtype, Dh == Dv) <= SMEM_LIMIT:
            return bn
    raise ValueError(f"no key tile fits head width {Dh}/{Dv}")


def chunk_passes(q_dtype: str, kv_dtype: str, kvq: bool) -> tuple:
    """mma.sync a step of Q K^T and of P V takes. A float32 operand (q, P,
    a float32 or dequantized pool) is rounded to TF32 for a bf16 output and
    split in two (3xTF32) for float32 and float16 outputs, whose tolerances
    are below one pass's rounding; a 16-bit operand is exact in TF32. A
    product takes big.big, plus one mma for each split operand."""
    split = q_dtype != "bfloat16"
    q_split = split and q_dtype == "float32"
    kv_split = split and (kv_dtype == "float32" or kvq)
    return 1 + q_split + kv_split, 1 + split + kv_split


def _refuse(what: str, msg: str) -> None:
    raise ValueError(f"{what}: {msg}")


def chunk_plan(*, B: int, C: int, H: int, KVH: int, Dh: int, Dv: int,
               q_dtype: str, kv_dtype: str, kvq: bool) -> Plan:
    """K3 (``Dv == Dh``, optionally the quantized lane) or K3-mla
    (``Dv < Dh``, KVH = 1). Raises ValueError for a width, dtype or lane
    the kernels are not built for."""
    what = "paged_chunk" if Dv == Dh else "paged_chunk_mla"
    if H % KVH:
        _refuse(what, f"H={H} not a multiple of KVH={KVH}")
    if Dv == Dh:
        if Dh not in HEAD_DIMS:
            _refuse(what, f"head dim {Dh} (takes {HEAD_DIMS})")
        if q_dtype not in DTYPES or kv_dtype not in DTYPES:
            _refuse(what, f"q {q_dtype} / pool {kv_dtype} (each takes "
                    f"{DTYPES})")
        threads = 256     # two warps a 16-row slice, one per key half
    else:
        if (Dh, Dv) not in LATENT_DIMS:
            _refuse(what, f"latent width (Dh {Dh}, dv {Dv}); the kernel is "
                    f"built for {LATENT_DIMS}")
        if q_dtype != "float32":
            _refuse(what, f"q {q_dtype}: the latent mode takes float32 q")
        if kv_dtype not in LATENT_POOL_DTYPES:
            _refuse(what, f"pool dtype {kv_dtype} (takes "
                    f"{LATENT_POOL_DTYPES})")
        if kvq or KVH != 1:
            _refuse(what, "the latent pool has one head and no sidecar")
        threads = 256     # two warps a 16-row slice, one per value half
    bn = chunk_key_tile(Dh, Dv, kv_dtype)
    smem = chunk_smem(Dh, Dv, bn, kv_dtype, kvq)
    assert smem <= SMEM_LIMIT
    G = H // KVH
    score, value = chunk_passes(q_dtype, kv_dtype, kvq)
    return Plan(grid=(-(-C * G // ROW_TILE), KVH, B), threads=threads,
                row_tile=ROW_TILE, key_tile=bn, score_passes=score,
                value_passes=value, smem=smem)


# ---------------------------------------------------------------------------
# the decode walk (K2, K2-q)
# ---------------------------------------------------------------------------
SMEM_SM = 233_472          # an SM's shared memory; 1 KB a block is reserved
N_SM = 132                 # the H100 SXM's SMs
DECODE_THREADS = 128       # four warps a CTA
DECODE_TOKEN_TILE = 16     # tokens a CTA scores at once (8 threads a token)
DECODE_MAX_SPLITS = 16     # CTAs a row takes, at most
DECODE_MIN_BLOCKS = 4      # pool blocks a split walks, at least
DECODE_MAX_PER_SM = 4      # CTAs an SM the grid aims at and the ring is
                           # sized for
DECODE_MAX_STAGES = 3      # ring depth, in pool blocks
DECODE_WINDOW = 64         # table entries and block records staged at once


@dataclass(frozen=True)
class DecodePlan:
    """One launch of the decode walk; the fields up to ``smem`` are the C
    struct ``DecodePlan``, in its order. Offsets are bytes from the start
    of dynamic shared memory, whose regions are, in order: q (G x Dh
    floats), the accumulator (G x Dh), two buffers of a block's scores
    (G x bs16 each), each warp's probabilities, corrections and sums of p
    ((bs16 + 2) x G4), the row state (each warp's m and l, the merged
    denominator and one merge weight a split, each G4 floats), the
    window's table entries, its block records (scale and zero of k and v,
    16 bytes a block), one mbarrier a stage and the ring (``stages`` x one
    pool block's K and V rows of one kv head). bs16 is bs rounded up to
    the token tile, G4 is G rounded up to 4."""
    splits: int            # the most CTAs a (sequence, kv head) row takes
    blocks_per_split: int  # a row takes one CTA for each this many blocks
    min_blocks: int        # and no CTA walks fewer
    stages: int
    window: int
    stage_bytes: int
    off_acc: int
    off_s: int
    off_p: int
    off_row: int
    off_tab: int
    off_rec: int
    off_bar: int
    off_ring: int
    smem: int
    grid: tuple            # (splits, KVH, B)


class CDecodePlan(ctypes.Structure):
    _fields_ = [(f, ctypes.c_int) for f in DecodePlan.__dataclass_fields__
                if f != "grid"]


def decode_layout(G: int, Dh: int, bs: int, kv_dtype: str, splits: int,
                  stages: int, window: int = DECODE_WINDOW) -> dict:
    """The decode walk's shared-memory offsets and total bytes (the
    ``DecodePlan`` fields from ``stage_bytes`` to ``smem``). Every region
    starts on a 16-byte boundary (float4 reads), the ring and each half of
    a stage on a 128-byte one (TMA tile copies)."""
    bs16 = -(-bs // DECODE_TOKEN_TILE) * DECODE_TOKEN_TILE
    g4 = -(-G // 4) * 4
    warps = DECODE_THREADS // 32
    stage = 2 * bs * Dh * _ITEMSIZE[kv_dtype]
    off = {"off_acc": G * Dh * 4}
    off["off_s"] = off["off_acc"] + G * Dh * 4
    off["off_p"] = off["off_s"] + 2 * G * bs16 * 4
    off["off_row"] = off["off_p"] + warps * (bs16 + 2) * g4 * 4
    off["off_tab"] = off["off_row"] + (2 * warps + 1 + splits) * g4 * 4
    off["off_rec"] = off["off_tab"] + -(-window // 4) * 16
    off["off_bar"] = off["off_rec"] + window * 16
    off["off_ring"] = -(-(off["off_bar"] + stages * 8) // 128) * 128
    return dict(stage_bytes=stage, **off,
                smem=off["off_ring"] + stages * stage)


def decode_splits(B: int, KVH: int, nb_t: int, n_sm: int = N_SM) -> tuple:
    """(most splits a row takes, blocks a split walks) of a decode launch.
    A row of ``blocks`` visible blocks takes ceil(blocks / blocks_per_split)
    CTAs on the card, at most ``splits`` and at most one for each
    ``DECODE_MIN_BLOCKS`` of its blocks, at least one. Chosen so that rows half as long
    as the table (the engine's tables are less than twice its longest row)
    give ``DECODE_MAX_PER_SM`` CTAs an SM, with at least
    ``DECODE_MIN_BLOCKS`` blocks a split and at most ``DECODE_MAX_SPLITS``
    splits a row. Host integers only: the live lengths are never read."""
    per_row = max(1, min(DECODE_MAX_SPLITS,
                         DECODE_MAX_PER_SM * n_sm // max(1, B * KVH)))
    half = max(1, -(-nb_t // 2))
    bps = max(DECODE_MIN_BLOCKS, -(-half // per_row))
    return max(1, min(DECODE_MAX_SPLITS, -(-nb_t // bps),
                      nb_t // DECODE_MIN_BLOCKS)), bps


@functools.lru_cache(maxsize=4096)
def decode_plan(*, B: int, H: int, KVH: int, Dh: int, bs: int, nb_t: int,
                q_dtype: str, kv_dtype: str, window: int = 0,
                n_sm: int = N_SM) -> DecodePlan:
    """The launch of K2 / K2-q for B sequences, H query heads over KVH kv
    heads of width Dh, pool blocks of bs tokens and a table nb_t entries
    wide, on a card of ``n_sm`` SMs. The quantized lane takes the same plan
    (its int8 rows lie over the fp rows of a stage), so a zeroed bundle
    walks the same splits and stages as the plain lane. The splits a row
    may take and the blocks a split walks are fixed here
    (:func:`decode_splits`, over the blocks a sliding ``window`` can span
    where it is narrower than the table); on the card each row takes its own number of
    splits from its visible blocks and divides them evenly. The ring is as
    deep as the CTAs an SM of this grid allow (at most
    ``DECODE_MAX_STAGES`` and one more than the blocks a split walks, at
    least two). Raises ValueError for what the kernel is not built for, on
    any device."""
    what = "paged_decode"
    if Dh not in HEAD_DIMS:
        _refuse(what, f"head dim {Dh} (takes {HEAD_DIMS})")
    if q_dtype not in DTYPES or kv_dtype not in DTYPES:
        _refuse(what, f"q {q_dtype} / pool {kv_dtype} (each takes {DTYPES})")
    if KVH < 1 or H % KVH:
        _refuse(what, f"H={H} not a multiple of KVH={KVH}")
    if B < 1 or bs < 1 or nb_t < 0:
        _refuse(what, f"B={B}, bs={bs}, nb_t={nb_t}: nothing to launch")
    if bs > 256 or bs * Dh * _ITEMSIZE[kv_dtype] % 128:
        _refuse(what, f"block size {bs}: a block's rows of one head are one "
                f"TMA box of at most 256 rows and a multiple of 128 bytes")
    G = H // KVH
    if window > 0:          # a window spans at most this many blocks
        nb_t = min(nb_t, -(-window // bs) + 1)
    splits, bps = decode_splits(B, KVH, nb_t, n_sm)
    # the CTAs of rows half as long as the table
    ctas = B * KVH * max(1, min(splits, -(-nb_t // 2 // bps)))
    per_sm = min(DECODE_MAX_PER_SM, -(-ctas // n_sm))
    lay = decode_layout(G, Dh, bs, kv_dtype, splits, DECODE_MAX_STAGES)
    fixed = lay["off_ring"]      # with the barriers of the deepest ring
    budget = min(SMEM_LIMIT, SMEM_SM // per_sm - 1024) - fixed
    stages = max(2, min(DECODE_MAX_STAGES, budget // lay["stage_bytes"],
                        bps + 1))
    lay = decode_layout(G, Dh, bs, kv_dtype, splits, stages)
    if lay["smem"] > SMEM_LIMIT:
        _refuse(what, f"G={G} x Dh={Dh} at bs={bs} needs {lay['smem']} "
                f"bytes of shared memory (the card gives {SMEM_LIMIT})")
    return DecodePlan(splits=splits, blocks_per_split=bps,
                      min_blocks=DECODE_MIN_BLOCKS, stages=stages,
                      window=DECODE_WINDOW, **lay, grid=(splits, KVH, B))


@functools.lru_cache(maxsize=4096)
def c_decode_plan(p: DecodePlan) -> CDecodePlan:
    return CDecodePlan(*astuple(p)[:-1])
