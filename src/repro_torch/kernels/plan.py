"""Launch plans of the paged-attention kernels, in pure Python.

A plan is what a launch of the chunk walk, ``csrc/paged_chunk.cu`` (K3,
K3-q) or ``csrc/paged_attention_mla.cu`` (K3-mla), asks of the card: its
grid, threads, row tile, key tile, tensor-core passes and dynamic shared
memory. The C side sizes its own launches (``csrc/paged_walk.cuh``) and
exports each instantiation's plan; chip_smoke.py holds these plans against
that export on the card, and the tests check on the CPU that each fits
the card. The wrappers plan every chunk launch, so a width or dtype the
kernels lack is refused here, before any device check.
"""
from __future__ import annotations

from dataclasses import dataclass

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

