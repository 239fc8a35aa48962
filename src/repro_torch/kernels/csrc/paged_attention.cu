// Paged attention over a block-table KV pool: the decode block walk (K2),
// with and without its quantized-KV lane (K2-q). The helpers it shares
// with the chunk-prefill walk K3 are in paged_walk.cuh; K3 is built from
// paged_chunk.cu and its MLA latent mode from paged_attention_mla.cu.
//
// Replaces the Pallas TPU kernel `_paged_attn_kernel` (via `_paged_call`:
// `paged_attention_fused`, `paged_attention`) of
// src/repro/kernels/paged_attention.py, with and without its quantized-KV
// lane (`kv_quant`, FMA at `:78-82` there). Its block is (1, 1, G, Dh) for
// any G, and so is this kernel's.
//
// Layout (the JAX package's): pools (cap, bs, KVH, Dh); block tables
// (B, nb) int32 whose entries past a sequence's live length are scratch
// id 0 and are never read; q (B, H, Dh), with query head h*G + g served by
// kv head h (G = H / KVH).
//
// What bounds it on the H100: bytes. Each live context token's K and V of
// one kv head are read once (2 * Dh * 4 bytes in a float32 pool) for
// 4 * G * Dh FLOPs: 0.5 G FLOP a byte, far below the 20 FLOP a byte at
// which the card's float32 rate (67 TFLOP/s) meets its memory (3.35 TB/s).
// To run at that rate an SM must keep about 3.35 TB/s x ~1 us of latency /
// 132 SMs = ~25 KB of loads in flight. A warp that loads one token, reduces
// it and updates the softmax before it loads the next keeps ~1 KB in flight.
//
// Design, against that arithmetic:
// - The context is split over CTAs (flash-decoding). The grid is (splits,
//   KVH, B). The Python planner `decode_plan` in kernels/plan.py fixes the
//   most splits a row may take and the blocks a split should walk, with
//   the rest of the launch (ring depth, shared-memory layout), from host
//   integers only (B, KVH, G, the table width), never the live lengths.
//   On the card each row (sequence, kv head) takes one split for each that
//   many of its visible blocks (below its length, inside its window), none
//   walking fewer than a planned minimum, so a long row gets more CTAs than
//   a short one and a short row is one split with no merge; the row's
//   other CTAs exit at once. Each split walks an even share. The
//   fused new token is folded in by exactly one split, the one that holds
//   the last visible block (split 0 when none is). A one-split row writes
//   its output itself; otherwise each split leaves its partial (m, l, acc)
//   in a float32 workspace and the row's last split to finish (a counter
//   a row, reset by that split) merges them in rank order, so two calls
//   give the same bits; an empty partial (m = -1e30, l = 0) adds no
//   weight. No second launch; the grid needs no cluster, whose CTAs would
//   all hold their shared memory until the slowest one ended.
// - The bytes stay in flight: each visited pool block's K and V rows of the
//   CTA's kv head (16 KB in a float32 pool at bs 16, Dh 128) land in a ring
//   of `stages` shared-memory buffers by two TMA tile copies (a box of the
//   block's bs rows of one head, through tensor maps of the pools that the
//   C entry encodes for each launch), issued by one thread, that complete
//   on the stage's mbarrier. Every stage is filled before the first block
//   is used and refilled as soon as all warps are past it; the planner
//   sizes the ring to the CTAs an SM holds (three stages at four CTAs an SM
//   in the main case: 32-48 KB in flight a CTA, 128-192 KB an SM). No
//   thread spends registers or instructions on the copies' addresses. A
//   block is copied whole, the unused rows of a sequence's tail block too.
// - Scores for the whole block at once, from shared memory: eight threads
//   a token, each with a slice of its key in registers, a three-shuffle
//   reduction over the slice owners, into one of two score buffers. One
//   barrier a block; then every warp takes, for every row, one max, one
//   correction and one sum over the block (its own copy of the row state,
//   all copies equal; masked logits count as -1e30 and get probability 0,
//   the denominator floor is 1e-30, as on the TPU) and P V for the output
//   dims it owns, four rows at a time. No per-token shuffle chain sits
//   between two loads.
// - All G rows of a kv head are served from one read of its context: the
//   CTA holds q and the accumulator of every row in shared memory, and the
//   FLOPs stay far below the byte bound on CUDA cores even at G = 12.
// - The quantized-KV lane (template flag KVQ). The pool keeps the
//   invariant that a block whose scale row is non-zero has a zero fp slot
//   (PagedKVPool.quantize_blocks zeroes it; SCALE_EPS keeps a scale above
//   0) and that a block whose scale row is zero has a zero `zero` row
//   (dequantize_blocks, clear_quant and move_blocks zero both). So the
//   branch-free FMA fp + q * scale + zero reduces, block by block, to
//   q * scale + zero where the scale is non-zero and to the fp slot where
//   it is zero. The lane reads the four scale and zero floats of each
//   visited block once into a per-block record (where a slot indirection
//   into a mirror sized to the quantized set would go), and copies only
//   the int8 mirror (1 byte an element) of a quantized half-block or only
//   the fp slot of an fp one, never both: the branch is uniform over the
//   CTA. The int8 rows lie over the fp rows of the stage. A quantized
//   block's scale and zero are folded out of the element loops: its
//   scores are k_scale (q . k8) + k_zero sum(q), and its P V adds
//   v_scale sum(p v8) + v_zero sum(p), the FMA's sums in another float32
//   order. A zeroed bundle walks the fp path of every block through the
//   same arithmetic as the plain lane: the same output, bit for bit.
// Accumulation is float throughout; the output is written in q's dtype.
#include <cuda.h>
#include <cudaTypedefs.h>

#include "paged_walk.cuh"

// The launch plan; the ctypes mirror in kernels/plan.py (`CDecodePlan`)
// lists the same fields in the same order. Offsets are bytes.
struct DecodePlan {
  int splits;            // the most CTAs a row takes, the grid's x
  int blocks_per_split;  // a row takes one split for each this many blocks
  int min_blocks;        // and no split walks fewer
  int stages;            // depth of the ring, in pool blocks
  int window;            // table entries and block records staged at once
  int stage_bytes;       // one pool block's K and V rows of one kv head
  int off_acc, off_s, off_p, off_row, off_tab, off_rec, off_bar, off_ring;
  int smem;              // dynamic shared bytes of the launch
};

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTokTile = 16;     // tokens scored at once
constexpr int kParts = 8;        // threads a token, each a slice of Dh
constexpr int kMaxSplits = 16;
constexpr int kMaxStages = 8;

struct Args {
  const void* q;
  const void* k_pool;
  const void* v_pool;
  const void* k_new;
  const void* v_new;
  const int* tables;
  const int* lens;
  void* out;
  int H, KVH, G, bs, nb_t;
  float scale;
  int window;
  float softcap;
  int fused_new;
  KVQuant kvq;
  float* ws;        // splits' partials, (B, KVH, splits, 2 G + G Dh) floats
  int* counters;    // splits finished a row, (B, KVH); 0 between launches
  DecodePlan p;
};

// one visited block's dequant record: scale and zero of k and of v (all
// zero for an fp block and on the plain lane)
struct BlockRec {
  float ks, kz, vs, vz;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_addr(bar)), "r"(count)
               : "memory");
}
// one arrival that also expects `bytes` of TMA copies on the barrier
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile("{\n .reg .pred p;\n"
                 " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 " selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
}
// one TMA tile copy: the box of tensor map `map` at (0, h, row), a pool
// block's rows of one kv head, into shared memory, completing on `bar`
__device__ __forceinline__ void tma_rows(void* dst, const CUtensorMap* map, int h, int row,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(0), "r"(h), "r"(row),
         "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ float half_max(float v) {   // over 16 lanes
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float half_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}


// N consecutive elements of a shared-memory row as float (N x sizeof(T) is
// 4, 8, 16 or 32 bytes, and the address a multiple of it, or of 16)
__device__ __forceinline__ void unpack(unsigned w, float* out, float) {
  out[0] = __uint_as_float(w);
}
__device__ __forceinline__ void unpack(unsigned w, float* out, __nv_bfloat16) {
  out[0] = __uint_as_float(w << 16);
  out[1] = __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ void unpack(unsigned w, float* out, __half) {
  out[0] = __half2float(__ushort_as_half(static_cast<unsigned short>(w & 0xffffu)));
  out[1] = __half2float(__ushort_as_half(static_cast<unsigned short>(w >> 16)));
}
template <typename T, int N>
__device__ __forceinline__ void load_row(const T* p, float (&out)[N]) {
  constexpr int E = 4 / static_cast<int>(sizeof(T));   // elements a word
  constexpr int W = N / E;                             // words
  unsigned w[W];
  if constexpr (W % 4 == 0) {
#pragma unroll
    for (int i = 0; i < W; i += 4) {
      const uint4 v = reinterpret_cast<const uint4*>(p)[i / 4];
      w[i] = v.x, w[i + 1] = v.y, w[i + 2] = v.z, w[i + 3] = v.w;
    }
  } else if constexpr (W == 2) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = v.x, w[1] = v.y;
  } else {
    static_assert(W == 1, "rows load 4, 8 or a multiple of 16 bytes");
    w[0] = *reinterpret_cast<const unsigned*>(p);
  }
#pragma unroll
  for (int i = 0; i < W; ++i) unpack(w[i], out + i * E, T{});
}
// N int8 elements of a quantized row as float, before scale and zero
template <int N>
__device__ __forceinline__ void load_row_q(const int8_t* p, float (&out)[N]) {
  static_assert(N == 4 || N == 8, "int8 rows load 4 or 8 bytes");
  unsigned w[N / 4];
  if constexpr (N == 8) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = v.x, w[1] = v.y;
  } else {
    w[0] = *reinterpret_cast<const unsigned*>(p);
  }
#pragma unroll
  for (int i = 0; i < N; ++i)
    out[i] = static_cast<float>(static_cast<int8_t>((w[i / 4] >> (8 * (i % 4))) & 0xff));
}


// The tensor maps of a launch: the K and V pools and, on the KVQ lane,
// their int8 mirrors, each (rows = cap * bs, KVH, Dh) with a box of one
// block's bs rows of one head.
struct Maps {
  CUtensorMap k, v, qk, qv;
};

template <typename TQ, typename TKV, int DH, bool KVQ>
__global__ void __launch_bounds__(kThreads, 4)
paged_decode_kernel(const Args a, const __grid_constant__ Maps maps) {
  constexpr int EPT = DH / kParts;      // key elements a scoring thread holds
  constexpr int VEC = 16 / static_cast<int>(sizeof(TKV));
  constexpr int VW = EPT < VEC ? EPT : VEC;   // elements a shared load
  constexpr int NV = EPT / VW;
  constexpr int DT = DH < kThreads ? DH : kThreads;  // threads across Dh in P V
  constexpr int DPT = DH / DT;                        // dims a thread
  constexpr int RSP = kThreads / DT;                  // thread groups over rows
  constexpr int kRow = DH * static_cast<int>(sizeof(TKV));   // bytes a fp row
  extern __shared__ __align__(128) unsigned char smem[];
  const DecodePlan& p = a.p;
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int G = a.G, bs = a.bs, KVH = a.KVH;
  const int bs16 = (bs + kTokTile - 1) / kTokTile * kTokTile;
  const int G4 = (G + 3) & ~3;
  float* q_s = reinterpret_cast<float*>(smem);                 // [G][DH]
  float* acc_s = reinterpret_cast<float*>(smem + p.off_acc);   // [G][DH]
  float* s_s = reinterpret_cast<float*>(smem + p.off_s);       // [2][G][bs16]
  // this warp's probabilities [bs16][G4], corrections and sums [G4]
  float* p_w = reinterpret_cast<float*>(smem + p.off_p) + warp * (bs16 + 2) * G4;
  float* corr_w = p_w + bs16 * G4;
  float* psum_w = corr_w + G4;            // the block's sum of p a row
  float* row_s = reinterpret_cast<float*>(smem + p.off_row);
  float* m_w = row_s + warp * 2 * G4;     // this warp's running max and sum
  float* l_w = m_w + G4;
  float* den_s = row_s + kWarps * 2 * G4;
  float* w_s = den_s + G4;                // [splits][G4] merge weights
  int* tab_s = reinterpret_cast<int*>(smem + p.off_tab);       // [window]
  BlockRec* rec_s = reinterpret_cast<BlockRec*>(smem + p.off_rec);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + p.off_bar);  // [stages]
  unsigned char* ring = smem + p.off_ring;
  const int half = p.stage_bytes / 2;   // K rows, then V rows

  // this row's visible blocks [first, n_blocks) and its split count: one
  // split for each `blocks_per_split` of them, none with fewer than
  // `min_blocks` (at least one, at most `splits`); the rest of the grid's
  // x range has nothing to do here
  const int ctx = a.lens[b];
  const int qpos = a.fused_new ? ctx : ctx - 1;
  const int n_blocks = min(a.nb_t, (ctx + bs - 1) / bs);
  int first = 0;
  if (a.window > 0 && qpos - a.window + 1 > 0) first = min((qpos - a.window + 1) / bs, n_blocks);
  const int live = max(0, n_blocks - first);
  const int S = max(1, min(min(p.splits, (live + p.blocks_per_split - 1) / p.blocks_per_split),
                            live / p.min_blocks));
  if (split >= S) return;
  const TQ* q = static_cast<const TQ*>(a.q) + ((size_t)b * a.H + (size_t)h * G) * DH;
  for (int i = tid; i < G * DH; i += kThreads) {
    q_s[i] = morph::to_f32(q[i]);
    acc_s[i] = 0.f;
  }
  for (int i = tid; i < kWarps * G4; i += kThreads) {
    row_s[(i / G4) * 2 * G4 + i % G4] = kNegInf;        // m
    row_s[(i / G4) * 2 * G4 + G4 + i % G4] = 0.f;        // l
  }
  if (tid < p.stages) mbar_init(bar + tid, 1);
  if (tid == 0) {
    asm volatile("prefetch.tensormap [%0];\n" :: "l"(reinterpret_cast<uint64_t>(&maps.k)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" :: "l"(reinterpret_cast<uint64_t>(&maps.v)) : "memory");
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();

  // this split's share of the row's visible blocks: an even division
  const int per = (live + S - 1) / S;
  const int blk_lo = first + split * per;
  const int blk_hi = min(n_blocks, blk_lo + per);
  const bool fold = a.fused_new && split == (live > 0 ? (live - 1) / per : 0);

  // rows [lo, hi) of table entry nb that this sequence sees
  auto span = [&](int nb, int& lo, int& hi) {
    const int base = nb * bs;
    lo = a.window > 0 ? max(0, qpos - a.window + 1 - base) : 0;
    hi = min(bs, ctx - base);
  };

  // at G = 1 a scoring thread keeps its slice of q in registers
  const int part = tid % kParts;
  float q1[EPT], q1sum = 0.f;
  if (G == 1) {
#pragma unroll
    for (int v = 0; v < NV; ++v)
#pragma unroll
      for (int i = 0; i < VW; ++i) q1[v * VW + i] = q_s[(v * kParts + part) * VW + i];
    if (KVQ)
#pragma unroll
      for (int i = 0; i < EPT; ++i) q1sum += q1[i];
  }
  // scores of block rows [lo, hi) into score buffer `sb`: thread (t, part)
  // holds key row t's elements (v * kParts + part) * VW + e, v < NV, e < VW
  auto scores = [&](const unsigned char* kst, const BlockRec r, int lo, int hi, float* sb) {
    const bool kq = KVQ && r.ks != 0.f;
    const int tl = tid / kParts;
    for (int t0 = lo / kTokTile * kTokTile; t0 < hi; t0 += kTokTile) {
      const int t = t0 + tl;
      const bool row = t >= lo && t < hi;
      float kr[EPT];
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        float e[VW];
        const int d = (v * kParts + part) * VW;
        if (!row) {
#pragma unroll
          for (int i = 0; i < VW; ++i) e[i] = 0.f;
        } else if (kq) {
          load_row_q<VW>(reinterpret_cast<const int8_t*>(kst) + t * DH + d, e);
        } else {
          load_row<TKV, VW>(reinterpret_cast<const TKV*>(kst) + t * DH + d, e);
        }
#pragma unroll
        for (int i = 0; i < VW; ++i) kr[v * VW + i] = e[i];
      }
      for (int g = 0; g < G; ++g) {
        float d2[2] = {0.f, 0.f};   // two chains
        float qsum = q1sum;         // this slice's sum of q, on a quantized block
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          float qv[VW];
          if (G == 1) {
#pragma unroll
            for (int i = 0; i < VW; ++i) qv[i] = q1[v * VW + i];
          } else {
            load_row<float, VW>(q_s + g * DH + (v * kParts + part) * VW, qv);
            if (kq)
#pragma unroll
              for (int i = 0; i < VW; ++i) qsum += qv[i];
          }
#pragma unroll
          for (int i = 0; i < VW; ++i) d2[i & 1] = fmaf(kr[v * VW + i], qv[i], d2[i & 1]);
        }
        float dot = d2[0] + d2[1];
        if (kq) dot = fmaf(r.ks, dot, r.kz * qsum);   // q . (k8 * scale + zero)
        dot += __shfl_xor_sync(0xffffffffu, dot, 1);
        dot += __shfl_xor_sync(0xffffffffu, dot, 2);
        dot += __shfl_xor_sync(0xffffffffu, dot, 4);
        if (part == 0 && row) sb[g * bs16 + t] = cap_logit(dot * a.scale, a.softcap);
      }
    }
  };

  // this warp's softmax update of every row for the block (each warp keeps
  // its own copy of m and l; all copies are the same), then P V of the
  // dims and rows this thread owns. Lanes are (row pair, token).
  auto update = [&](const unsigned char* vst, const BlockRec r, int lo, int hi,
                    const float* sb) {
    __syncwarp();
    const int hr = lane >> 4, tk = lane & 15;
    const int ps = G == 1 ? 1 : G4;   // p_w stride: contiguous tokens at G = 1
    for (int g0 = 0; g0 < G; g0 += 2) {
      const int g = g0 + hr;
      const bool rowv = g < G;
      float mb = kNegInf;
      for (int t = tk; t < bs16; t += kTokTile)
        if (rowv && t >= lo && t < hi) mb = fmaxf(mb, sb[g * bs16 + t]);
      mb = half_max(mb);
      const float m_old = rowv ? m_w[g] : 0.f;
      const float m_new = fmaxf(m_old, mb);
      float sum = 0.f;
      for (int t = tk; t < bs16; t += kTokTile) {
        const float pv = (rowv && t >= lo && t < hi) ? expf(sb[g * bs16 + t] - m_new) : 0.f;
        if (rowv) p_w[t * ps + g] = pv;
        sum += pv;
      }
      sum = half_sum(sum);
      if (rowv && tk == 0) {
        const float corr = expf(m_old - m_new);
        corr_w[g] = corr;
        psum_w[g] = sum;
        l_w[g] = fmaf(l_w[g], corr, sum);
        m_w[g] = m_new;
      }
    }
    __syncwarp();
    const bool vq = KVQ && r.vs != 0.f;
    const int dt = tid % DT, grp = tid / DT;
    // an fp value, or a quantized one before its scale and zero: a
    // quantized block's sum over the rows is folded in as
    // acc = acc * corr + scale * sum(p v8) + zero * sum(p)
    auto value = [&](int t, int i) {
      const int d = t * DH + dt + i * DT;
      return vq ? static_cast<float>(reinterpret_cast<const int8_t*>(vst)[d])
                : morph::to_f32(reinterpret_cast<const TKV*>(vst)[d]);
    };
    auto fold_q = [&](float acc, float old, int g) {
      return vq ? fmaf(r.vs, acc, fmaf(r.vz, psum_w[g], old)) : acc;
    };
    if (G == 1) {   // one row: no quad of rows to pad
      if (grp == 0) {
        float acc[DPT], old[DPT];
        const float c = corr_w[0];
#pragma unroll
        for (int i = 0; i < DPT; ++i) {
          old[i] = acc_s[dt + i * DT] * c;
          acc[i] = vq ? 0.f : old[i];
        }
        if (lo == 0 && hi == kTokTile) {   // a whole block of 16 rows, unrolled
          float pv[kTokTile];
          load_row<float, kTokTile>(p_w, pv);
#pragma unroll
          for (int t = 0; t < kTokTile; ++t)
#pragma unroll
            for (int i = 0; i < DPT; ++i) acc[i] = fmaf(pv[t], value(t, i), acc[i]);
        } else {
#pragma unroll 4
          for (int t = lo; t < hi; ++t)
#pragma unroll
            for (int i = 0; i < DPT; ++i) acc[i] = fmaf(p_w[t], value(t, i), acc[i]);
        }
#pragma unroll
        for (int i = 0; i < DPT; ++i) acc_s[dt + i * DT] = fold_q(acc[i], old[i], 0);
      }
      return;
    }
    for (int g0 = grp * 4; g0 < G; g0 += RSP * 4) {
      float acc[4][DPT], old[4][DPT];
#pragma unroll
      for (int r4 = 0; r4 < 4; ++r4) {
        const bool rowv = g0 + r4 < G;
        const float c = rowv ? corr_w[g0 + r4] : 0.f;
#pragma unroll
        for (int i = 0; i < DPT; ++i) {
          old[r4][i] = rowv ? acc_s[(g0 + r4) * DH + dt + i * DT] * c : 0.f;
          acc[r4][i] = vq ? 0.f : old[r4][i];
        }
      }
#pragma unroll 4
      for (int t = lo; t < hi; ++t) {
        float v[DPT];
#pragma unroll
        for (int i = 0; i < DPT; ++i) v[i] = value(t, i);
        const float4 pv = *reinterpret_cast<const float4*>(p_w + t * G4 + g0);
#pragma unroll
        for (int i = 0; i < DPT; ++i) {
          acc[0][i] = fmaf(pv.x, v[i], acc[0][i]);
          acc[1][i] = fmaf(pv.y, v[i], acc[1][i]);
          acc[2][i] = fmaf(pv.z, v[i], acc[2][i]);
          acc[3][i] = fmaf(pv.w, v[i], acc[3][i]);
        }
      }
#pragma unroll
      for (int r4 = 0; r4 < 4; ++r4) {
        if (g0 + r4 >= G) break;
#pragma unroll
        for (int i = 0; i < DPT; ++i)
          acc_s[(g0 + r4) * DH + dt + i * DT] = fold_q(acc[r4][i], old[r4][i], g0 + r4);
      }
    }
  };

  // the table entries and block records of window [w0, w0 + nw)
  auto stage_window = [&](int w0, int nw) {
    __syncthreads();   // the previous window's records are no longer read
    for (int i = tid; i < nw; i += kThreads) {
      const int blk = a.tables[(size_t)b * a.nb_t + w0 + i];
      tab_s[i] = blk;
      BlockRec r{0.f, 0.f, 0.f, 0.f};
      if constexpr (KVQ)
        r = BlockRec{a.kvq.k_scale[blk], a.kvq.k_zero[blk], a.kvq.v_scale[blk],
                     a.kvq.v_zero[blk]};
      rec_s[i] = r;
    }
    __syncthreads();
  };

  int kb = 0;   // blocks this CTA has taken through the ring
  for (int w0 = blk_lo; w0 < blk_hi; w0 += p.window) {
    const int nw = min(p.window, blk_hi - w0);
    stage_window(w0, nw);
    // thread 0 copies window entry j's K and V rows of this kv head into
    // stage `st`, two TMA tile copies on the stage's barrier; a quantized
    // half-block takes its int8 rows instead
    auto fetch = [&](int j, int st) {
      unsigned char* kst = ring + (size_t)st * p.stage_bytes;
      const BlockRec r = rec_s[j];
      const bool kq = KVQ && r.ks != 0.f, vq = KVQ && r.vs != 0.f;
      mbar_expect(bar + st, (unsigned)(bs * ((kq ? DH : kRow) + (vq ? DH : kRow))));
      tma_rows(kst, kq ? &maps.qk : &maps.k, h, tab_s[j] * bs, bar + st);
      tma_rows(kst + half, vq ? &maps.qv : &maps.v, h, tab_s[j] * bs, bar + st);
    };
    int st = kb % p.stages, ph = (kb / p.stages) & 1;   // block i's stage, parity
    if (tid == 0)
      for (int j = 0; j < min(p.stages, nw); ++j) fetch(j, (st + j) % p.stages);
    for (int i = 0; i < nw; ++i) {
      mbar_wait(bar + st, ph);
      int lo, hi;
      span(w0 + i, lo, hi);
      const BlockRec r = rec_s[i];
      const unsigned char* kst = ring + (size_t)st * p.stage_bytes;
      float* sb = s_s + (i & 1) * G * bs16;
      scores(kst, r, lo, hi, sb);
      __syncthreads();   // scores in; every warp is past block i - 1
      if (tid == 0 && i >= 1 && i - 1 + p.stages < nw)
        fetch(i - 1 + p.stages, st == 0 ? p.stages - 1 : st - 1);
      update(kst + half, r, lo, hi, sb);
      if (++st == p.stages) {
        st = 0;
        ph ^= 1;
      }
    }
    kb += nw;
  }

  // the fused new token, always visible, as a one-row block in stage 0
  if (fold) {
    __syncthreads();
    const TKV* kn = static_cast<const TKV*>(a.k_new) + ((size_t)b * KVH + h) * DH;
    const TKV* vn = static_cast<const TKV*>(a.v_new) + ((size_t)b * KVH + h) * DH;
    for (int d = tid; d < DH; d += kThreads) {
      reinterpret_cast<TKV*>(ring)[d] = kn[d];
      reinterpret_cast<TKV*>(ring + half)[d] = vn[d];
    }
    __syncthreads();
    const BlockRec fp{0.f, 0.f, 0.f, 0.f};
    scores(ring, fp, 0, 1, s_s);
    __syncthreads();
    update(ring + half, fp, 0, 1, s_s);
  }

  // the output: a one-split row writes its own; otherwise each split
  // leaves its partial (m, l, acc) in the workspace and the row's last
  // split to finish merges them all in rank order, weights exp(m_r - M)
  // (the same bits whichever split is last), and resets the row's counter
  __syncthreads();
  const float* m0 = row_s;   // warp 0's copy of m and l
  const float* l0 = row_s + G4;
  TQ* out = static_cast<TQ*>(a.out) + ((size_t)b * a.H + (size_t)h * G) * DH;
  const int E = G * DH;
  if (S == 1) {
    for (int e = tid; e < E; e += kThreads)
      out[e] = morph::from_f32<TQ>(acc_s[e] / fmaxf(l0[e / DH], 1e-30f));
    return;
  }
  const int row = b * KVH + h;
  const size_t stride = (size_t)E + 2 * G;   // m[G], l[G], acc[G][DH]
  float* ws = a.ws + (size_t)row * p.splits * stride;
  for (int g = tid; g < G; g += kThreads) {
    ws[split * stride + g] = m0[g];
    ws[split * stride + G + g] = l0[g];
  }
  for (int e = tid; e < E; e += kThreads) ws[split * stride + 2 * G + e] = acc_s[e];
  __threadfence();
  __syncthreads();
  int* last = tab_s;   // the table window is no longer read
  if (tid == 0) *last = atomicAdd(a.counters + row, 1) == S - 1;
  __syncthreads();
  if (!*last) return;
  __threadfence();
  for (int g = tid; g < G; g += kThreads) {
    float M = kNegInf;
    for (int r = 0; r < S; ++r) M = fmaxf(M, __ldcg(ws + r * stride + g));
    float L = 0.f;
    for (int r = 0; r < S; ++r) {
      const float w = expf(__ldcg(ws + r * stride + g) - M);
      w_s[r * G4 + g] = w;
      L = fmaf(__ldcg(ws + r * stride + G + g), w, L);
    }
    den_s[g] = fmaxf(L, 1e-30f);
  }
  __syncthreads();
  for (int e = tid; e < E; e += kThreads) {
    const int g = e / DH;
    float A = 0.f;
    for (int r = 0; r < S; ++r) A = fmaf(__ldcg(ws + r * stride + 2 * G + e), w_s[r * G4 + g], A);
    out[e] = morph::from_f32<TQ>(A / den_s[g]);
  }
  if (tid == 0) a.counters[row] = 0;
}

// The plan against what the kernel is built for and what this launch
// needs; false refuses it.
bool plan_fits(const DecodePlan& p, int G, int Dh, int bs, int esize) {
  const long bs16 = (bs + kTokTile - 1) / kTokTile * kTokTile, G4 = (G + 3) / 4 * 4;
  const long gd = (long)G * Dh * 4;
  const int offs[] = {p.off_acc, p.off_s, p.off_p, p.off_row, p.off_tab, p.off_rec,
                      p.off_bar};
  for (int o : offs)
    if (o % 16) return false;
  if (p.off_ring % 128 || p.stage_bytes % 256 || bs > 256) return false;   // TMA boxes
  return p.splits >= 1 && p.splits <= kMaxSplits && p.blocks_per_split >= 1 &&
         p.min_blocks >= 1 && p.stages >= 2 &&
         p.stages <= kMaxStages && p.window >= 1 &&
         p.stage_bytes == 2L * bs * Dh * esize && p.off_acc >= gd &&
         p.off_s >= p.off_acc + gd && p.off_p >= p.off_s + 2 * G * bs16 * 4 &&
         p.off_row >= p.off_p + kWarps * (bs16 + 2) * G4 * 4 &&
         p.off_tab >= p.off_row + (2L * kWarps + 1 + p.splits) * G4 * 4 &&
         p.off_rec >= p.off_tab + 4L * p.window && p.off_bar >= p.off_rec + 16L * p.window &&
         p.off_ring >= p.off_bar + 8L * p.stages &&
         p.smem >= p.off_ring + (long)p.stages * p.stage_bytes &&
         p.smem <= (long)kSmemMax;
}

// cuTensorMapEncodeTiled through the runtime (no link to libcuda); null
// when the installed CUDA lacks it
PFN_cuTensorMapEncodeTiled_v12000 encode_fn() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(f);
  }
  return fn;
}

// the map of a (cap * bs, KVH, Dh) pool of `esize`-byte elements, whose box
// is one block's bs rows of one head
bool encode(CUtensorMap* map, const void* base, CUtensorMapDataType type, int esize,
            int Dh, int KVH, long rows, int bs) {
  auto fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)Dh, (cuuint64_t)KVH, (cuuint64_t)rows};
  const cuuint64_t strides[2] = {(cuuint64_t)Dh * esize, (cuuint64_t)KVH * Dh * esize};
  const cuuint32_t box[3] = {(cuuint32_t)Dh, 1, (cuuint32_t)bs};
  const cuuint32_t step[3] = {1, 1, 1};
  return fn(map, type, 3, const_cast<void*>(base), dims, strides, box, step,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename TQ, typename TKV, int DH, bool KVQ>
cudaError_t launch(const Args& a, const Maps& maps, int B, cudaStream_t stream) {
  auto kern = paged_decode_kernel<TQ, TKV, DH, KVQ>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, a.p.smem);
  if (err != cudaSuccess) return err;
  // the largest shared carveout, so the planned CTAs an SM fit
  err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.p.splits, a.KVH, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = a.p.smem;
  cfg.stream = stream;
  err = cudaLaunchKernelEx(&cfg, kern, a, maps);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// C entry point. The wrapper has checked shapes, dtypes, contiguity and the
// 16-byte alignment of the pools and mirrors, and made `plan`
// (kernels/plan.py `decode_plan`); a plan this kernel is not built for is
// refused with cudaErrorInvalidValue. k_new / v_new may be null when
// fused_new is 0, and the six quantized-KV operands (qk, qv int8 like the
// pools; k/v scale and zero float (cap,)) are all null or all set: set
// selects the KVQ lane. Any G = H / KVH >= 1 whose rows fit the plan. cap
// is the pools' block capacity (for the tensor maps); ws holds B x KVH x
// plan->splits partials of 2 G + G Dh floats; counters holds B x KVH
// int32 zeros and is left zero. Returns the launch's CUDA error code.
extern "C" int morph_paged_decode(const void* q, int q_dtype, const void* k_pool,
                                  const void* v_pool, int kv_dtype, const void* k_new,
                                  const void* v_new, const void* tables,
                                  const void* lens, void* out, int B, int H, int KVH,
                                  int Dh, int bs, int nb_t, int cap, float scale, int window,
                                  float softcap, int fused_new, const void* qk,
                                  const void* qv, const void* k_scale,
                                  const void* v_scale, const void* k_zero,
                                  const void* v_zero, const DecodePlan* plan, void* ws,
                                  void* counters, void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  const int G = H / KVH;
  const int esize = kv_dtype == morph::kF32 ? 4 : 2;
  if (!plan_fits(*plan, G, Dh, bs, esize)) return (int)cudaErrorInvalidValue;
  const KVQuant kvq{static_cast<const int8_t*>(qk), static_cast<const int8_t*>(qv),
                    static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
                    static_cast<const float*>(k_zero), static_cast<const float*>(v_zero)};
  const Args a{q, k_pool, v_pool, k_new, v_new, static_cast<const int*>(tables),
               static_cast<const int*>(lens), out, H, KVH, G, bs, nb_t, scale, window,
               softcap, fused_new, kvq, static_cast<float*>(ws), static_cast<int*>(counters),
               *plan};
  const CUtensorMapDataType type = kv_dtype == morph::kF32    ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                   : kv_dtype == morph::kBF16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                                              : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  Maps maps = {};
  const long rows = (long)cap * bs;
  if (!encode(&maps.k, k_pool, type, esize, Dh, KVH, rows, bs) ||
      !encode(&maps.v, v_pool, type, esize, Dh, KVH, rows, bs) ||
      (qk != nullptr &&
       (!encode(&maps.qk, qk, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, Dh, KVH, rows, bs) ||
        !encode(&maps.qv, qv, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, Dh, KVH, rows, bs))))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess, width = cudaSuccess;
  MORPH_DISPATCH_DTYPE(q_dtype, TQ, {
    MORPH_DISPATCH_DTYPE(kv_dtype, TKV, {
      width = dispatch_head_dim(Dh, [&](auto dh) {
        dispatch_kvq(qk != nullptr, [&](auto kvq_on) {
          err = launch<TQ, TKV, decltype(dh)::value, decltype(kvq_on)::value>(a, maps, B,
                                                                             stream);
        });
      });
    });
  });
  return (int)(width != cudaSuccess ? width : err);
}
