// The block walks shared by the paged-attention kernels: the quantized-KV
// operands, logit cap, dispatch and cp.async helpers that the decode walk
// K2 shares, and the chunk-prefill walk K3 on tensor cores
// (`paged_chunk_kernel`, launched through `ChunkKernel`). Included by
// paged_attention.cu (K2),
// paged_chunk.cu (K3 with and without its quantized-KV lane) and
// paged_attention_mla.cu (K3's MLA latent mode), so that each library
// instantiates only what it uses and the three build in parallel. Design
// notes are at the top of paged_attention.cu (K2), paged_chunk.cu (K3, the
// quantized lane) and paged_attention_mla.cu (the latent mode).
#pragma once
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr float kNegInf = -1e30f;
__device__ __forceinline__ float neg_inf() { return __uint_as_float(0xff800000u); }

__device__ __forceinline__ float cap_logit(float s, float softcap) {
  return softcap > 0.f ? tanhf(s / softcap) * softcap : s;
}

// The quantized-KV sidecar of one layer; null pointers when KVQ is false.
struct KVQuant {
  const int8_t* qk;
  const int8_t* qv;
  const float* k_scale;
  const float* v_scale;
  const float* k_zero;
  const float* v_zero;
};

// Calls f(std::integral_constant<int, Dh>) for a head width the kernels
// are built for; cudaErrorInvalidValue for any other.
template <typename F>
cudaError_t dispatch_head_dim(int Dh, F&& f) {
  switch (Dh) {
    case 32: f(std::integral_constant<int, 32>{}); break;
    case 64: f(std::integral_constant<int, 64>{}); break;
    case 128: f(std::integral_constant<int, 128>{}); break;
    case 256: f(std::integral_constant<int, 256>{}); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

template <typename F>
void dispatch_kvq(bool kvq, F&& f) {
  if (kvq) f(std::true_type{});
  else f(std::false_type{});
}

// ---------------------------------------------------------------------------
// K3 on tensor cores: mma.sync m16n8k8 TF32, cp.async double buffering
// ---------------------------------------------------------------------------
constexpr int kRowTile = 64;            // rows a CTA: 4 row warps x m16
constexpr size_t kSmemMax = 232448;     // H100 opt-in shared memory a block

// The dynamic shared memory of one instantiation with key tile BN (the
// launch planner kernels/plan.py computes the same bytes):
//   Q tile     kRowTile x (DH + 4) floats
//   2 stages   each K (and V, unless latent) BN x (DH + 16 B) in the pool
//              dtype; with KVQ the int8 mirrors BN x (DH + 16) bytes each
//              and 4 dequant floats a key
//   latent     the score exchange of the two value halves, 2 x kRowTile x BN
// The GQA walk's two key halves merge their softmax states at the end
// through kRowTile x (DV + 4) floats laid over the stages (never more than
// the stages take, for the widths built). Row pads keep the fragment loads
// free of bank conflicts and every row on a 16-byte boundary for cp.async.
template <int DH, int DV, int BN, typename TKV, bool KVQ>
struct ChunkSmem {
  static constexpr bool kLatent = DV != DH;
  static constexpr int kWN = kLatent ? 2 : 1;   // value halves of a row slice
  static constexpr int kWK = kLatent ? 1 : 2;   // key halves of a row slice
  static constexpr int kQStride = DH + 4;                            // floats
  static constexpr int kKStride = DH + 16 / static_cast<int>(sizeof(TKV));  // elements
  static constexpr int kQ8Stride = DH + 16;                          // bytes
  static constexpr size_t kQ = (size_t)kRowTile * kQStride * 4;
  static constexpr size_t kKV = (size_t)BN * kKStride * sizeof(TKV);
  static constexpr size_t kQ8 = KVQ ? (size_t)BN * kQ8Stride : 0;
  static constexpr size_t kDq = KVQ ? (size_t)BN * 4 * sizeof(float) : 0;
  static constexpr size_t kStage = kKV * (kLatent ? 1 : 2) + 2 * kQ8 + kDq;
  static constexpr size_t kS = kWN > 1 ? (size_t)kWN * kRowTile * BN * 4 : 0;
  static constexpr size_t kMerge = kWK > 1 ? (size_t)kRowTile * (DV + 4) * 4 : 0;
  static constexpr size_t kBytes =
      kQ + (2 * kStage > kMerge ? 2 * kStage : kMerge) + kS;
};

// The largest key tile of 64, 32, 16 whose buffers fit, sized with the
// quantized lane's mirrors whether or not it is on, so both lanes of a
// width walk the same tiles and a zeroed sidecar reproduces the plain
// lane bit for bit.
template <int DH, int DV, typename TKV>
constexpr int chunk_key_tile() {
  constexpr bool q = DH == DV;   // the latent mode has no quantized lane
  return ChunkSmem<DH, DV, 64, TKV, q>::kBytes <= kSmemMax   ? 64
         : ChunkSmem<DH, DV, 32, TKV, q>::kBytes <= kSmemMax ? 32
                                                             : 16;
}

// How an mma operand becomes TF32. A 16-bit value (bf16, f16) is exact in
// TF32 and goes as it is. A float32 value is rounded to TF32's 10 mantissa
// bits (nearest, ties away from zero) with two integer operations on its
// bits; with kSplit the remainder x - big goes too, which the tensor core
// reads truncated to TF32 (it ignores an operand's low 13 bits), so that
// big.big + small.big + big.small carries ~21 bits (3xTF32).
enum Tf32Mode { kExact = 0, kRound = 1, kSplit = 2 };

template <int MODE>
__device__ __forceinline__ void to_tf32(float x, uint32_t& big, uint32_t& small) {
  if constexpr (MODE == kExact) big = __float_as_uint(x);
  else big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  if constexpr (MODE == kSplit) small = __float_as_uint(x - __uint_as_float(big));
  else small = 0u;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b: big.big, plus small.big and big.small for a split operand
template <int MA, int MB>
__device__ __forceinline__ void mma_modes(float (&d)[4], const uint32_t (&ab)[4],
                                          const uint32_t (&as)[4], uint32_t bb0,
                                          uint32_t bb1, uint32_t bs0, uint32_t bs1) {
  if constexpr (MA == kSplit) mma_tf32(d, as, bb0, bb1);
  if constexpr (MB == kSplit) mma_tf32(d, ab, bs0, bs1);
  mma_tf32(d, ab, bb0, bb1);
}

// 2^x on the special function unit (relative error ~2^-22; 2^-inf = 0).
// The chunk walk keeps its scores and running maxima in base-2 units.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
constexpr float kLog2e = 1.4426950408889634f;

// no memory clobber: loads may move across a copy; wait_group and the
// barrier after it order the shared writes
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 c = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, c.x, c.y);
}
__device__ __forceinline__ float4 load4(const __half* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&u.x));
  const float2 c = __half22float2(*reinterpret_cast<const __half2*>(&u.y));
  return make_float4(a.x, a.y, c.x, c.y);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(__half* p, float a, float b) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(a, b);
}

// staged row n, lane d of a K or V tile as float; the KVQ lane adds the
// int8 mirror's q * scale + zero (both zero for fp blocks and own rows)
template <bool KVQ, int KS, int Q8S, typename TKV>
__device__ __forceinline__ float staged(const TKV* rows, const int8_t* q8, int n,
                                        int d, float scale, float zero) {
  float x = morph::to_f32(rows[n * KS + d]);
  if constexpr (KVQ) x = x + static_cast<float>(q8[n * Q8S + d]) * scale + zero;
  return x;
}

// The operands of one chunk launch. Pointers are the C entry's; the kernel
// casts them to its element types.
struct ChunkArgs {
  const void* q;
  const void* k_pool;
  const void* v_pool;
  const void* k_new;
  const void* v_new;
  const int* tables;
  void* out;
  int pos0, B, C, H, KVH, G, bs, nb_t;
  float scale;
  int window;
  float softcap;
  int fused_new;
  KVQuant kvq;
};

template <typename TQ, typename TKV, int DH, int DV, bool KVQ>
struct ChunkCfg {
  static constexpr int kBN = chunk_key_tile<DH, DV, TKV>();
  // TF32 passes of a float32 operand: one where the output is bf16 (its
  // rounding, 2^-9, is far above one pass's 2^-11 on each operand), three
  // for float32 and float16 outputs, whose tolerances are below what one
  // pass keeps (16-bit operands are exact in TF32 and need one)
  static constexpr int kPasses = std::is_same<TQ, __nv_bfloat16>::value ? 1 : 3;
  // how each operand goes to the tensor cores: a 16-bit q or pool (without
  // the quantized lane, whose dequantized values are float32) as it is, a
  // float32 one split (3xTF32) or rounded (one pass); P is float32
  static constexpr int kFp = kPasses > 1 ? kSplit : kRound;
  static constexpr int kQMode = sizeof(TQ) == 2 ? kExact : kFp;
  static constexpr int kKVMode = sizeof(TKV) == 2 && !KVQ ? kExact : kFp;
  // mma.sync per m16n8k8 step of Q K^T and of P V (mma_modes)
  static constexpr int kScorePasses = 1 + (kQMode == kSplit) + (kKVMode == kSplit);
  static constexpr int kValuePasses = 1 + (kFp == kSplit) + (kKVMode == kSplit);
  using Smem = ChunkSmem<DH, DV, kBN, TKV, KVQ>;
  static constexpr int kWN = Smem::kWN, kWK = Smem::kWK;
  static constexpr int kThreads = 128 * kWN * kWK;
  static_assert(Smem::kBytes <= kSmemMax, "chunk tile exceeds shared memory");
};

// K3. DH key lanes, DV value lanes. DV == DH is the GQA walk with keys and
// values from their own pools: two warps share each 16-row slice, each
// taking half of every key tile with a softmax state of its own, merged at
// the end. DV < DH is the MLA latent mode: one latent pool holds both
// (k_pool == v_pool, k_new == v_new; the wrappers check it), scores span
// all DH lanes and values are the first DV lanes of the same staged row;
// two warps share each 16-row slice, each reducing half of DH for the
// scores (exchanged through shared memory) and accumulating half of DV.
// Output is (B, C, H, DV).
template <typename TQ, typename TKV, int DH, int DV, bool KVQ>
__global__ void __launch_bounds__(ChunkCfg<TQ, TKV, DH, DV, KVQ>::kThreads, 1)
paged_chunk_kernel(const ChunkArgs a) {
  using Cfg = ChunkCfg<TQ, TKV, DH, DV, KVQ>;
  using SM = typename Cfg::Smem;
  constexpr int BN = Cfg::kBN, WN = Cfg::kWN, WK = Cfg::kWK;
  constexpr int NTHR = Cfg::kThreads;
  constexpr bool kLatent = SM::kLatent;
  static_assert(!(kLatent && KVQ), "the latent pool keeps fp blocks");
  static_assert(DH % (8 * WN) == 0 && DV % (8 * WN) == 0 && BN % (8 * WK) == 0,
                "mma tiling");
  constexpr int DK = DH / WN;       // score lanes a warp reduces
  constexpr int DVW = DV / WN;      // value lanes a warp accumulates
  constexpr int BNW = BN / WK;      // keys of a tile a warp takes
  constexpr int NT_S = BNW / 8;     // score n-tiles (8 keys each)
  constexpr int NT_O = DVW / 8;     // output n-tiles (8 lanes each)
  constexpr int kSets = NT_S >= 8 ? 1 : 8 / NT_S;
  static_assert(DK % (8 * kSets) == 0, "score k steps per accumulator set");
  // the quantized lane dequantizes a float32 pool's tile in place once it
  // lands; a 16-bit pool's as its fragments load (a 16-bit slot cannot
  // hold the float32 sum)
  constexpr bool kDequantStaged = KVQ && std::is_same<TKV, float>::value;
  constexpr bool kDequantLoads = KVQ && !kDequantStaged;
  constexpr int kFp = Cfg::kFp, kQMode = Cfg::kQMode, kKVMode = Cfg::kKVMode;
  constexpr int QS = SM::kQStride, KS = SM::kKStride, Q8S = SM::kQ8Stride;

  const TQ* __restrict__ q = static_cast<const TQ*>(a.q);
  const TKV* __restrict__ k_pool = static_cast<const TKV*>(a.k_pool);
  const TKV* __restrict__ v_pool = static_cast<const TKV*>(a.v_pool);
  const TKV* __restrict__ k_new = static_cast<const TKV*>(a.k_new);
  const TKV* __restrict__ v_new = static_cast<const TKV*>(a.v_new);
  TQ* __restrict__ out = static_cast<TQ*>(a.out);
  const int C = a.C, H = a.H, KVH = a.KVH, G = a.G, pos0 = a.pos0;

  extern __shared__ __align__(16) unsigned char chunk_smem[];
  float* Qs = reinterpret_cast<float*>(chunk_smem);
  unsigned char* stages = chunk_smem + SM::kQ;
  float* Sx = reinterpret_cast<float*>(stages + 2 * SM::kStage);

  // the last row tiles see the most keys: start them first
  const int tile = gridDim.x - 1 - blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp & 3;
  const int wn = WN > 1 ? warp >> 2 : 0, wk = WK > 1 ? warp >> 2 : 0;
  const int kb = wk * BNW;          // this warp's first key of a tile
  const int gid = lane >> 2, tig = lane & 3;
  const int n_rows = C * G;
  const int r0 = tile * kRowTile;
  const int r_last = min(r0 + kRowTile, n_rows) - 1;
  const int q_first = pos0 + r0 / G, q_last = pos0 + r_last / G;
  const bool warp_live = r0 + wm * 16 < n_rows;
  // this thread's two rows (mma layout: gid and gid + 8 of the warp's 16)
  const int ra = r0 + wm * 16 + gid, rb = ra + 8;
  const int qa = pos0 + ra / G, qb = pos0 + rb / G;

  // the Q tile as float; rows past C * G are zero
  constexpr int Q4 = DH / 4;
  for (int idx = tid; idx < kRowTile * Q4; idx += NTHR) {
    const int rr = idx / Q4, d = (idx - rr * Q4) * 4;
    const int r = r0 + rr;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < n_rows) {
      const int c = r / G, g = r - c * G;
      v = load4(q + (((size_t)b * C + c) * H + h * G + g) * DH + d);
    }
    *reinterpret_cast<float4*>(Qs + rr * QS + d) = v;
  }

  // Key positions [k_lo, k_hi): the pool below pos0 and then the chunk's
  // own keys (fused_new), or the pool up to the tile's last query.
  const int k_hi = q_last + 1;
  const int k_lo = a.window > 0 ? max(0, q_first - a.window + 1) : 0;
  const int n_tiles = (k_hi - k_lo + BN - 1) / BN;

  auto stage_at = [&](int s) { return stages + (size_t)s * SM::kStage; };

  // gather key tile `it` through the block table into stage `s`; true
  // where this thread staged a row of a quantized block (KVQ)
  auto gather = [&](int it, int s) {
    bool quantized = false;
    unsigned char* st = stage_at(s);
    TKV* Ks = reinterpret_cast<TKV*>(st);
    TKV* Vs = reinterpret_cast<TKV*>(st + SM::kKV);
    int8_t* Kq = reinterpret_cast<int8_t*>(st + SM::kKV * (kLatent ? 1 : 2));
    int8_t* Vq = Kq + SM::kQ8;
    float* dq = reinterpret_cast<float*>(st + SM::kKV * (kLatent ? 1 : 2) + 2 * SM::kQ8);
    const int p0 = k_lo + it * BN;
    constexpr int kPieces = DH * static_cast<int>(sizeof(TKV)) / 16;   // of a row
    constexpr int kRowPieces = kPieces + (KVQ ? DH / 16 : 0);
    for (int idx = tid; idx < BN * kRowPieces; idx += NTHR) {
      const int t = idx / kRowPieces, pc = idx - t * kRowPieces;
      const int p = p0 + t;
      const bool valid = p < k_hi;                 // else zero-filled
      const bool own = a.fused_new && p >= pos0;   // the chunk's own key
      int blk = 0;
      size_t off = 0;
      if (valid) {
        if (own) {
          off = (((size_t)b * C + (p - pos0)) * KVH + h) * DH;
        } else {
          const int nb = p / a.bs;
          blk = __ldg(a.tables + (size_t)b * a.nb_t + nb);
          off = (((size_t)blk * a.bs + (p - nb * a.bs)) * KVH + h) * DH;
        }
      }
      if (pc < kPieces) {
        const int e = pc * (16 / static_cast<int>(sizeof(TKV)));
        cp_async16(Ks + t * KS + e, (own ? k_new : k_pool) + off + e, valid);
        if constexpr (!kLatent)
          cp_async16(Vs + t * KS + e, (own ? v_new : v_pool) + off + e, valid);
      } else if constexpr (KVQ) {
        const int e = (pc - kPieces) * 16;
        const bool pooled = valid && !own;
        cp_async16(Kq + t * Q8S + e, a.kvq.qk + off + e, pooled);
        cp_async16(Vq + t * Q8S + e, a.kvq.qv + off + e, pooled);
        if (e == 0) {   // one thread a key: its block's dequant floats
          const float ks = pooled ? __ldg(a.kvq.k_scale + blk) : 0.f;
          const float kz = pooled ? __ldg(a.kvq.k_zero + blk) : 0.f;
          const float vs = pooled ? __ldg(a.kvq.v_scale + blk) : 0.f;
          const float vz = pooled ? __ldg(a.kvq.v_zero + blk) : 0.f;
          dq[t] = ks;
          dq[BN + t] = kz;
          dq[2 * BN + t] = vs;
          dq[3 * BN + t] = vz;
          quantized |= ks != 0.f || kz != 0.f || vs != 0.f || vz != 0.f;
        }
      }
    }
    return quantized;
  };

  float acc[NT_O][4];
#pragma unroll
  for (int i = 0; i < NT_O; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;   // l: this thread's share

  // one key tile: scores, the online softmax, P V
  auto consume = [&](int it, int s) {
    const unsigned char* st = stage_at(s);
    const TKV* Ks = reinterpret_cast<const TKV*>(st);
    const TKV* Vs = kLatent ? Ks : reinterpret_cast<const TKV*>(st + SM::kKV);
    const int8_t* Kq = reinterpret_cast<const int8_t*>(st + SM::kKV * (kLatent ? 1 : 2));
    const int8_t* Vq = Kq + SM::kQ8;
    const float* dq =
        reinterpret_cast<const float*>(st + SM::kKV * (kLatent ? 1 : 2) + 2 * SM::kQ8);
    const int p0 = k_lo + it * BN;

    float sc[NT_S][4];
#pragma unroll
    for (int i = 0; i < NT_S; ++i) sc[i][0] = sc[i][1] = sc[i][2] = sc[i][3] = 0.f;
    if (warp_live) {
      float kscale[NT_S], kzero[NT_S];
#pragma unroll
      for (int nt = 0; nt < NT_S; ++nt) {
        kscale[nt] = kDequantLoads ? dq[kb + nt * 8 + gid] : 0.f;
        kzero[nt] = kDequantLoads ? dq[BN + kb + nt * 8 + gid] : 0.f;
      }
      // kSets accumulators over alternating k steps, so that at least 8
      // independent mma chains are in flight (BN = 16 has only 2 n-tiles)
      float part[kSets][NT_S][4];
#pragma unroll
      for (int u = 0; u < kSets; ++u)
#pragma unroll
        for (int nt = 0; nt < NT_S; ++nt)
          part[u][nt][0] = part[u][nt][1] = part[u][nt][2] = part[u][nt][3] = 0.f;
      const float* qrow = Qs + (wm * 16 + gid) * QS + wn * DK + tig;
#pragma unroll 2
      for (int k0 = 0; k0 < DK; k0 += 8 * kSets) {
#pragma unroll
        for (int u = 0; u < kSets; ++u) {
          const int kk = k0 + 8 * u;
          uint32_t ab[4], as[4];
          to_tf32<kQMode>(qrow[kk], ab[0], as[0]);
          to_tf32<kQMode>(qrow[kk + 8 * QS], ab[1], as[1]);
          to_tf32<kQMode>(qrow[kk + 4], ab[2], as[2]);
          to_tf32<kQMode>(qrow[kk + 8 * QS + 4], ab[3], as[3]);
          const int d = wn * DK + kk + tig;
#pragma unroll
          for (int nt = 0; nt < NT_S; ++nt) {
            const int n = kb + nt * 8 + gid;
            uint32_t bb0, bs0, bb1, bs1;
            to_tf32<kKVMode>(
                staged<kDequantLoads, KS, Q8S>(Ks, Kq, n, d, kscale[nt], kzero[nt]), bb0,
                bs0);
            to_tf32<kKVMode>(
                staged<kDequantLoads, KS, Q8S>(Ks, Kq, n, d + 4, kscale[nt], kzero[nt]),
                bb1, bs1);
            mma_modes<kQMode, kKVMode>(part[u][nt], ab, as, bb0, bb1, bs0, bs1);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kSets; ++u)
#pragma unroll
        for (int nt = 0; nt < NT_S; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) sc[nt][i] += part[u][nt][i];
    }
    if constexpr (WN > 1) {   // add the value halves' partial scores
      float* mine = Sx + (size_t)wn * kRowTile * BN;
      const int row = wm * 16 + gid;
#pragma unroll
      for (int nt = 0; nt < NT_S; ++nt) {
        const int col = nt * 8 + 2 * tig;
        *reinterpret_cast<float2*>(mine + row * BN + col) = make_float2(sc[nt][0], sc[nt][1]);
        *reinterpret_cast<float2*>(mine + (row + 8) * BN + col) =
            make_float2(sc[nt][2], sc[nt][3]);
      }
      __syncthreads();
#pragma unroll
      for (int nt = 0; nt < NT_S; ++nt) {
        const int col = nt * 8 + 2 * tig;
        float2 u = make_float2(0.f, 0.f), w = make_float2(0.f, 0.f);
#pragma unroll
        for (int x = 0; x < WN; ++x) {   // fixed order: both warps sum alike
          const float* part = Sx + (size_t)x * kRowTile * BN;
          const float2 pu = *reinterpret_cast<const float2*>(part + row * BN + col);
          const float2 pw = *reinterpret_cast<const float2*>(part + (row + 8) * BN + col);
          u.x += pu.x; u.y += pu.y; w.x += pw.x; w.y += pw.y;
        }
        sc[nt][0] = u.x; sc[nt][1] = u.y; sc[nt][2] = w.x; sc[nt][3] = w.y;
      }
    }
    if (!warp_live) return;

    // scale, softcap, to base-2 units, mask (masked -> -inf, so 2^x gives
    // exactly 0), max
    float mx_a = neg_inf(), mx_b = neg_inf();
#pragma unroll
    for (int nt = 0; nt < NT_S; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kp = p0 + kb + nt * 8 + 2 * tig + j;
        const bool va = kp <= qa && (a.window <= 0 || kp > qa - a.window);
        const bool vb = kp <= qb && (a.window <= 0 || kp > qb - a.window);
        const float sa = cap_logit(sc[nt][j] * a.scale, a.softcap) * kLog2e;
        const float sb = cap_logit(sc[nt][2 + j] * a.scale, a.softcap) * kLog2e;
        sc[nt][j] = va ? sa : neg_inf();
        sc[nt][2 + j] = vb ? sb : neg_inf();
        mx_a = fmaxf(mx_a, sc[nt][j]);
        mx_b = fmaxf(mx_b, sc[nt][2 + j]);
      }
    }
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float ca = exp2_approx(m_a - mn_a), cb = exp2_approx(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT_S; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        sc[nt][j] = exp2_approx(sc[nt][j] - mn_a);
        sc[nt][2 + j] = exp2_approx(sc[nt][2 + j] - mn_b);
        sum_a += sc[nt][j];
        sum_b += sc[nt][2 + j];
      }
    }
    l_a = l_a * ca + sum_a;
    l_b = l_b * cb + sum_b;
#pragma unroll
    for (int no = 0; no < NT_O; ++no) {
      acc[no][0] *= ca; acc[no][1] *= ca;
      acc[no][2] *= cb; acc[no][3] *= cb;
    }

    // P V. P stays in its accumulator layout: within each 8-key step the
    // k index t of the A fragment is key 2t and t + 4 is key 2t + 1, so
    // the V fragment reads keys 2t and 2t + 1.
#pragma unroll
    for (int kt = 0; kt < NT_S; ++kt) {
      uint32_t ab[4], as[4];
      to_tf32<kFp>(sc[kt][0], ab[0], as[0]);
      to_tf32<kFp>(sc[kt][2], ab[1], as[1]);
      to_tf32<kFp>(sc[kt][1], ab[2], as[2]);
      to_tf32<kFp>(sc[kt][3], ab[3], as[3]);
      const int n0 = kb + kt * 8 + 2 * tig;
      const float vs0 = kDequantLoads ? dq[2 * BN + n0] : 0.f;
      const float vz0 = kDequantLoads ? dq[3 * BN + n0] : 0.f;
      const float vs1 = kDequantLoads ? dq[2 * BN + n0 + 1] : 0.f;
      const float vz1 = kDequantLoads ? dq[3 * BN + n0 + 1] : 0.f;
#pragma unroll
      for (int no = 0; no < NT_O; ++no) {
        const int d = wn * DVW + no * 8 + gid;
        uint32_t bb0, bs0, bb1, bs1;
        to_tf32<kKVMode>(staged<kDequantLoads, KS, Q8S>(Vs, Vq, n0, d, vs0, vz0), bb0, bs0);
        to_tf32<kKVMode>(staged<kDequantLoads, KS, Q8S>(Vs, Vq, n0 + 1, d, vs1, vz1), bb1,
                         bs1);
        mma_modes<kFp, kKVMode>(acc[no], ab, as, bb0, bb1, bs0, bs1);
      }
    }
  };

  // the quantized lane on a float32 pool: fp + q * scale + zero in place
  auto dequant_stage = [&](int s) {
    unsigned char* st = stage_at(s);
    float* Ks = reinterpret_cast<float*>(st);
    float* Vs = reinterpret_cast<float*>(st + SM::kKV);
    const int8_t* Kq = reinterpret_cast<const int8_t*>(st + 2 * SM::kKV);
    const int8_t* Vq = Kq + SM::kQ8;
    const float* dq = reinterpret_cast<const float*>(st + 2 * SM::kKV + 2 * SM::kQ8);
    constexpr int D4 = DH / 4;
    for (int idx = tid; idx < BN * D4; idx += NTHR) {
      const int t = idx / D4, d = (idx - t * D4) * 4;
      const float ks = dq[t], kz = dq[BN + t], vs = dq[2 * BN + t], vz = dq[3 * BN + t];
      float4 k = *reinterpret_cast<const float4*>(Ks + t * KS + d);
      float4 v = *reinterpret_cast<const float4*>(Vs + t * KS + d);
      const char4 qk = *reinterpret_cast<const char4*>(Kq + t * Q8S + d);
      const char4 qv = *reinterpret_cast<const char4*>(Vq + t * Q8S + d);
      k.x = k.x + static_cast<float>(qk.x) * ks + kz;
      k.y = k.y + static_cast<float>(qk.y) * ks + kz;
      k.z = k.z + static_cast<float>(qk.z) * ks + kz;
      k.w = k.w + static_cast<float>(qk.w) * ks + kz;
      v.x = v.x + static_cast<float>(qv.x) * vs + vz;
      v.y = v.y + static_cast<float>(qv.y) * vs + vz;
      v.z = v.z + static_cast<float>(qv.z) * vs + vz;
      v.w = v.w + static_cast<float>(qv.w) * vs + vz;
      *reinterpret_cast<float4*>(Ks + t * KS + d) = k;
      *reinterpret_cast<float4*>(Vs + t * KS + d) = v;
    }
  };

  // two stages: tile it + 1 is in flight while tile it computes. A tile
  // with no quantized block (fp blocks and the chunk's own keys: scale and
  // zero 0, so the FMA is the identity) skips the dequant pass.
  bool q_next = gather(0, 0);
  cp_async_commit();
  for (int it = 0; it < n_tiles; ++it) {
    const bool q_cur = q_next;
    if (it + 1 < n_tiles) q_next = gather(it + 1, (it + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    if constexpr (kDequantStaged) {
      if (__syncthreads_or(q_cur)) {
        dequant_stage(it & 1);
        __syncthreads();
      }
    } else {
      __syncthreads();
    }
    consume(it, it & 1);
    __syncthreads();
  }

  l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
  if constexpr (WK > 1) {   // the second key half hands its state over
    float* Mx = reinterpret_cast<float*>(stages);   // free after the last barrier
    constexpr int MS = DV + 4;
    const int row = wm * 16 + gid;
    if (wk == 1 && warp_live) {
#pragma unroll
      for (int no = 0; no < NT_O; ++no) {
        const int col = no * 8 + 2 * tig;
        *reinterpret_cast<float2*>(Mx + row * MS + col) = make_float2(acc[no][0], acc[no][1]);
        *reinterpret_cast<float2*>(Mx + (row + 8) * MS + col) =
            make_float2(acc[no][2], acc[no][3]);
      }
      if (tig == 0) {
        Mx[row * MS + DV] = m_a;
        Mx[row * MS + DV + 1] = l_a;
        Mx[(row + 8) * MS + DV] = m_b;
        Mx[(row + 8) * MS + DV + 1] = l_b;
      }
    }
    __syncthreads();
    if (wk == 1) return;
    if (warp_live) {
      const float m2a = Mx[row * MS + DV], l2a = Mx[row * MS + DV + 1];
      const float m2b = Mx[(row + 8) * MS + DV], l2b = Mx[(row + 8) * MS + DV + 1];
      const float ma = fmaxf(m_a, m2a), mb = fmaxf(m_b, m2b);
      const float e1a = exp2_approx(m_a - ma), e2a = exp2_approx(m2a - ma);
      const float e1b = exp2_approx(m_b - mb), e2b = exp2_approx(m2b - mb);
      l_a = l_a * e1a + l2a * e2a;
      l_b = l_b * e1b + l2b * e2b;
#pragma unroll
      for (int no = 0; no < NT_O; ++no) {
        const int col = no * 8 + 2 * tig;
        const float2 pa = *reinterpret_cast<const float2*>(Mx + row * MS + col);
        const float2 pb = *reinterpret_cast<const float2*>(Mx + (row + 8) * MS + col);
        acc[no][0] = acc[no][0] * e1a + pa.x * e2a;
        acc[no][1] = acc[no][1] * e1a + pa.y * e2a;
        acc[no][2] = acc[no][2] * e1b + pb.x * e2b;
        acc[no][3] = acc[no][3] * e1b + pb.y * e2b;
      }
    }
  }
  if (!warp_live) return;
  const float da = fmaxf(l_a, 1e-30f), db = fmaxf(l_b, 1e-30f);
  if (ra < n_rows) {
    const int c = ra / G, g = ra - c * G;
    TQ* o = out + (((size_t)b * C + c) * H + h * G + g) * DV + wn * DVW + 2 * tig;
#pragma unroll
    for (int no = 0; no < NT_O; ++no) store2(o + no * 8, acc[no][0] / da, acc[no][1] / da);
  }
  if (rb < n_rows) {
    const int c = rb / G, g = rb - c * G;
    TQ* o = out + (((size_t)b * C + c) * H + h * G + g) * DV + wn * DVW + 2 * tig;
#pragma unroll
    for (int no = 0; no < NT_O; ++no) store2(o + no * 8, acc[no][2] / db, acc[no][3] / db);
  }
}

// One instantiation of K3: its plan and its launch.
template <typename TQ, typename TKV, int DH, int DV, bool KVQ>
struct ChunkKernel {
  using Cfg = ChunkCfg<TQ, TKV, DH, DV, KVQ>;

  // {dynamic shared bytes, key tile, mma passes of Q K^T, mma passes of
  // P V, threads, row tile}
  static void plan(int* p) {
    p[0] = static_cast<int>(Cfg::Smem::kBytes);
    p[1] = Cfg::kBN;
    p[2] = Cfg::kScorePasses;
    p[3] = Cfg::kValuePasses;
    p[4] = Cfg::kThreads;
    p[5] = kRowTile;
  }

  static cudaError_t launch(const ChunkArgs& a, cudaStream_t stream) {
    constexpr int bytes = static_cast<int>(Cfg::Smem::kBytes);
    auto kern = paged_chunk_kernel<TQ, TKV, DH, DV, KVQ>;
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    const dim3 grid((a.C * a.G + kRowTile - 1) / kRowTile, a.KVH, a.B);
    kern<<<grid, Cfg::kThreads, bytes, stream>>>(a);
    return cudaGetLastError();
  }
};

}  // namespace
