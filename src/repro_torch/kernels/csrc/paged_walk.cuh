// The block walk shared by the paged-attention kernels: the online-softmax
// update, the quantized-KV dequant helpers, and the chunk-prefill walk K3
// (`paged_chunk_kernel`). Included by paged_attention.cu (K2, and K3 with
// and without its quantized-KV lane) and by paged_attention_mla.cu (K3's
// MLA latent mode), so that each library instantiates only what it uses
// and the two build in parallel. Design notes are at the top of
// paged_attention.cu (K2, K3, the quantized lane) and of
// paged_attention_mla.cu (the latent mode).
#pragma once
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 4;  // chunk rows per warp
constexpr int kTileRows = kWarps * kRowsPerWarp;
constexpr float kNegInf = -1e30f;

// one online-softmax update of a row's state with key score s and value v
template <int DPL>
__device__ __forceinline__ void online_update(float s, const float (&v)[DPL],
                                              float& m, float& l, float (&acc)[DPL]) {
  const float m_new = fmaxf(m, s);
  const float corr = expf(m - m_new);
  const float p = expf(s - m_new);
  l = l * corr + p;
#pragma unroll
  for (int i = 0; i < DPL; ++i) acc[i] = acc[i] * corr + p * v[i];
  m = m_new;
}

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

// per-block dequant parameters (all zero without the lane)
struct BlockDequant {
  float ks = 0.f, kz = 0.f, vs = 0.f, vz = 0.f;
};

template <bool KVQ>
__device__ __forceinline__ BlockDequant block_dequant(const KVQuant& kvq, int blk) {
  BlockDequant d;
  if constexpr (KVQ) {
    d.ks = kvq.k_scale[blk];
    d.kz = kvq.k_zero[blk];
    d.vs = kvq.v_scale[blk];
    d.vz = kvq.v_zero[blk];
  }
  return d;
}

// pool element `off` of k and v as float, dequantized on the KVQ lane
template <bool KVQ, typename TKV>
__device__ __forceinline__ void load_kv(const TKV* __restrict__ k_pool,
                                        const TKV* __restrict__ v_pool,
                                        const KVQuant& kvq, const BlockDequant& d,
                                        size_t off, float& k, float& v) {
  k = morph::to_f32(k_pool[off]);
  v = morph::to_f32(v_pool[off]);
  if constexpr (KVQ) {
    k = k + static_cast<float>(kvq.qk[off]) * d.ks + d.kz;
    v = v + static_cast<float>(kvq.qv[off]) * d.vs + d.vz;
  }
}

// K3. DPL = Dh / 32 key lanes per thread, DPLV = Dv / 32 value lanes.
// DPLV == DPL is the GQA walk, with keys and values staged from their own
// pools. DPLV < DPL is the MLA latent mode: one latent pool holds both
// (k_pool == v_pool, k_new == v_new; the wrappers check it), scores span
// all Dh lanes and the values are the first Dv lanes of the same row, so a
// block is staged once (bs * Dh floats) and values are read from the
// staged key rows. Output is (B, C, H, Dv).
template <typename TQ, typename TKV, int DPL, int DPLV, bool KVQ>
__global__ void __launch_bounds__(kThreads)
paged_chunk_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k_pool,
                   const TKV* __restrict__ v_pool, const TKV* __restrict__ k_new,
                   const TKV* __restrict__ v_new, const int* __restrict__ tables,
                   int pos0, TQ* __restrict__ out, int C, int H, int KVH, int G,
                   int bs, int nb_t, float scale, int window, float softcap,
                   int fused_new, KVQuant kvq) {
  constexpr int Dh = DPL * 32;
  constexpr int Dv = DPLV * 32;
  constexpr bool kLatent = DPLV != DPL;
  static_assert(DPLV <= DPL, "values are at most as wide as keys");
  static_assert(!(kLatent && KVQ), "the latent pool keeps fp blocks");
  // ks[bs][Dh], then vs[bs][Dh] (the latent mode reads values from ks)
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = kLatent ? smem : smem + (size_t)bs * Dh;
  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_rows = C * G;
  const int r0 = tile * kTileRows;
  const int r_last = min(r0 + kTileRows, n_rows) - 1;
  const int q_first = pos0 + r0 / G;   // the tile's earliest query position
  const int q_last = pos0 + r_last / G;

  float qr[kRowsPerWarp][DPL], acc[kRowsPerWarp][DPLV];
  float m[kRowsPerWarp], l[kRowsPerWarp];
  int qi[kRowsPerWarp];
  bool live[kRowsPerWarp];
#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j) {
    const int r = r0 + warp * kRowsPerWarp + j;
    live[j] = r < n_rows;
    const int c = live[j] ? r / G : 0, g = live[j] ? r - (r / G) * G : 0;
    qi[j] = pos0 + c;
    m[j] = kNegInf;
    l[j] = 0.f;
#pragma unroll
    for (int i = 0; i < DPLV; ++i) acc[j][i] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i)
      qr[j][i] = live[j]
          ? morph::to_f32(q[(((size_t)b * C + c) * H + h * G + g) * Dh + lane * DPL + i])
          : 0.f;
  }

  // one staged key row against this warp's rows
  auto visit = [&](int kpos, int t, bool chunk_key) {
    float kv[DPL], vv[DPLV];
#pragma unroll
    for (int i = 0; i < DPL; ++i) kv[i] = ks[(size_t)t * Dh + lane * DPL + i];
#pragma unroll
    for (int i = 0; i < DPLV; ++i) vv[i] = vs[(size_t)t * Dh + lane * DPLV + i];
#pragma unroll
    for (int j = 0; j < kRowsPerWarp; ++j) {
      if (!live[j]) continue;
      bool vis;
      if (chunk_key) vis = kpos <= qi[j];             // chunk key j' <= i
      else vis = fused_new ? kpos < pos0 : kpos <= qi[j];
      if (window > 0) vis = vis && kpos > qi[j] - window;
      if (!vis) continue;
      float d = 0.f;
#pragma unroll
      for (int i = 0; i < DPL; ++i) d = fmaf(qr[j][i], kv[i], d);
      const float s = cap_logit(morph::warp_sum(d) * scale, softcap);
      online_update<DPLV>(s, vv, m[j], l[j], acc[j]);
    }
  };

  // 1. the pool walk
  const int frontier = fused_new ? pos0 : q_last + 1;
  const int n_blocks = min(nb_t, (frontier + bs - 1) / bs);
  int first = 0;
  if (window > 0 && q_first - window + 1 > 0) first = (q_first - window + 1) / bs;
  for (int nb = first; nb < n_blocks; ++nb) {
    const int blk = tables[(size_t)b * nb_t + nb];
    const BlockDequant dq = block_dequant<KVQ>(kvq, blk);
    __syncthreads();
    for (int idx = threadIdx.x; idx < bs * Dh; idx += kThreads) {
      const int t = idx / Dh, d = idx - (idx / Dh) * Dh;
      const size_t off = (((size_t)blk * bs + t) * KVH + h) * Dh + d;
      if constexpr (kLatent) ks[idx] = morph::to_f32(k_pool[off]);
      else load_kv<KVQ>(k_pool, v_pool, kvq, dq, off, ks[idx], vs[idx]);
    }
    __syncthreads();
    for (int t = 0; t < bs; ++t) {
      const int kpos = nb * bs + t;
      if (kpos >= frontier) break;
      visit(kpos, t, false);
    }
  }

  // 2. the chunk's own keys (fused_new): key j sits at position pos0 + j
  if (fused_new) {
    const int j_last = r_last / G;
    int j_first = 0;
    if (window > 0 && r0 / G - window + 1 > 0) j_first = r0 / G - window + 1;
    for (int j0 = j_first; j0 <= j_last; j0 += bs) {
      const int n = min(bs, j_last + 1 - j0);
      __syncthreads();
      for (int idx = threadIdx.x; idx < n * Dh; idx += kThreads) {
        const int t = idx / Dh, d = idx - (idx / Dh) * Dh;
        const size_t off = (((size_t)b * C + j0 + t) * KVH + h) * Dh + d;
        ks[idx] = morph::to_f32(k_new[off]);
        if constexpr (!kLatent) vs[idx] = morph::to_f32(v_new[off]);
      }
      __syncthreads();
      for (int t = 0; t < n; ++t) visit(pos0 + j0 + t, t, true);
    }
  }

#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j) {
    if (!live[j]) continue;
    const int r = r0 + warp * kRowsPerWarp + j;
    const int c = r / G, g = r - (r / G) * G;
#pragma unroll
    for (int i = 0; i < DPLV; ++i)
      out[(((size_t)b * C + c) * H + h * G + g) * Dv + lane * DPLV + i] =
          morph::from_f32<TQ>(acc[j][i] / fmaxf(l[j], 1e-30f));
  }
}

}  // namespace
