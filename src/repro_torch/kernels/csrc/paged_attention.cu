// Paged attention over a block-table KV pool: the decode block walk (K2)
// and the chunk-prefill block walk (K3).
//
// Replaces the Pallas TPU kernels `_paged_attn_kernel` (via `_paged_call`:
// `paged_attention_fused`, `paged_attention`) and `_chunk_attn_kernel`
// (via `_chunk_call`: `paged_chunk_attention_fused`,
// `paged_chunk_attention`) of src/repro/kernels/paged_attention.py.
//
// Layout (the JAX package's): pools (cap, bs, KVH, Dh); block tables
// (B, nb) int32 whose entries past a sequence's live length are scratch
// id 0 and are never read; q (B, H, Dh) for decode and (B, C, H, Dh) for a
// chunk, with query head h*G + g served by kv head h (G = H / KVH).
//
// What bounds them on the H100: decode (K2) reads each live context token's
// K and V once (2 * KVH * Dh * 4 bytes a token in a float32 pool) for
// 4 * G * Dh FLOPs: bytes. A chunk (K3) reads the context once per CTA row
// tile and does 4 * C * G * Dh FLOPs per key: at C = 256 it is bounded by
// operations, at C = 16 by bytes.
//
// Design. On the TPU the block walk is the innermost, sequential grid axis
// with the softmax state carried in VMEM scratch from step to step. Here
// CTAs run in parallel and nothing carries between them, so the walk is a
// loop inside one CTA. Each CTA loads its own table entries and never reads
// an entry past ceil(frontier / bs), nor one wholly outside the window.
// Softmax state (running max m, sum l, accumulator) lives in registers; a
// warp's lanes split Dh and reduce the q.k dot with shuffles. Keys a row
// may not see are skipped outright, which is the same as the TPU kernel's
// explicit zeroing of masked probabilities: a row whose running max is
// still empty never picks up exp(0) weight. Masked logits are -1e30 and the
// denominator floor is 1e-30, as on the TPU. Accumulation is float; the
// output is written in q's dtype.
//
// K2: one CTA per (kv head, sequence), four warps. Each warp walks every
// fourth pool block independently with its own (m, l, acc) for the G rows,
// then the warps merge through shared memory. With fused_new the current
// token (k_new, v_new) is folded in last; it sits at position ctx_len and
// is always visible. Without it the query is the newest pool token at
// ctx_len - 1.
//
// K3: one CTA per (row tile of 16 rows, kv head, sequence); row r is chunk
// token r / G at absolute position pos0 + r / G. A 256 x 128 float q tile
// would take 128 KB, so rows are tiled: each warp owns 4 rows in registers.
// Every pool block below the frontier (pos0 with fused_new, else the
// tile's last query + 1) is staged in shared memory as float and shared by
// the four warps; window block skip keys to the tile's first query, which
// skips only blocks every row of the tile masks anyway. With fused_new the
// chunk's own keys follow, staged the same way, under the intra-chunk
// causal mask (key j visible to token i iff j <= i, then the window). Pad
// rows of the padded chunk are computed like any row; rows past C * G do
// not exist and are neither read nor written.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxG = 8;         // decode rows per kv head held in registers
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

template <typename TQ, typename TKV, int DPL>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k_pool,
                    const TKV* __restrict__ v_pool, const TKV* __restrict__ k_new,
                    const TKV* __restrict__ v_new, const int* __restrict__ tables,
                    const int* __restrict__ lens, TQ* __restrict__ out, int H,
                    int KVH, int G, int bs, int nb_t, float scale, int window,
                    float softcap, int fused_new) {
  constexpr int Dh = DPL * 32;
  extern __shared__ float smem[];  // kWarps * G * (Dh + 2)
  const int h = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ctx = lens[b];
  const int qpos = fused_new ? ctx : ctx - 1;

  float qr[kMaxG][DPL], acc[kMaxG][DPL], m[kMaxG], l[kMaxG];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      acc[g][i] = 0.f;
      qr[g][i] = g < G ? morph::to_f32(q[((size_t)b * H + h * G + g) * Dh + lane * DPL + i]) : 0.f;
    }
  }

  const int n_blocks = min(nb_t, (ctx + bs - 1) / bs);
  int first = 0;
  if (window > 0 && qpos - window + 1 > 0) first = (qpos - window + 1) / bs;
  for (int nb = first + warp; nb < n_blocks; nb += kWarps) {
    const int blk = tables[(size_t)b * nb_t + nb];
    for (int t = 0; t < bs; ++t) {
      const int pos = nb * bs + t;
      if (pos >= ctx) break;
      if (window > 0 && pos <= qpos - window) continue;
      const size_t off = (((size_t)blk * bs + t) * KVH + h) * Dh + lane * DPL;
      float kv[DPL], vv[DPL];
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        kv[i] = morph::to_f32(k_pool[off + i]);
        vv[i] = morph::to_f32(v_pool[off + i]);
      }
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g >= G) break;
        float d = 0.f;
#pragma unroll
        for (int i = 0; i < DPL; ++i) d = fmaf(qr[g][i], kv[i], d);
        const float s = cap_logit(morph::warp_sum(d) * scale, softcap);
        online_update<DPL>(s, vv, m[g], l[g], acc[g]);
      }
    }
  }
  if (fused_new && warp == 0) {
    const size_t off = ((size_t)b * KVH + h) * Dh + lane * DPL;
    float kv[DPL], vv[DPL];
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      kv[i] = morph::to_f32(k_new[off + i]);
      vv[i] = morph::to_f32(v_new[off + i]);
    }
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g >= G) break;
      float d = 0.f;
#pragma unroll
      for (int i = 0; i < DPL; ++i) d = fmaf(qr[g][i], kv[i], d);
      const float s = cap_logit(morph::warp_sum(d) * scale, softcap);
      online_update<DPL>(s, vv, m[g], l[g], acc[g]);
    }
  }

  // merge the warps' states: smem[w][g] = (m, l, acc[0..Dh))
  const int stride = Dh + 2;
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (g >= G) break;
    float* row = smem + ((size_t)warp * G + g) * stride;
    if (lane == 0) {
      row[0] = m[g];
      row[1] = l[g];
    }
#pragma unroll
    for (int i = 0; i < DPL; ++i) row[2 + lane * DPL + i] = acc[g][i];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * Dh; idx += kThreads) {
    const int g = idx / Dh, d = idx - (idx / Dh) * Dh;
    float mm = kNegInf;
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, smem[((size_t)w * G + g) * stride]);
    float ll = 0.f, aa = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float* row = smem + ((size_t)w * G + g) * stride;
      const float e = expf(row[0] - mm);
      ll += row[1] * e;
      aa += row[2 + d] * e;
    }
    out[((size_t)b * H + h * G + g) * Dh + d] = morph::from_f32<TQ>(aa / fmaxf(ll, 1e-30f));
  }
}

template <typename TQ, typename TKV, int DPL>
__global__ void __launch_bounds__(kThreads)
paged_chunk_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k_pool,
                   const TKV* __restrict__ v_pool, const TKV* __restrict__ k_new,
                   const TKV* __restrict__ v_new, const int* __restrict__ tables,
                   int pos0, TQ* __restrict__ out, int C, int H, int KVH, int G,
                   int bs, int nb_t, float scale, int window, float softcap,
                   int fused_new) {
  constexpr int Dh = DPL * 32;
  extern __shared__ float smem[];  // ks[bs][Dh], vs[bs][Dh]
  float* ks = smem;
  float* vs = smem + (size_t)bs * Dh;
  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_rows = C * G;
  const int r0 = tile * kTileRows;
  const int r_last = min(r0 + kTileRows, n_rows) - 1;
  const int q_first = pos0 + r0 / G;   // the tile's earliest query position
  const int q_last = pos0 + r_last / G;

  float qr[kRowsPerWarp][DPL], acc[kRowsPerWarp][DPL];
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
    for (int i = 0; i < DPL; ++i) {
      acc[j][i] = 0.f;
      qr[j][i] = live[j]
          ? morph::to_f32(q[(((size_t)b * C + c) * H + h * G + g) * Dh + lane * DPL + i])
          : 0.f;
    }
  }

  // one staged key row against this warp's rows
  auto visit = [&](int kpos, int t, bool chunk_key) {
    float kv[DPL], vv[DPL];
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      kv[i] = ks[(size_t)t * Dh + lane * DPL + i];
      vv[i] = vs[(size_t)t * Dh + lane * DPL + i];
    }
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
      online_update<DPL>(s, vv, m[j], l[j], acc[j]);
    }
  };

  // 1. the pool walk
  const int frontier = fused_new ? pos0 : q_last + 1;
  const int n_blocks = min(nb_t, (frontier + bs - 1) / bs);
  int first = 0;
  if (window > 0 && q_first - window + 1 > 0) first = (q_first - window + 1) / bs;
  for (int nb = first; nb < n_blocks; ++nb) {
    const int blk = tables[(size_t)b * nb_t + nb];
    __syncthreads();
    for (int idx = threadIdx.x; idx < bs * Dh; idx += kThreads) {
      const int t = idx / Dh, d = idx - (idx / Dh) * Dh;
      const size_t off = (((size_t)blk * bs + t) * KVH + h) * Dh + d;
      ks[idx] = morph::to_f32(k_pool[off]);
      vs[idx] = morph::to_f32(v_pool[off]);
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
        vs[idx] = morph::to_f32(v_new[off]);
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
    for (int i = 0; i < DPL; ++i)
      out[(((size_t)b * C + c) * H + h * G + g) * Dh + lane * DPL + i] =
          morph::from_f32<TQ>(acc[j][i] / fmaxf(l[j], 1e-30f));
  }
}

template <typename F>
cudaError_t dispatch_dpl(int Dh, F&& f) {
  switch (Dh) {
    case 32: f(std::integral_constant<int, 1>{}); break;
    case 64: f(std::integral_constant<int, 2>{}); break;
    case 128: f(std::integral_constant<int, 4>{}); break;
    case 256: f(std::integral_constant<int, 8>{}); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

}  // namespace

// C entry points. The wrappers have checked shapes, dtypes and contiguity;
// k_new / v_new may be null when fused_new is 0. Each returns
// cudaGetLastError() after the launch.
extern "C" int morph_paged_decode(const void* q, int q_dtype, const void* k_pool,
                                  const void* v_pool, int kv_dtype, const void* k_new,
                                  const void* v_new, const void* tables,
                                  const void* lens, void* out, int B, int H, int KVH,
                                  int Dh, int bs, int nb_t, float scale, int window,
                                  float softcap, int fused_new, void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  const int G = H / KVH;
  if (G > kMaxG) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)kWarps * G * (Dh + 2) * sizeof(float);
  cudaError_t err = cudaSuccess;
  MORPH_DISPATCH_DTYPE(q_dtype, TQ, {
    MORPH_DISPATCH_DTYPE(kv_dtype, TKV, {
      err = dispatch_dpl(Dh, [&](auto dpl) {
        constexpr int DPL = decltype(dpl)::value;
        paged_decode_kernel<TQ, TKV, DPL><<<dim3(KVH, B), kThreads, smem, stream>>>(
            static_cast<const TQ*>(q), static_cast<const TKV*>(k_pool),
            static_cast<const TKV*>(v_pool), static_cast<const TKV*>(k_new),
            static_cast<const TKV*>(v_new), static_cast<const int*>(tables),
            static_cast<const int*>(lens), static_cast<TQ*>(out), H, KVH, G, bs,
            nb_t, scale, window, softcap, fused_new);
      });
    });
  });
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" int morph_paged_chunk(const void* q, int q_dtype, const void* k_pool,
                                 const void* v_pool, int kv_dtype, const void* k_new,
                                 const void* v_new, const void* tables, int pos0,
                                 void* out, int B, int C, int H, int KVH, int Dh,
                                 int bs, int nb_t, float scale, int window,
                                 float softcap, int fused_new, void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  const int G = H / KVH;
  const size_t smem = (size_t)2 * bs * Dh * sizeof(float);
  const dim3 grid((C * G + kTileRows - 1) / kTileRows, KVH, B);
  cudaError_t err = cudaSuccess;
  MORPH_DISPATCH_DTYPE(q_dtype, TQ, {
    MORPH_DISPATCH_DTYPE(kv_dtype, TKV, {
      err = dispatch_dpl(Dh, [&](auto dpl) {
        constexpr int DPL = decltype(dpl)::value;
        paged_chunk_kernel<TQ, TKV, DPL><<<grid, kThreads, smem, stream>>>(
            static_cast<const TQ*>(q), static_cast<const TKV*>(k_pool),
            static_cast<const TKV*>(v_pool), static_cast<const TKV*>(k_new),
            static_cast<const TKV*>(v_new), static_cast<const int*>(tables), pos0,
            static_cast<TQ*>(out), C, H, KVH, G, bs, nb_t, scale, window, softcap,
            fused_new);
      });
    });
  });
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
