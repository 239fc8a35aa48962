// Paged attention over a block-table KV pool: the decode block walk (K2)
// and the chunk-prefill block walk (K3). K3's kernel template and the
// helpers both walks use are in paged_walk.cuh; K3's MLA latent mode is
// instantiated from the same template in paged_attention_mla.cu.
//
// Replaces the Pallas TPU kernels `_paged_attn_kernel` (via `_paged_call`:
// `paged_attention_fused`, `paged_attention`) and `_chunk_attn_kernel`
// (via `_chunk_call`: `paged_chunk_attention_fused`,
// `paged_chunk_attention`) of src/repro/kernels/paged_attention.py, each
// with and without their quantized-KV lane (`kv_quant`, FMA at `:78-82`
// and `:315-319` there).
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
// Quantized-KV lane (template flag KVQ; the instantiation without it is the
// plain walk). The quantize-cold tier keeps int8 mirrors qk/qv of the pools
// (cap, bs, KVH, Dh) and one float (scale, zero) per pool block for k and
// for v. A quantized block's fp slot is zero; an fp block's scale and zero
// are zero. So every visited element is dequantized with the branch-free
// FMA k = fp_slot + q * scale + zero, exact for both kinds of block, with
// no per-block flag. The four per-block floats are read once per visited
// block (the same address for every thread: a broadcast). The lane reads
// the fp slot and the int8 mirror of every visited block, 5 bytes per
// float32 element instead of 4: K2-q is bounded by those bytes. K2 applies
// the FMA where a warp loads its key/value row, K3 where the CTA stages a
// pool block in shared memory, so K3's inner loop is unchanged; the
// chunk's own fused KV is always fp.
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
#include "paged_walk.cuh"

namespace {

constexpr int kMaxG = 8;  // decode rows per kv head held in registers

template <typename TQ, typename TKV, int DPL, bool KVQ>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k_pool,
                    const TKV* __restrict__ v_pool, const TKV* __restrict__ k_new,
                    const TKV* __restrict__ v_new, const int* __restrict__ tables,
                    const int* __restrict__ lens, TQ* __restrict__ out, int H,
                    int KVH, int G, int bs, int nb_t, float scale, int window,
                    float softcap, int fused_new, KVQuant kvq) {
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
    const BlockDequant dq = block_dequant<KVQ>(kvq, blk);
    for (int t = 0; t < bs; ++t) {
      const int pos = nb * bs + t;
      if (pos >= ctx) break;
      if (window > 0 && pos <= qpos - window) continue;
      const size_t off = (((size_t)blk * bs + t) * KVH + h) * Dh + lane * DPL;
      float kv[DPL], vv[DPL];
#pragma unroll
      for (int i = 0; i < DPL; ++i)
        load_kv<KVQ>(k_pool, v_pool, kvq, dq, off + i, kv[i], vv[i]);
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

template <typename F>
void dispatch_kvq(bool kvq, F&& f) {
  if (kvq) f(std::true_type{});
  else f(std::false_type{});
}

}  // namespace

// C entry points. The wrappers have checked shapes, dtypes and contiguity;
// k_new / v_new may be null when fused_new is 0, and the six quantized-KV
// operands (qk, qv int8 like the pools; k/v scale and zero float (cap,))
// are all null or all set: set selects the KVQ lane. Each returns
// cudaGetLastError() after the launch.
extern "C" int morph_paged_decode(const void* q, int q_dtype, const void* k_pool,
                                  const void* v_pool, int kv_dtype, const void* k_new,
                                  const void* v_new, const void* tables,
                                  const void* lens, void* out, int B, int H, int KVH,
                                  int Dh, int bs, int nb_t, float scale, int window,
                                  float softcap, int fused_new, const void* qk,
                                  const void* qv, const void* k_scale,
                                  const void* v_scale, const void* k_zero,
                                  const void* v_zero, void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  const int G = H / KVH;
  if (G > kMaxG) return (int)cudaErrorInvalidValue;
  const KVQuant kvq{static_cast<const int8_t*>(qk), static_cast<const int8_t*>(qv),
                    static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
                    static_cast<const float*>(k_zero), static_cast<const float*>(v_zero)};
  const size_t smem = (size_t)kWarps * G * (Dh + 2) * sizeof(float);
  cudaError_t err = cudaSuccess;
  MORPH_DISPATCH_DTYPE(q_dtype, TQ, {
    MORPH_DISPATCH_DTYPE(kv_dtype, TKV, {
      err = dispatch_dpl(Dh, [&](auto dpl) {
        constexpr int DPL = decltype(dpl)::value;
        dispatch_kvq(qk != nullptr, [&](auto kvq_on) {
          paged_decode_kernel<TQ, TKV, DPL, decltype(kvq_on)::value>
              <<<dim3(KVH, B), kThreads, smem, stream>>>(
                  static_cast<const TQ*>(q), static_cast<const TKV*>(k_pool),
                  static_cast<const TKV*>(v_pool), static_cast<const TKV*>(k_new),
                  static_cast<const TKV*>(v_new), static_cast<const int*>(tables),
                  static_cast<const int*>(lens), static_cast<TQ*>(out), H, KVH, G,
                  bs, nb_t, scale, window, softcap, fused_new, kvq);
        });
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
                                 float softcap, int fused_new, const void* qk,
                                 const void* qv, const void* k_scale,
                                 const void* v_scale, const void* k_zero,
                                 const void* v_zero, void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  const int G = H / KVH;
  const KVQuant kvq{static_cast<const int8_t*>(qk), static_cast<const int8_t*>(qv),
                    static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
                    static_cast<const float*>(k_zero), static_cast<const float*>(v_zero)};
  const size_t smem = (size_t)2 * bs * Dh * sizeof(float);
  const dim3 grid((C * G + kTileRows - 1) / kTileRows, KVH, B);
  cudaError_t err = cudaSuccess;
  MORPH_DISPATCH_DTYPE(q_dtype, TQ, {
    MORPH_DISPATCH_DTYPE(kv_dtype, TKV, {
      err = dispatch_dpl(Dh, [&](auto dpl) {
        constexpr int DPL = decltype(dpl)::value;
        dispatch_kvq(qk != nullptr, [&](auto kvq_on) {
          paged_chunk_kernel<TQ, TKV, DPL, DPL, decltype(kvq_on)::value>
              <<<grid, kThreads, smem, stream>>>(
                  static_cast<const TQ*>(q), static_cast<const TKV*>(k_pool),
                  static_cast<const TKV*>(v_pool), static_cast<const TKV*>(k_new),
                  static_cast<const TKV*>(v_new), static_cast<const int*>(tables),
                  pos0, static_cast<TQ*>(out), C, H, KVH, G, bs, nb_t, scale,
                  window, softcap, fused_new, kvq);
        });
      });
    });
  });
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
