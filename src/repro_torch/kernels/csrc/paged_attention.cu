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
// What bounds it on the H100: it reads each live context token's K and V
// once (2 * KVH * Dh * 4 bytes a token in a float32 pool) for 4 * G * Dh
// FLOPs: bytes.
//
// Design. On the TPU the block walk is the innermost, sequential grid axis
// with the softmax state carried in VMEM scratch from step to step. Here
// CTAs run in parallel and nothing carries between them, so the walk is a
// loop inside one CTA. Each CTA loads its own table entries and never reads
// an entry past ceil(ctx / bs), nor one wholly outside the window. Softmax
// state (running max m, sum l, accumulator) lives in registers; a warp's
// lanes split Dh and reduce the q.k dot with shuffles. Keys a row may not
// see are skipped outright, which is the same as the TPU kernel's explicit
// zeroing of masked probabilities: a row whose running max is still empty
// never picks up exp(0) weight. Masked logits are -1e30 and the denominator
// floor is 1e-30, as on the TPU. Accumulation is float; the output is
// written in q's dtype.
//
// One CTA per (kv head, sequence, group of up to 8 query rows), four
// warps. A CTA holds its rows' (m, l, acc) in registers; each warp walks
// every fourth pool block independently, then the warps merge through
// shared memory (kWarps * min(G, 8) * (Dh + 2) floats). G <= 8 is one row
// group, as before; a larger G takes ceil(G / 8) groups on a third grid
// axis, each re-reading the context: at G = 12 two CTAs read each kv
// head's context, 2x its bytes, the second mostly from L2. With fused_new
// the current token (k_new, v_new) is folded in last; it sits at position
// ctx_len and is always visible. Without it the query is the newest pool
// token at ctx_len - 1.
//
// Quantized-KV lane (template flag KVQ; the instantiation without it is the
// plain walk). The quantize-cold tier keeps int8 mirrors qk/qv of the pools
// (cap, bs, KVH, Dh) and one float (scale, zero) per pool block for k and
// for v. A quantized block's fp slot is zero; an fp block's scale and zero
// are zero. So every visited element is dequantized with the branch-free
// FMA k = fp_slot + q * scale + zero, exact for both kinds of block, with
// no per-block flag, applied where a warp loads its key/value row. The four
// per-block floats are read once per visited block (the same address for
// every thread: a broadcast). The lane reads the fp slot and the int8
// mirror of every visited block, 5 bytes per float32 element instead of 4:
// K2-q is bounded by those bytes.
#include "paged_walk.cuh"

namespace {

constexpr int kDecodeRows = 8;  // query rows a CTA holds in registers

template <typename TQ, typename TKV, int DPL, bool KVQ>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k_pool,
                    const TKV* __restrict__ v_pool, const TKV* __restrict__ k_new,
                    const TKV* __restrict__ v_new, const int* __restrict__ tables,
                    const int* __restrict__ lens, TQ* __restrict__ out, int H,
                    int KVH, int G, int bs, int nb_t, float scale, int window,
                    float softcap, int fused_new, KVQuant kvq) {
  constexpr int Dh = DPL * 32;
  extern __shared__ float smem[];  // kWarps * GR * (Dh + 2)
  const int h = blockIdx.x, b = blockIdx.y;
  const int g0 = blockIdx.z * kDecodeRows;    // this CTA's first row
  const int GR = min(G - g0, kDecodeRows);    // and its row count
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ctx = lens[b];
  const int qpos = fused_new ? ctx : ctx - 1;

  float qr[kDecodeRows][DPL], acc[kDecodeRows][DPL], m[kDecodeRows], l[kDecodeRows];
#pragma unroll
  for (int g = 0; g < kDecodeRows; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      acc[g][i] = 0.f;
      qr[g][i] = g < GR
          ? morph::to_f32(q[((size_t)b * H + h * G + g0 + g) * Dh + lane * DPL + i])
          : 0.f;
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
      for (int g = 0; g < kDecodeRows; ++g) {
        if (g >= GR) break;
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
    for (int g = 0; g < kDecodeRows; ++g) {
      if (g >= GR) break;
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
  for (int g = 0; g < kDecodeRows; ++g) {
    if (g >= GR) break;
    float* row = smem + ((size_t)warp * GR + g) * stride;
    if (lane == 0) {
      row[0] = m[g];
      row[1] = l[g];
    }
#pragma unroll
    for (int i = 0; i < DPL; ++i) row[2 + lane * DPL + i] = acc[g][i];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < GR * Dh; idx += kThreads) {
    const int g = idx / Dh, d = idx - (idx / Dh) * Dh;
    float mm = kNegInf;
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, smem[((size_t)w * GR + g) * stride]);
    float ll = 0.f, aa = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float* row = smem + ((size_t)w * GR + g) * stride;
      const float e = expf(row[0] - mm);
      ll += row[1] * e;
      aa += row[2 + d] * e;
    }
    out[((size_t)b * H + h * G + g0 + g) * Dh + d] =
        morph::from_f32<TQ>(aa / fmaxf(ll, 1e-30f));
  }
}

}  // namespace

// C entry point. The wrapper has checked shapes, dtypes and contiguity;
// k_new / v_new may be null when fused_new is 0, and the six quantized-KV
// operands (qk, qv int8 like the pools; k/v scale and zero float (cap,))
// are all null or all set: set selects the KVQ lane. Any G = H / KVH >= 1.
// Returns cudaGetLastError() after the launch.
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
  const int rows = G < kDecodeRows ? G : kDecodeRows;
  const KVQuant kvq{static_cast<const int8_t*>(qk), static_cast<const int8_t*>(qv),
                    static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
                    static_cast<const float*>(k_zero), static_cast<const float*>(v_zero)};
  const size_t smem = (size_t)kWarps * rows * (Dh + 2) * sizeof(float);
  const dim3 grid(KVH, B, (G + kDecodeRows - 1) / kDecodeRows);
  cudaError_t err = cudaSuccess;
  MORPH_DISPATCH_DTYPE(q_dtype, TQ, {
    MORPH_DISPATCH_DTYPE(kv_dtype, TKV, {
      err = dispatch_head_dim(Dh, [&](auto dh) {
        constexpr int DPL = decltype(dh)::value / 32;
        dispatch_kvq(qk != nullptr, [&](auto kvq_on) {
          paged_decode_kernel<TQ, TKV, DPL, decltype(kvq_on)::value>
              <<<grid, kThreads, smem, stream>>>(
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
