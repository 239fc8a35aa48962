// K3-mla: the chunk-prefill block walk in MLA's latent mode, on the H100's
// tensor cores.
//
// Replaces the latent mode (`dv < Dh`) of the Pallas TPU kernel
// `_chunk_attn_kernel` (via `_chunk_call`: `paged_chunk_attention_fused`,
// `paged_chunk_attention`) of src/repro/kernels/paged_attention.py, the
// value truncation at `:320` and `:347` there and its (B, KVH, C*G, dv)
// output at `:405`.
//
// What it computes. DeepSeek's weight absorption folds W_uk into the query
// (q_abs = q_nope . W_uk, then q_rope), so a chunk attends straight over
// the paged latent pool (cap, bs, 1, r + rope): one latent head serves all
// H query heads (KVH = 1, G = H), a score spans the full latent width
// r + rope, and the value is the first r lanes (c_kv) of the same row. The
// caller expands the (B, C, H, r) latent context through W_uv afterwards.
// The scale is the caller's (the qk head dim's, not the latent width's).
// DeepSeek-V3 on the engine path: H = 128, r + rope = 576, r = 512,
// bs = 16, q float32, a float32 pool.
//
// What bounds it on the H100: each of the C * H rows scores and
// accumulates every visible key at 576 + 512 multiply-adds, 2 * C * H * T
// * 1088 FLOPs for T visible keys. At C = 256 that is ~23 GFLOP at
// pos0 = 200, against ~3 MB of latent pool and q: operations, 47 us at
// the TF32 tensor-core peak for one pass, 142 us for the three it takes.
// This kernel runs at ~5x that three-pass bound, held back, as K3 is, by
// the instructions around each mma.sync (fragment loads and the split of
// every float32 operand into two TF32 parts), with 8 warps a SM (PERF.md).
//
// Design. The walk is paged_chunk_kernel of paged_walk.cuh with DV < DH;
// it replaces a scalar walk that held 16 rows a CTA and staged every
// visible block once per 16 rows. A CTA owns 64 rows, which at G = 128 are
// 64 heads of one chunk token: they share one causal frontier, and two
// CTAs cover a token. The float32 Q tile (64 x 580 floats, 148 KB) stays
// in shared memory; beside it two stages of one 16-key latent tile (2 x
// 37 KB in a float32 pool) and the score exchange (8 KB), 230,912 bytes
// of the 232,448 a block may opt into, so a SM holds one CTA. A key tile
// is gathered once with cp.async and read for keys over all 576 lanes and
// for values over its first 512. A 64 x 512 float32 accumulator over 4
// warps would take 256 registers a thread, so the CTA runs 8 warps: two
// per 16-row slice, each reducing half of the 576 score lanes with
// mma.sync m16n8k8 TF32 (four accumulator sets over alternating k steps,
// so eight mma chains are in flight) and accumulating half of the 512
// value lanes (128 registers). The two partial score tiles meet in shared
// memory and both warps add them in the same order, so both hold the same
// softmax state. Keys and values must therefore be one pool and the
// chunk's own keys and values one tensor, as on the engine path (the
// wrapper checks both). q is float32, so each product takes three TF32
// passes (3xTF32) to meet the float32 tolerance; a bf16 pool's values are
// exact in TF32 and drop one of the three. `-Xptxas -v`: 241 registers
// (float32 pool) and 238 (bf16), no spills. Instantiated only where the
// engine uses it: q float32, a float32 or bfloat16 pool, no quantized-KV
// lane (the latent pool keeps fp blocks).
#include "paged_walk.cuh"

namespace {

constexpr int kLatentDh = 576;   // 512 + 64 latent lanes
constexpr int kLatentDv = 512;   // value lanes (kv_lora_rank)

template <typename F>
cudaError_t with_latent_kernel(int kv_dtype, int Dh, int Dv, F&& f) {
  if (Dh != kLatentDh || Dv != kLatentDv) return cudaErrorInvalidValue;
  switch (kv_dtype) {
    case morph::kF32: return f(ChunkKernel<float, float, kLatentDh, kLatentDv, false>{});
    case morph::kBF16:
      return f(ChunkKernel<float, __nv_bfloat16, kLatentDh, kLatentDv, false>{});
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The launch plan of one instantiation (as morph_paged_chunk_plan):
// p[0..6) = {dynamic shared bytes, key tile, mma passes of Q K^T, mma
// passes of P V, threads, row tile}; cudaErrorInvalidValue for a width or
// pool dtype not built.
extern "C" int morph_paged_chunk_mla_plan(int kv_dtype, int Dh, int Dv, int* p) {
  return (int)with_latent_kernel(kv_dtype, Dh, Dv, [&](auto k) {
    decltype(k)::plan(p);
    return cudaSuccess;
  });
}

// C entry point. The wrapper has checked shapes, dtypes, contiguity and
// alignment; `pool` is the one latent pool (cap, bs, 1, Dh) read for keys
// and values, `latent_new` the chunk's own latent rows (B, C, 1, Dh) in the
// pool dtype, null when fused_new is 0; q (B, C, H, Dh) and out
// (B, C, H, Dv) float32. Returns cudaErrorInvalidValue for a width or
// pool dtype it does not instantiate, else cudaGetLastError() after the
// launch.
extern "C" int morph_paged_chunk_mla(const void* q, const void* pool,
                                     int kv_dtype, const void* latent_new,
                                     const void* tables, int pos0, void* out,
                                     int B, int C, int H, int Dh, int Dv,
                                     int bs, int nb_t, float scale, int window,
                                     float softcap, int fused_new,
                                     void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  const ChunkArgs a{q, pool, pool, latent_new, latent_new,
                    static_cast<const int*>(tables), out, pos0, B, C, H, 1, H,
                    bs, nb_t, scale, window, softcap, fused_new, KVQuant{}};
  return (int)with_latent_kernel(kv_dtype, Dh, Dv, [&](auto k) {
    return decltype(k)::launch(a, stream);
  });
}
