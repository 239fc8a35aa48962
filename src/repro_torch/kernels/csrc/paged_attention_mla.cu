// K3-mla: the chunk-prefill block walk in MLA's latent mode.
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
// accumulates every visible key at 576 + 512 FMAs, 2 * C * H * T * 1088
// FLOPs for T visible keys. At C = 256 that is ~23 GFLOP at pos0 = 200,
// against ~3 MB of latent pool and q: operations (float32, CUDA cores).
//
// Design. The walk is paged_chunk_kernel of paged_walk.cuh with a value
// width of its own (DPL = 18 key lanes a thread, DPLV = 16 value lanes).
// A block is staged once in shared memory (16 x 576 floats, 36 KB, inside
// the default 48 KB), and values are read from the first 512 lanes of the
// staged key rows, so keys and values must be one pool and the chunk's
// own keys and values one tensor, as on the engine path (the wrapper
// checks both). A CTA holds 16 rows; with G = 128 they are 16 heads of one
// chunk token, so Cp * 8 CTAs each stage every visible block. That is the
// simple kernel: tensor cores (wgmma over the 128 heads of a token) and a
// split over the context are later work. Instantiated only where the
// engine uses it: q float32, a float32 or bfloat16 pool, no quantized-KV
// lane (the latent pool keeps fp blocks).
#include "paged_walk.cuh"

namespace {

constexpr int kLatentDPL = 18;   // 576 = 512 + 64 latent lanes
constexpr int kLatentDPLV = 16;  // 512 value lanes (kv_lora_rank)

}  // namespace

// C entry point. The wrapper has checked shapes, dtypes and contiguity;
// `pool` is the one latent pool (cap, bs, 1, Dh) read for keys and values,
// `latent_new` the chunk's own latent rows (B, C, 1, Dh) in the pool dtype,
// null when fused_new is 0; q (B, C, H, Dh) and out (B, C, H, Dv) float32.
// Returns cudaErrorInvalidValue for a width or pool dtype it does not
// instantiate, else cudaGetLastError() after the launch.
extern "C" int morph_paged_chunk_mla(const void* q, const void* pool,
                                     int kv_dtype, const void* latent_new,
                                     const void* tables, int pos0, void* out,
                                     int B, int C, int H, int Dh, int Dv,
                                     int bs, int nb_t, float scale, int window,
                                     float softcap, int fused_new,
                                     void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  if (Dh != kLatentDPL * 32 || Dv != kLatentDPLV * 32)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)bs * Dh * sizeof(float);
  const dim3 grid((C * H + kTileRows - 1) / kTileRows, 1, B);
  const KVQuant none{};
  auto launch = [&](auto* tag) {   // tag: a null TKV* naming the pool type
    using TKV = std::remove_pointer_t<decltype(tag)>;
    paged_chunk_kernel<float, TKV, kLatentDPL, kLatentDPLV, false>
        <<<grid, kThreads, smem, stream>>>(
            static_cast<const float*>(q), static_cast<const TKV*>(pool),
            static_cast<const TKV*>(pool), static_cast<const TKV*>(latent_new),
            static_cast<const TKV*>(latent_new), static_cast<const int*>(tables),
            pos0, static_cast<float*>(out), C, H, 1, H, bs, nb_t, scale, window,
            softcap, fused_new, none);
  };
  switch (kv_dtype) {
    case morph::kF32: launch(static_cast<float*>(nullptr)); break;
    case morph::kBF16: launch(static_cast<__nv_bfloat16*>(nullptr)); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
