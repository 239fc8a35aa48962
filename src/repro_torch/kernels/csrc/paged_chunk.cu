// K3 and K3-q: the chunk-prefill block walk over a block-table KV pool, on
// the H100's tensor cores. The kernel template is `paged_chunk_kernel` in
// paged_walk.cuh; its MLA latent mode is instantiated in
// paged_attention_mla.cu, the decode walk K2 in paged_attention.cu.
//
// Replaces the Pallas TPU kernel `_chunk_attn_kernel` (via `_chunk_call`:
// `paged_chunk_attention_fused`, `paged_chunk_attention`) of
// src/repro/kernels/paged_attention.py, with and without its quantized-KV
// lane (`kv_quant`, the FMA at `:315-319` there).
//
// What it computes (as the TPU kernel): for kv head h, row r of the
// C * G rows is chunk token r / G at position pos0 + r / G, query head
// h * G + r % G. With fused_new the pool is read below pos0 and the
// chunk's own keys (k_new, v_new) follow under the intra-chunk causal mask
// (key j visible to token i iff j <= i); without it the pool is read up to
// each row's own position. Window and softcap apply to every key; masked
// probabilities are exactly zero, the denominator floor is 1e-30, and the
// output is written in q's dtype. Layout: pools (cap, bs, KVH, Dh), block
// tables (B, nb) int32, q and out (B, C, H, Dh).
//
// What bounds it on the H100: 4 * Dh FLOPs a visible (row, key) pair, two
// matrix products over a (rows x keys) score tile, against each context
// token's K and V read once per row tile. At C = 256, pos0 = 200 (MHA,
// Dh 128) that is 1.38 GFLOP against ~6 MB: operations, 2.8 us at the
// TF32 tensor-core peak (495 TFLOP/s) for one pass. What bounds this
// kernel is instruction issue around the tensor cores: for each mma.sync
// a warp issues about seven other instructions (shared-memory fragment
// loads, TF32 rounding, the softmax), and a SM holds 8 warps (one CTA:
// 169-208 KB of shared memory at Dh 128), so little latency is hidden.
// It runs at ~8x its one-pass tensor-core bound and ~2.3x its float32
// (CUDA-core) bound on an H100 80GB HBM3 at 700 W (PERF.md); wgmma with
// operands read straight from shared memory is the next step.
//
// Design. This replaces a scalar walk in which a warp did Dh / 32 FMAs a
// lane, a shuffle reduction and two exponentials per (row, key) pair over
// 16-row tiles. Now a CTA owns 64 rows of one
// (sequence, kv head) and runs 8 warps: four 16-row slices (the m16 of
// mma.sync), and for each slice two warps that take the two halves of
// every key tile, each with a softmax state of its own; the halves merge
// at the end through shared memory laid over the stages. The walk covers
// key positions [k_lo, q_last] in key tiles of 64 (32 where shared memory
// is short: Dh 256 in a 16-bit pool, 16 for Dh 256 in a float32 pool).
// Each key row of a tile is gathered through the block table with
// cp.async (16 bytes a copy, zero-filled past the range) into the second
// of two stages while the warps compute on the first. Per tile a warp
// computes its 16 x 32 scores with mma.sync m16n8k8 TF32 (Q from the
// shared float32 tile, K fragments converted as they load, two
// accumulator sets over alternating k steps), scales, softcaps and masks
// them in the accumulator fragments (row r / G's causal frontier and
// window, so a tile may span tokens at any G), keeps them in base-2 units
// (ex2.approx), takes one row max and one rescale per tile, and multiplies
// P (kept in registers: within each 8-key step the fragment's k index t
// is key 2t and t + 4 is key 2t + 1, so V is read in that order) by V
// into its 16 x Dh accumulator. No row state leaves the CTA, so there is
// no second pass. Window skip: the walk starts at the tile's first
// query - window + 1; later rows mask what they may not see. Row tiles
// launch in reverse, so the tiles that see the most keys start first.
//
// Passes. bf16 and f16 values are exact in TF32 and go to the tensor
// cores as they are. A float32 operand is rounded to TF32 (nearest, two
// integer operations on its bits, 2^-11 relative). The bf16-output
// instantiations take one pass: bf16's own rounding (2^-9) dominates and
// the tolerance is 1e-2 |p| + 1e-3 max|p|. The float32- and
// float16-output instantiations split each float32 operand into big +
// small and add small.big + big.small to big.big (3xTF32, ~2^-21),
// because their tolerances (1e-4 |p| + 1e-5 max|p|, 2e-3 |p| + 1e-4
// max|p|) are below what one pass keeps; a product with an exact 16-bit
// operand drops the term that operand's small part would add.
//
// Registers (`-Xptxas -v`, as kernel_ab.py reports them): the main path's
// K3 and K3-q (bf16 q, float32 pool, Dh 128) take 155 and 156 a thread,
// no spills; the 72 instantiations take 89-255, none spills, and every one
// holds HMMA instructions.
//
// Quantized-KV lane (template flag KVQ). The quantize-cold tier keeps int8
// mirrors qk/qv of the pools and one float (scale, zero) per pool block
// for k and for v; a quantized block's fp slot is zero and an fp block's
// scale and zero are zero. The lane stages the int8 rows and four floats
// a key beside the fp rows and applies the branch-free fp + q * scale +
// zero: in place over a float32 pool's staged tile, once it lands (one
// more pass and barrier a tile, skipped where no row of the tile is in a
// quantized block), and for a 16-bit pool as each fragment
// loads (a 16-bit slot cannot hold the float32 sum). The chunk's own keys
// take zero scale and zero. Both lanes of a width take the same key tile,
// so a zeroed sidecar reproduces the plain lane bit for bit.
#include "paged_walk.cuh"

namespace {

template <typename F>
cudaError_t with_chunk_kernel(int q_dtype, int kv_dtype, int Dh, bool kvq, F&& f) {
  cudaError_t rc = cudaSuccess;
  MORPH_DISPATCH_DTYPE(q_dtype, TQ, {
    MORPH_DISPATCH_DTYPE(kv_dtype, TKV, {
      const cudaError_t known = dispatch_head_dim(Dh, [&](auto dh) {
        constexpr int DH = decltype(dh)::value;
        dispatch_kvq(kvq, [&](auto on) {
          rc = f(ChunkKernel<TQ, TKV, DH, DH, decltype(on)::value>{});
        });
      });
      if (known != cudaSuccess) return known;
    });
  });
  return rc;
}

}  // namespace

// The launch plan of one instantiation, for checking the Python planner:
// p[0..6) = {dynamic shared bytes, key tile, mma passes of Q K^T, mma
// passes of P V, threads, row tile}. Returns cudaErrorInvalidValue for a
// width or dtype not built.
extern "C" int morph_paged_chunk_plan(int q_dtype, int kv_dtype, int Dh, int kvq,
                                      int* p) {
  return (int)with_chunk_kernel(q_dtype, kv_dtype, Dh, kvq != 0, [&](auto k) {
    decltype(k)::plan(p);
    return cudaSuccess;
  });
}

// C entry point. The wrapper has checked shapes, dtypes, contiguity and
// 16-byte alignment; k_new / v_new may be null when fused_new is 0, and the
// six quantized-KV operands (qk, qv int8 like the pools; k/v scale and zero
// float (cap,)) are all null or all set: set selects the KVQ lane. The
// instantiation sizes its own dynamic shared memory. Returns
// cudaGetLastError() after the launch.
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
  const ChunkArgs a{q, k_pool, v_pool, k_new, v_new, static_cast<const int*>(tables),
                    out, pos0, B, C, H, KVH, H / KVH, bs, nb_t, scale, window,
                    softcap, fused_new,
                    KVQuant{static_cast<const int8_t*>(qk), static_cast<const int8_t*>(qv),
                            static_cast<const float*>(k_scale),
                            static_cast<const float*>(v_scale),
                            static_cast<const float*>(k_zero),
                            static_cast<const float*>(v_zero)}};
  return (int)with_chunk_kernel(q_dtype, kv_dtype, Dh, qk != nullptr, [&](auto k) {
    return decltype(k)::launch(a, stream);
  });
}
