// K1, the wNa16 GEMM on the tensor cores, for an N whose packed rows are
// not a multiple of 16 bytes (Hymba's in_proj, N = 6482; any odd N): the
// kernel template of wna16_gemm.cuh with the plan's narrower copies and a
// column-wise store. A library of its own, so that it builds beside
// wna16_gemm.cu.
//
// Replaces the Pallas TPU kernel `_wna16_kernel` / `wna16_gemm` of
// src/repro/kernels/wna16_gemm.py, which takes any N.
#include "wna16_gemm.cuh"

extern "C" int morph_wna16_gemm_narrow(const void* x, int x_dtype, const void* packed,
                                       const void* scales, const void* zeros,
                                       const void* inv_act, const void* bias, void* out,
                                       int M, int K, int N, int bits, int group,
                                       const Wna16Plan* plan, void* stream_ptr) {
  return wna16_entry<true>(x, x_dtype, packed, scales, zeros, inv_act, bias, out, M, K,
                           N, bits, group, plan, stream_ptr);
}
