// K1, the wNa16 GEMM on the tensor cores, for an N that keeps every packed
// row a multiple of 16 bytes (every N of the dense and MoE models, and
// Mamba-2's 6448): the kernel template of wna16_gemm.cuh with 16-byte
// copies. wna16_gemm_narrow.cu instantiates the same template for any
// other N.
//
// Replaces the Pallas TPU kernel `_wna16_kernel` / `wna16_gemm` of
// src/repro/kernels/wna16_gemm.py.
#include "wna16_gemm.cuh"

extern "C" int morph_wna16_gemm(const void* x, int x_dtype, const void* packed,
                                const void* scales, const void* zeros,
                                const void* inv_act, const void* bias, void* out,
                                int M, int K, int N, int bits, int group,
                                const Wna16Plan* plan, void* stream_ptr) {
  return wna16_entry<false>(x, x_dtype, packed, scales, zeros, inv_act, bias, out, M, K,
                            N, bits, group, plan, stream_ptr);
}
