// wNa16 GEMM: out = cast((x * inv_act) @ ((q - z) * s) + bias), weight-only
// int4/int8 with asymmetric group quantisation along K, fp32 accumulation.
//
// Replaces the Pallas TPU kernel `_wna16_kernel` / `wna16_gemm` of
// src/repro/kernels/wna16_gemm.py.
//
// Layout (the JAX package's): x (M, K) row-major; packed int4 (K/2, N) uint8
// with the low nibble holding the even k; int8 (K, N) uint8; scales and
// zeros (K/group, N) float32; inv_act (K,) and bias (N,) float32, optional.
//
// What bounds it on the H100: at decode M (1..8 slots) the weight bytes.
// One int4 (4096, 11008) matrix is 22.5 MB of packed weight plus 2.8 MB of
// scales and zeros, about 7.6 us at 3.35 TB/s, against 0.7 MFLOP per row of
// x. At prefill M (a few hundred rows) the FMAs bound it.
//
// Design: each thread owns 4 neighbouring columns, so a warp reads 128
// contiguous bytes of one packed row per load. A CTA of 128 threads covers
// 512 columns and BM rows of x; the x tile of one quantisation group sits in
// shared memory as float with inv_act applied. The K loop steps by whole
// groups, so a scale/zero row is always the one the weight was quantised
// with (the group is never shrunk to fit a tile). Skinny decode M leaves too
// few CTAs to keep enough loads in flight, so K is split over grid.z (about
// four CTAs per SM at M <= 16, two above) and the K loop is unrolled (eight
// rows deep for BM > 1, four at BM == 1). Each split writes its partial
// sums to a float32 workspace and a second kernel sums the splits in a
// fixed order (deterministic, no atomics), adds the bias and casts.
// Dequantisation is (q - z) * s in float, as in the JAX package. Plain
// CUDA-core FMAs: tensor cores (mma/wgmma) are later work.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kCols = 4;  // columns per thread

template <typename TX, int BITS, int BM>
__global__ void __launch_bounds__(kThreads)
wna16_splitk_kernel(const TX* __restrict__ x, const uint8_t* __restrict__ packed,
                    const float* __restrict__ scales, const float* __restrict__ zeros,
                    const float* __restrict__ inv_act, float* __restrict__ ws,
                    int M, int K, int N, int group, int groups_per_split) {
  extern __shared__ float xs[];  // BM x group
  const int n0 = (blockIdx.x * kThreads + threadIdx.x) * kCols;
  const int m0 = blockIdx.y * BM;
  const int split = blockIdx.z;
  const int n_groups = K / group;
  const int g_begin = split * groups_per_split;
  const int g_end = min(n_groups, g_begin + groups_per_split);
  const bool live = n0 < N;

  float acc[BM][kCols];
#pragma unroll
  for (int m = 0; m < BM; ++m)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[m][c] = 0.f;

  for (int gi = g_begin; gi < g_end; ++gi) {
    const int k0 = gi * group;
    __syncthreads();
    for (int idx = threadIdx.x; idx < BM * group; idx += kThreads) {
      const int m = idx / group, kk = idx - (idx / group) * group;
      float v = 0.f;
      if (m0 + m < M) {
        v = morph::to_f32(x[(size_t)(m0 + m) * K + k0 + kk]);
        if (inv_act != nullptr) v *= inv_act[k0 + kk];
      }
      xs[idx] = v;
    }
    __syncthreads();
    if (!live) continue;
    const float4 s4 = *reinterpret_cast<const float4*>(scales + (size_t)gi * N + n0);
    const float4 z4 = *reinterpret_cast<const float4*>(zeros + (size_t)gi * N + n0);
    const float s[kCols] = {s4.x, s4.y, s4.z, s4.w};
    const float z[kCols] = {z4.x, z4.y, z4.z, z4.w};
    if (BITS == 4) {
      // unrolled so that independent packed-row loads are in flight: eight
      // deep with BM > 1, four at BM == 1 (which measured faster there)
#pragma unroll(BM > 1 ? 8 : 4)
      for (int kk = 0; kk < group; kk += 2) {
        const uint32_t w4 = *reinterpret_cast<const uint32_t*>(
            packed + (size_t)((k0 + kk) >> 1) * N + n0);
        float w_even[kCols], w_odd[kCols];
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const uint32_t byte = (w4 >> (8 * c)) & 0xffu;
          w_even[c] = ((float)(byte & 0xfu) - z[c]) * s[c];
          w_odd[c] = ((float)(byte >> 4) - z[c]) * s[c];
        }
#pragma unroll
        for (int m = 0; m < BM; ++m) {
          const float xa = xs[m * group + kk];
          const float xb = xs[m * group + kk + 1];
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            acc[m][c] = fmaf(xa, w_even[c], acc[m][c]);
            acc[m][c] = fmaf(xb, w_odd[c], acc[m][c]);
          }
        }
      }
    } else {
#pragma unroll(BM > 1 ? 8 : 4)
      for (int kk = 0; kk < group; ++kk) {
        const uint32_t w4 = *reinterpret_cast<const uint32_t*>(
            packed + (size_t)(k0 + kk) * N + n0);
        float w[kCols];
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          w[c] = ((float)((w4 >> (8 * c)) & 0xffu) - z[c]) * s[c];
#pragma unroll
        for (int m = 0; m < BM; ++m) {
          const float xa = xs[m * group + kk];
#pragma unroll
          for (int c = 0; c < kCols; ++c) acc[m][c] = fmaf(xa, w[c], acc[m][c]);
        }
      }
    }
  }
  if (!live) return;
#pragma unroll
  for (int m = 0; m < BM; ++m) {
    if (m0 + m >= M) break;
    float4 o = make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
    *reinterpret_cast<float4*>(ws + ((size_t)split * M + m0 + m) * N + n0) = o;
  }
}

template <typename TO>
__global__ void splitk_reduce_kernel(const float* __restrict__ ws,
                                     const float* __restrict__ bias,
                                     TO* __restrict__ out, int M, int N, int splits) {
  const size_t total = (size_t)M * N;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    float acc = 0.f;
    for (int s = 0; s < splits; ++s) acc += ws[(size_t)s * total + i];
    if (bias != nullptr) acc += bias[i % N];
    out[i] = morph::from_f32<TO>(acc);
  }
}

template <typename TX, int BITS, int BM>
void launch_main(const TX* x, const uint8_t* packed, const float* scales,
                 const float* zeros, const float* inv_act, float* ws, int M,
                 int K, int N, int group, int splits, int groups_per_split,
                 cudaStream_t stream) {
  const dim3 grid((N / kCols + kThreads - 1) / kThreads, (M + BM - 1) / BM, splits);
  const size_t smem = (size_t)BM * group * sizeof(float);
  wna16_splitk_kernel<TX, BITS, BM><<<grid, kThreads, smem, stream>>>(
      x, packed, scales, zeros, inv_act, ws, M, K, N, group, groups_per_split);
}

template <typename TX, int BITS>
cudaError_t dispatch_bm(int bm, const TX* x, const uint8_t* packed,
                        const float* scales, const float* zeros,
                        const float* inv_act, float* ws, int M, int K, int N,
                        int group, int splits, int gps, cudaStream_t stream) {
  switch (bm) {
    case 1: launch_main<TX, BITS, 1>(x, packed, scales, zeros, inv_act, ws, M, K, N, group, splits, gps, stream); break;
    case 2: launch_main<TX, BITS, 2>(x, packed, scales, zeros, inv_act, ws, M, K, N, group, splits, gps, stream); break;
    case 4: launch_main<TX, BITS, 4>(x, packed, scales, zeros, inv_act, ws, M, K, N, group, splits, gps, stream); break;
    case 8: launch_main<TX, BITS, 8>(x, packed, scales, zeros, inv_act, ws, M, K, N, group, splits, gps, stream); break;
    case 16: launch_main<TX, BITS, 16>(x, packed, scales, zeros, inv_act, ws, M, K, N, group, splits, gps, stream); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

}  // namespace

// C entry point. The wrapper has checked shapes, dtypes, alignment and
// contiguity; `ws` holds splits * M * N floats. Returns cudaGetLastError().
extern "C" int morph_wna16_gemm(const void* x, int x_dtype, const void* packed,
                                const void* scales, const void* zeros,
                                const void* inv_act, const void* bias, void* out,
                                void* ws, int M, int K, int N, int bits, int group,
                                int bm, int splits, int groups_per_split,
                                void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  const uint8_t* pk = static_cast<const uint8_t*>(packed);
  const float* sc = static_cast<const float*>(scales);
  const float* ze = static_cast<const float*>(zeros);
  const float* ia = static_cast<const float*>(inv_act);
  float* w = static_cast<float*>(ws);
  cudaError_t err = cudaSuccess;
  MORPH_DISPATCH_DTYPE(x_dtype, TX, {
    const TX* xp = static_cast<const TX*>(x);
    if (bits == 4)
      err = dispatch_bm<TX, 4>(bm, xp, pk, sc, ze, ia, w, M, K, N, group, splits, groups_per_split, stream);
    else if (bits == 8)
      err = dispatch_bm<TX, 8>(bm, xp, pk, sc, ze, ia, w, M, K, N, group, splits, groups_per_split, stream);
    else
      err = cudaErrorInvalidValue;
    if (err != cudaSuccess) return err;
    const size_t total = (size_t)M * N;
    const int threads = 256;
    const size_t want = (total + threads - 1) / threads;
    const int blocks = (int)(want < 65535 ? want : 65535);
    splitk_reduce_kernel<TX><<<blocks, threads, 0, stream>>>(
        w, static_cast<const float*>(bias), static_cast<TX*>(out), M, N, splits);
  });
  return (int)cudaGetLastError();
}
