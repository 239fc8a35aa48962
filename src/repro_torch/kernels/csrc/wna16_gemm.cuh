// wNa16 GEMM on the tensor cores: out = cast((x * inv_act) @ ((q - z) * s)
// + bias), weight-only int4/int8 with asymmetric group quantisation along K,
// float32 accumulation.
//
// The kernel template of K1, built from wna16_gemm.cu (16-byte copies)
// and wna16_gemm_narrow.cu (NARROW: the rows of any other N). Replaces the
// Pallas TPU kernel `_wna16_kernel` / `wna16_gemm` of
// src/repro/kernels/wna16_gemm.py.
//
// Layout (the JAX package's): x (M, K) row-major; packed int4 (K/2, N) uint8
// with the low nibble holding the even k; int8 (K, N) uint8; scales and
// zeros (K/group, N) float32; inv_act (K,) and bias (N,) float32, optional.
//
// What bounds it on the H100: at decode M (1..8 slots) the weight bytes.
// One int4 (4096, 11008) matrix is 22.5 MB of packed weight plus 2.8 MB of
// scales and zeros, about 7.6 us at 3.35 TB/s. At prefill M (a few hundred
// rows) the bf16 tensor-core rate: 23 GFLOP at M = 256, 23 us at 989
// TFLOP/s.
//
// Numerics: the mma runs on the integer weight itself, never on a rounded
// dequantized value. q is exact in bf16 and fp16; the weight operand is
// q + OFF, built from the packed bytes by a byte permute and a mask (int4:
// 0x4300 | n is bf16 128 + n, 0x6400 | n fp16 1024 + n; int8: fp16
// 1024 + b, and bf16 b itself through the float 2^23 + b). Each quantisation
// group g keeps its own float32 product P_g = x_g @ (q + OFF) and the row
// sums S_g = x_g @ ones (one more mma on the same x operand), and folds them
// in as
//   acc[m, n] += s[g, n] * (P_g[m, n] - (z[g, n] + OFF) * S_g[m]).
// For bf16 / fp16 x without inv_act (the main path) every product is exact,
// so the kernel differs from the plain version by float32 summation order
// only. With inv_act, or with float32 x, x * inv_act is formed in float32
// and split into bf16 parts, one mma pass each (two passes for 16-bit x,
// three, exact, for float32 x), against q itself (OFF = 0: an offset
// enlarges P_g by OFF / |q - z| and costs that many bits of its float32).
//
// Design: one template for every M, instantiated by row tile, k16 steps a
// group (group 32, 64, 128), x dtype, weight width and passes. A CTA owns
// BN = 256 columns, four column warps of 64. At decode M (up to 16 rows, a
// tile of 8 or 16) the product is computed transposed: the weight is the
// A operand (a warp's 64 columns are four m16 tiles) and x^T the B operand
// (one or two n8 tiles), so M = 8 wastes no half of the mma; four warps a
// CTA, up to four CTAs an SM. At prefill M (64-row tiles) x is the A
// operand, two row warps of two m16 tiles, against eight n8 tiles of the
// weight interleaved by 8 (n-tile t, column j is column 8 j + t); eight
// warps, one CTA an SM. Either way one 8-byte shared load of a packed row
// feeds a thread's eight columns, and the next k16 step's shared loads are
// issued before this step's math. The K loop steps by one quantisation
// group through a ring of shared-memory stages that cp.async fills with
// 16-byte copies (x tile, packed tile, the group's scale and zero rows,
// inv_act). N is any width, as the TPU kernel takes: the last column tile
// holds the tail, whose columns past N are zero-filled in shared memory
// (a zero scale makes them add nothing) and never stored. A packed row (N
// bytes) or a scale / zero row (4 N bytes) starts on a boundary of the
// largest power of two (at most 16) that divides its length. Where N is a
// multiple of 16 every copy is 16 bytes (wna16_gemm.cu); otherwise the
// NARROW instantiations (wna16_gemm_narrow.cu, one library of their own so
// that the two build in parallel) copy a tile's 16-byte chunks in pieces of
// that width (the planner's pk_vec / sz_vec, which the kernel derives from N
// itself): cp.async of 8 or 4 bytes, or plain 2- and 1-byte loads
// (an N with no factor of 4), which the barrier before a stage is read
// orders as it does the copies, and store the output a column at a time
// where N has no factor of 4. Where the M x N grid leaves SMs idle, K is split over grid.z;
// the splits of one tile form a thread block cluster, and after the K loop
// each CTA sums its share of the tile over the cluster's shared memory in
// rank order (deterministic, no atomics), adds the bias and casts.
//
// The launch plan (row tile, splits, groups a split, passes, stages, the
// stage layout and the shared bytes) is made by the Python planner
// `plan` in kernels/wna16_gemm.py; this file only executes it.
#pragma once
#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"

namespace cg = cooperative_groups;

// The launch plan; the ctypes mirror in kernels/wna16_gemm.py lists the
// same fields in the same order. Offsets and strides are bytes.
struct Wna16Plan {
  int bm;                // rows of x a CTA: 8 or 16 (decode), 64
  int splits;            // CTAs along K a tile, the cluster's size along z
  int groups_per_split;
  int passes;            // mma passes a k-step: 1, or 2 / 3 bf16 parts
  int stages;            // depth of the cp.async ring, in groups
  int x_stride;          // a row of the x tile
  int pk_stride;         // a row of the packed tile
  int off_pk, off_s, off_z, off_inv;  // regions within a stage
  int stage_bytes;
  int smem;              // dynamic shared bytes of the launch
};

namespace {

constexpr int kBN = 256;
constexpr int kRedStride = kBN + 4;  // floats a row of the split-reduce tile

struct Args {
  const void* x;
  const uint8_t* packed;
  const float* scales;
  const float* zeros;
  const float* inv_act;
  const float* bias;
  void* out;
  int M, K, N, group;
  Wna16Plan p;
};

// no memory clobber: wait_group and the barrier after it order the writes
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 8 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 4 : 0));
}

// One 16-byte chunk of a row: its first `valid` bytes from src, the rest
// zero, in pieces of `vec` bytes (src and `valid` are multiples of vec).
// An invalid piece reads nothing.
__device__ __forceinline__ void copy_chunk(unsigned char* dst, const unsigned char* src,
                                           int valid, int vec) {
  if (vec == 16) {
    cp_async16(dst, src, valid > 0);
  } else if (vec == 8) {
#pragma unroll
    for (int o = 0; o < 16; o += 8) cp_async8(dst + o, src + o, o < valid);
  } else if (vec == 4) {
#pragma unroll
    for (int o = 0; o < 16; o += 4) cp_async4(dst + o, src + o, o < valid);
  } else if (vec == 2) {
#pragma unroll
    for (int o = 0; o < 16; o += 2)
      *reinterpret_cast<unsigned short*>(dst + o) =
          o < valid ? *reinterpret_cast<const unsigned short*>(src + o) : 0;
  } else {
#pragma unroll
    for (int o = 0; o < 16; ++o) dst[o] = o < valid ? src[o] : 0;
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
// wait until at most n groups are pending (n < 8, from the plan's stages)
__device__ __forceinline__ void cp_async_wait_dyn(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    default: cp_async_wait<6>(); break;
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3]) : "r"(s));
}

template <typename TC>
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  if constexpr (std::is_same<TC, __half>::value) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  } else {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
}

// The weight operand is q + OFF (see the header); the fold subtracts
// z + OFF. The split passes (EXACT, float32 outputs among them) take q
// itself.
template <typename TC, int BITS, bool EXACT>
constexpr float kOff =
    std::is_same<TC, __half>::value ? 1024.f : (BITS == 4 && !EXACT ? 128.f : 0.f);

// byte i of w and of w2 into the two 16-bit lanes (even k low, odd k high)
__device__ __forceinline__ uint32_t lanes(uint32_t w, uint32_t w2, int i) {
  return __byte_perm(w, w2, i | (i << 4) | ((4 + i) << 8) | ((4 + i) << 12));
}

// The packed words of one k16 step that a thread reads: 8 neighbouring
// columns (8 (lane / 4) .. + 7 of the warp's 64) of packed rows q, q + 4
// (int4) or k rows 2q, 2q + 1, 2q + 8, 2q + 9 (int8), q = lane % 4.
template <int BITS>
struct Packed {
  uint2 w[BITS == 4 ? 2 : 4];
};

template <int BITS>
__device__ __forceinline__ Packed<BITS> load_packed(const unsigned char* pk, int stride,
                                                    int ks, int q) {
  Packed<BITS> r;
  if constexpr (BITS == 4) {
    r.w[0] = *reinterpret_cast<const uint2*>(pk + (ks * 8 + q) * stride);
    r.w[1] = *reinterpret_cast<const uint2*>(pk + (ks * 8 + 4 + q) * stride);
  } else {
    const int k = ks * 16 + 2 * q;
    r.w[0] = *reinterpret_cast<const uint2*>(pk + k * stride);
    r.w[1] = *reinterpret_cast<const uint2*>(pk + (k + 1) * stride);
    r.w[2] = *reinterpret_cast<const uint2*>(pk + (k + 8) * stride);
    r.w[3] = *reinterpret_cast<const uint2*>(pk + (k + 9) * stride);
  }
  return r;
}

// The 16-bit operand pair q + OFF of column i (0..7) of the words, k rows
// 2q, 2q + 1 (h = 0) or 2q + 8, 2q + 9 (h = 1). int4: 0x4300 | n is bf16
// 128 + n and 0x6400 | n fp16 1024 + n (EXACT subtracts the bf16 128 again);
// int8: 0x6400 | b is fp16 1024 + b, and 0x4b0000bb is the float 2^23 + b,
// which minus 2^23 is b, whose top 16 bits are its bf16 value exactly.
template <typename TC, int BITS, bool EXACT>
__device__ __forceinline__ uint32_t operand(const Packed<BITS>& pw, int h, int i) {
  constexpr bool kF16 = std::is_same<TC, __half>::value;
  const int b = i & 3;
  if constexpr (BITS == 4) {
    const uint32_t w = i < 4 ? pw.w[h].x : pw.w[h].y;
    const uint32_t v = (lanes(w, w >> 4, b) & 0x000f000fu) | (kF16 ? 0x64006400u : 0x43004300u);
    if constexpr (EXACT) {
      const __nv_bfloat162 d = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&v),
                                       __floats2bfloat162_rn(128.f, 128.f));
      return *reinterpret_cast<const uint32_t*>(&d);
    } else {
      return v;
    }
  } else {
    const uint32_t e = i < 4 ? pw.w[2 * h].x : pw.w[2 * h].y;
    const uint32_t o = i < 4 ? pw.w[2 * h + 1].x : pw.w[2 * h + 1].y;
    if constexpr (kF16) {
      return (lanes(e, o, b) & 0x00ff00ffu) | 0x64006400u;
    } else {
      const uint32_t sel = b | 0x7440;
      const float fe = __uint_as_float(__byte_perm(e, 0x4b000000u, sel)) - 8388608.f;
      const float fo = __uint_as_float(__byte_perm(o, 0x4b000000u, sel)) - 8388608.f;
      return __byte_perm(__float_as_uint(fe), __float_as_uint(fo), 0x7632);
    }
  }
}

__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load_pair(const __half* p) {
  return __half22float2(*reinterpret_cast<const __half2*>(p));
}

// the next bf16 part of v (round to nearest), taken off v
__device__ __forceinline__ uint32_t take_part(float2& v) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v.x, v.y);
  const float2 f = __bfloat1622float2(h);
  v.x -= f.x;
  v.y -= f.y;
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
__device__ __forceinline__ void store1(__half* p, float v) { *p = __float2half(v); }

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&a);
  u.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}
__device__ __forceinline__ void store4(__half* p, float4 v) {
  const __half2 a = __floats2half2_rn(v.x, v.y);
  const __half2 b = __floats2half2_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&a);
  u.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

// TX: x and out. BITS: 4 or 8. BM: rows of x a CTA. BM = 8 or 16 is the
// decode shape: four warps, each 64 columns as four m16 tiles of the weight
// (the A operand: the product is computed transposed) against BM / 8 n8
// tiles of x^T; a thread's accumulators hold 8 neighbouring columns. BM = 64
// is the prefill shape: eight warps, two row warps of two m16 tiles of x
// (the A operand) against eight n8 tiles of the weight, interleaved by 8;
// a thread's accumulators hold 16 neighbouring columns. KS: k16 steps a
// quantisation group (group 32, 64, 128). SPLIT: the bf16 parts of
// x * inv_act (float32 x, or inv_act given) instead of x itself. NARROW:
// the plan's copy widths and a column-wise store (rows of N not a multiple
// of 16 bytes), else 16-byte copies and 4-column stores.
template <typename TX, int BITS, int BM, int KS, bool SPLIT, bool NARROW>
__global__ void __launch_bounds__(BM == 64 ? 256 : 128, BM == 64 ? 1 : (SPLIT ? 3 : 4))
wna16_kernel(const Args a) {
  using TC = typename std::conditional<SPLIT, __nv_bfloat16, TX>::type;
  static_assert(SPLIT || !std::is_same<TX, float>::value, "float32 x takes the split passes");
  constexpr bool kDecode = BM <= 16;
  constexpr int kThreads = kDecode ? 128 : 256;
  constexpr int AM = kDecode ? 4 : 2;       // m16 tiles a warp
  constexpr int AN = kDecode ? BM / 8 : 8;  // n8 tiles a warp
  constexpr float off = kOff<TC, BITS, SPLIT>;
  extern __shared__ __align__(16) unsigned char smem[];
  const Wna16Plan& p = a.p;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int q = lane & 3, r = lane >> 2;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * BM;
  const int G = a.K / a.group;
  const int g0 = blockIdx.z * p.groups_per_split;
  const int ng = min(G, g0 + p.groups_per_split) - g0;
  // a warp with no column inside N skips the math (its columns are zero)
  const bool live = n0 + wn * 64 < a.N;
  const bool has_inv = SPLIT && a.inv_act != nullptr;
  unsigned char* ring = smem;
  const TX* x = static_cast<const TX*>(a.x);
  constexpr int kGroup = 16 * KS;
  constexpr int pk_rows = BITS == 4 ? kGroup / 2 : kGroup;
  const int wrow = kDecode ? 0 : wm * 32;  // the warp's first row in the tile

  // Each thread copies the same chunk column of every row it visits, so
  // its sources and destinations step by constants: x rows of xc 16-byte
  // chunks (xc divides the thread count), packed rows of 16 chunks, and
  // (threads 0-127) one chunk of the scale or zero row.
  constexpr int xc = kGroup * (int)sizeof(TX) / 16;
  constexpr int x_step = kThreads / xc;
  const int x_row0 = tid / xc;
  const TX* x_src = x + (size_t)(m0 + x_row0) * a.K + (tid % xc) * (16 / (int)sizeof(TX));
  const int x_dst = x_row0 * p.x_stride + (tid % xc) * 16;
  // the thread's 16-byte chunk of a packed row (a byte a column) and of a
  // scale or zero row (4 bytes a column): inside N or not (a multiple of 16
  // bytes) and, NARROW, its bytes inside N; chunks past N read from the
  // row's start and copy nothing
  const int pk_row0 = tid / (kBN / 16);
  constexpr int kPkStep = kThreads / (kBN / 16);
  const int pk_col = n0 + (tid % (kBN / 16)) * 16;
  const bool pk_ok = pk_col < a.N;
  // NARROW: the planner's copy widths (pk_vec, sz_vec), the largest power
  // of two, at most 16, that divides a row's bytes; derived here from N so
  // that Wna16Plan, and with it the 16-byte build's code, stays as it was
  const int pk_vec = NARROW ? min(16, a.N & -a.N) : 16;
  const int sz_vec = min(16, 4 * pk_vec);
  const int pk_valid = NARROW ? max(0, min(16, a.N - pk_col)) : 0;
  const uint8_t* pk_src = a.packed + (size_t)pk_row0 * a.N + (pk_ok ? pk_col : 0);
  const int pk_dst = p.off_pk + pk_row0 * p.pk_stride + (tid % (kBN / 16)) * 16;
  const int sz_col = n0 + (tid % (kBN / 4)) * 4;
  const bool sz_ok = tid < kBN / 2 && sz_col < a.N;
  const int sz_valid = NARROW && sz_ok ? 4 * min(4, a.N - sz_col) : 0;
  const float* sz_src = (tid < kBN / 4 ? a.scales : a.zeros) + (sz_ok ? sz_col : 0);
  const int sz_dst = (tid < kBN / 4 ? p.off_s : p.off_z) + (tid % (kBN / 4)) * 16;

  auto load = [&](int slot, int g) {
    unsigned char* st = ring + slot * p.stage_bytes;
    const TX* xs = x_src + (size_t)g * kGroup;
    for (int row = x_row0, d = x_dst; row < BM; row += x_step, d += x_step * p.x_stride) {
      const bool ok = m0 + row < a.M;  // rows past M are zero-filled
      cp_async16(st + d, ok ? xs : x, ok);
      xs += (size_t)x_step * a.K;
    }
    const uint8_t* ps = pk_src + (size_t)g * pk_rows * a.N;
    for (int row = pk_row0, d = pk_dst; row < pk_rows;
         row += kPkStep, d += kPkStep * p.pk_stride) {
      if constexpr (NARROW) {
        copy_chunk(st + d, ps, pk_valid, pk_vec);
      } else {
        cp_async16(st + d, ps, pk_ok);
      }
      ps += (size_t)kPkStep * a.N;
    }
    if constexpr (NARROW) {
      if (tid < kBN / 2)
        copy_chunk(st + sz_dst, reinterpret_cast<const unsigned char*>(sz_src + (size_t)g * a.N),
                   sz_valid, sz_vec);
    } else {
      if (tid < kBN / 2) cp_async16(st + sz_dst, sz_src + (size_t)g * a.N, sz_ok);
    }
    if (has_inv)
      for (int i = tid; i < kGroup / 4; i += kThreads)
        cp_async16(st + p.off_inv + i * 16, a.inv_act + (size_t)g * kGroup + i * 4, true);
  };

  // The x operand of one k16 step, direct: the A fragments of the warp's
  // two m16 row tiles (prefill) or the B fragments of its n8 tiles of x^T
  // (decode), by ldmatrix
  struct XFrag {
    uint32_t f[4 * (kDecode ? (BM + 15) / 16 : AM)];
  };
  auto load_x = [&](const unsigned char* st, int ks) {
    XFrag xf{};
    if constexpr (!SPLIT) {
      if constexpr (kDecode) {
        // lanes 0-7 rows 0-7 at k0, 8-15 rows 0-7 at k0 + 8, 16-31 rows 8-15
        const int row = (lane & 7) + (lane >> 4) * 8;
        const unsigned char* ad = st + (BM == 8 ? (lane & 7) : row) * p.x_stride
                                  + (ks * 16 + ((lane >> 3) & 1) * 8) * 2;
        uint32_t t4[4];
        ldmatrix_x4(t4, ad);
#pragma unroll
        for (int j = 0; j < 4; ++j) xf.f[j] = t4[j];
      } else {
#pragma unroll
        for (int mt = 0; mt < AM; ++mt) {
          uint32_t t4[4];
          ldmatrix_x4(t4, st + (wrow + mt * 16 + (lane & 15)) * p.x_stride
                              + (ks * 16 + (lane >> 4) * 8) * 2);
#pragma unroll
          for (int j = 0; j < 4; ++j) xf.f[4 * mt + j] = t4[j];
        }
      }
    }
    return xf;
  };

  // the split passes' x pairs of one k16 step, x * inv_act in float32
  auto x_pair = [&](const unsigned char* st, int row, int k) {
    float2 v = load_pair(reinterpret_cast<const TX*>(st + row * p.x_stride) + k);
    if (has_inv) {
      const float2 w = *reinterpret_cast<const float2*>(st + p.off_inv + k * 4);
      v.x *= w.x;
      v.y *= w.y;
    }
    return v;
  };

  // P_g, and S_g as the product of x with ones (its rows' sums, from the
  // same operands as P_g): decode S[nx] holds rows nx * 8 + 2 q (+ 1) in
  // lanes 0 (1); prefill S[mt] rows wrow + mt * 16 + r (+ 8) in lanes 0 (2)
  constexpr int NS = kDecode ? AN : AM;
  constexpr uint32_t kOnes = std::is_same<TC, __half>::value ? 0x3c003c00u : 0x3f803f80u;
  const uint32_t ones[4] = {kOnes, kOnes, kOnes, kOnes};
  const uint32_t ones2[2] = {kOnes, kOnes};
  float acc[AM][AN][4], P[AM][AN][4], S[NS][4];
#pragma unroll
  for (int i = 0; i < AM; ++i)
#pragma unroll
    for (int j = 0; j < AN; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = P[i][j][v] = 0.f;
#pragma unroll
  for (int i = 0; i < NS; ++i)
#pragma unroll
    for (int v = 0; v < 4; ++v) S[i][v] = 0.f;

  for (int s = 0; s < p.stages - 1; ++s) {
    if (s < ng) load(s, g0 + s);
    cp_async_commit();
  }
  for (int it = 0; it < ng; ++it) {
    cp_async_wait_dyn(p.stages - 2);
    __syncthreads();  // group it landed; every warp is done with group it - 1
    const int nxt = it + p.stages - 1;
    if (nxt < ng) load(nxt % p.stages, g0 + nxt);
    cp_async_commit();
    const unsigned char* st = ring + (it % p.stages) * p.stage_bytes;
    if (live) {
      const unsigned char* pk = st + p.off_pk + wn * 64 + 8 * r;
      // the next step's shared loads are issued before this step's math
      Packed<BITS> w_cur = load_packed<BITS>(pk, p.pk_stride, 0, q);
      XFrag x_cur = load_x(st, 0);
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const int kn = min(ks + 1, KS - 1);
        const Packed<BITS> w_nxt = load_packed<BITS>(pk, p.pk_stride, kn, q);
        const XFrag x_nxt = load_x(st, kn);
        if constexpr (kDecode) {
          // A: column 8 (lane / 4) + 2 mt (+ 1 for A rows 8-15) of the warp's
          // 64; B: x^T rows nx * 8 + lane / 4
          uint32_t wa[AM][4];
#pragma unroll
          for (int mt = 0; mt < AM; ++mt) {
            wa[mt][0] = operand<TC, BITS, SPLIT>(w_cur, 0, 2 * mt);
            wa[mt][1] = operand<TC, BITS, SPLIT>(w_cur, 0, 2 * mt + 1);
            wa[mt][2] = operand<TC, BITS, SPLIT>(w_cur, 1, 2 * mt);
            wa[mt][3] = operand<TC, BITS, SPLIT>(w_cur, 1, 2 * mt + 1);
          }
          if constexpr (!SPLIT) {
#pragma unroll
            for (int nx = 0; nx < AN; ++nx) {
              const uint32_t xb[2] = {x_cur.f[2 * nx], x_cur.f[2 * nx + 1]};
#pragma unroll
              for (int mt = 0; mt < AM; ++mt) mma16816<TC>(P[mt][nx], wa[mt], xb);
              mma16816<TC>(S[nx], ones, xb);
            }
          } else {
#pragma unroll
            for (int nx = 0; nx < AN; ++nx) {
              float2 v[2] = {x_pair(st, nx * 8 + r, ks * 16 + 2 * q),
                             x_pair(st, nx * 8 + r, ks * 16 + 2 * q + 8)};
              for (int pass = 0; pass < p.passes; ++pass) {
                const uint32_t xb[2] = {take_part(v[0]), take_part(v[1])};
#pragma unroll
                for (int mt = 0; mt < AM; ++mt) mma16816<TC>(P[mt][nx], wa[mt], xb);
                mma16816<TC>(S[nx], ones, xb);
              }
            }
          }
        } else {
          // B: n-tile t, mma column j is column 8 j + t of the warp's 64
          uint32_t wb[8][2];
#pragma unroll
          for (int t = 0; t < 8; ++t) {
            wb[t][0] = operand<TC, BITS, SPLIT>(w_cur, 0, t);
            wb[t][1] = operand<TC, BITS, SPLIT>(w_cur, 1, t);
          }
#pragma unroll
          for (int mt = 0; mt < AM; ++mt) {
            if constexpr (!SPLIT) {
              const uint32_t xa[4] = {x_cur.f[4 * mt], x_cur.f[4 * mt + 1],
                                      x_cur.f[4 * mt + 2], x_cur.f[4 * mt + 3]};
#pragma unroll
              for (int t = 0; t < 8; ++t) mma16816<TC>(P[mt][t], xa, wb[t]);
              mma16816<TC>(S[mt], xa, ones2);
            } else {
              // a0: (row r, k 2q), a1: (r + 8, 2q), a2: (r, 2q + 8), a3: (r + 8, 2q + 8)
              float2 v[4];
#pragma unroll
              for (int j = 0; j < 4; ++j)
                v[j] = x_pair(st, wrow + mt * 16 + r + (j & 1) * 8,
                              ks * 16 + 2 * q + (j >> 1) * 8);
              for (int pass = 0; pass < p.passes; ++pass) {
                uint32_t xa[4];
#pragma unroll
                for (int j = 0; j < 4; ++j) xa[j] = take_part(v[j]);
#pragma unroll
                for (int t = 0; t < 8; ++t) mma16816<TC>(P[mt][t], xa, wb[t]);
                mma16816<TC>(S[mt], xa, ones2);
              }
            }
          }
        }
        w_cur = w_nxt;
        x_cur = x_nxt;
      }
    }
    if (live) {
      // decode: value v of (mt, nx) is column 8 r + 2 mt + (v >> 1), row
      // nx * 8 + 2 q + (v & 1); prefill: value v of (mt, t) is column
      // 16 q + 8 (v & 1) + t, row wrow + mt * 16 + r + 8 (v >> 1)
      constexpr int kC = kDecode ? 8 : 16;
      const int c0 = wn * 64 + (kDecode ? 8 * r : 16 * q);
      const float* sc = reinterpret_cast<const float*>(st + p.off_s) + c0;
      const float* zc = reinterpret_cast<const float*>(st + p.off_z) + c0;
      float sv[kC], zv[kC];
#pragma unroll
      for (int j = 0; j < kC / 4; ++j) {
        const float4 s4 = *reinterpret_cast<const float4*>(sc + 4 * j);
        const float4 z4 = *reinterpret_cast<const float4*>(zc + 4 * j);
        sv[4 * j] = s4.x; sv[4 * j + 1] = s4.y; sv[4 * j + 2] = s4.z; sv[4 * j + 3] = s4.w;
        zv[4 * j] = z4.x + off; zv[4 * j + 1] = z4.y + off;
        zv[4 * j + 2] = z4.z + off; zv[4 * j + 3] = z4.w + off;
      }
#pragma unroll
      for (int i = 0; i < AM; ++i)
#pragma unroll
        for (int j = 0; j < AN; ++j)
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            const int c = kDecode ? 2 * i + (v >> 1) : (v & 1) * 8 + j;
            const float sum = kDecode ? S[j][v & 1] : S[i][v & 2];
            acc[i][j][v] = fmaf(sv[c], fmaf(-zv[c], sum, P[i][j][v]), acc[i][j][v]);
            P[i][j][v] = 0.f;
          }
#pragma unroll
      for (int i = 0; i < NS; ++i)
#pragma unroll
        for (int v = 0; v < 4; ++v) S[i][v] = 0.f;
    }
  }

  // the tile's partial sums into shared memory (over the ring), then each
  // CTA of the cluster sums its share of the tile over the splits in rank
  // order, adds the bias and casts
  cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);
  if (live) {
    if constexpr (kDecode) {
#pragma unroll
      for (int nx = 0; nx < AN; ++nx)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float* dst = red + (nx * 8 + 2 * q + e) * kRedStride + wn * 64 + 8 * r;
          store4(dst, make_float4(acc[0][nx][e], acc[0][nx][2 + e], acc[1][nx][e],
                                  acc[1][nx][2 + e]));
          store4(dst + 4, make_float4(acc[2][nx][e], acc[2][nx][2 + e], acc[3][nx][e],
                                      acc[3][nx][2 + e]));
        }
    } else {
#pragma unroll
      for (int mt = 0; mt < AM; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float* dst = red + (wrow + mt * 16 + r + 8 * h) * kRedStride + wn * 64 + 16 * q + 8 * e;
            const int v = 2 * h + e;
            store4(dst, make_float4(acc[mt][0][v], acc[mt][1][v], acc[mt][2][v], acc[mt][3][v]));
            store4(dst + 4, make_float4(acc[mt][4][v], acc[mt][5][v], acc[mt][6][v], acc[mt][7][v]));
          }
    }
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int rank = static_cast<int>(cluster.block_rank());
  TX* out = static_cast<TX*>(a.out);
  // four columns a store: vector stores where N keeps a row's four on a
  // 4-column boundary (always, without NARROW), else one column at a time
  // up to N
  const bool vec_out = (a.N & 3) == 0;
  for (int i = rank * kThreads + tid; i < BM * kBN / 4; i += p.splits * kThreads) {
    const int row = i / (kBN / 4), col = (i % (kBN / 4)) * 4;
    if (m0 + row >= a.M || n0 + col >= a.N) continue;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k = 0; k < p.splits; ++k) {
      const float4 v = *reinterpret_cast<const float4*>(
          cluster.map_shared_rank(red, k) + row * kRedStride + col);
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
    }
    if (!NARROW || vec_out) {
      if (a.bias != nullptr) {
        const float4 bv = *reinterpret_cast<const float4*>(a.bias + n0 + col);
        sum.x += bv.x;
        sum.y += bv.y;
        sum.z += bv.z;
        sum.w += bv.w;
      }
      store4(out + (size_t)(m0 + row) * a.N + n0 + col, sum);
    } else {
      TX* o = out + (size_t)(m0 + row) * a.N + n0 + col;
      const float v[4] = {sum.x, sum.y, sum.z, sum.w};
      for (int e = 0; e < 4 && n0 + col + e < a.N; ++e)
        store1(o + e, v[e] + (a.bias != nullptr ? a.bias[n0 + col + e] : 0.f));
    }
  }
  cluster.sync();  // no CTA leaves while another reads its shared memory
}

template <typename TX, int BITS, int BM, int KS, bool SPLIT, bool NARROW>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  auto kern = wna16_kernel<TX, BITS, BM, KS, SPLIT, NARROW>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, a.p.smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.N + kBN - 1) / kBN, (a.M + BM - 1) / BM, a.p.splits);
  cfg.blockDim = dim3(BM == 64 ? 256 : 128);
  cfg.dynamicSmemBytes = a.p.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = a.p.splits;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename TX, int BITS, int BM, bool SPLIT, bool NARROW>
cudaError_t launch_group(const Args& a, cudaStream_t stream) {
  switch (a.group) {
    case 32: return launch<TX, BITS, BM, 2, SPLIT, NARROW>(a, stream);
    case 64: return launch<TX, BITS, BM, 4, SPLIT, NARROW>(a, stream);
    case 128: return launch<TX, BITS, BM, 8, SPLIT, NARROW>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename TX, int BITS, bool SPLIT, bool NARROW>
cudaError_t launch_tile(const Args& a, cudaStream_t stream) {
  switch (a.p.bm) {
    case 8: return launch_group<TX, BITS, 8, SPLIT, NARROW>(a, stream);
    case 16: return launch_group<TX, BITS, 16, SPLIT, NARROW>(a, stream);
    case 64: return launch_group<TX, BITS, 64, SPLIT, NARROW>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename TX, bool SPLIT, bool NARROW>
cudaError_t launch_bits(int bits, const Args& a, cudaStream_t stream) {
  if (bits == 4) return launch_tile<TX, 4, SPLIT, NARROW>(a, stream);
  if (bits == 8) return launch_tile<TX, 8, SPLIT, NARROW>(a, stream);
  return cudaErrorInvalidValue;
}

// The C entry points' body (wna16_gemm.cu, wna16_gemm_narrow.cu). The
// wrapper has checked shapes, dtypes, alignment and contiguity and made
// `plan`. Returns the launch's CUDA error code.
template <bool NARROW>
int wna16_entry(const void* x, int x_dtype, const void* packed, const void* scales,
                const void* zeros, const void* inv_act, const void* bias, void* out, int M,
                int K, int N, int bits, int group, const Wna16Plan* plan,
                void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  const Args a{x, static_cast<const uint8_t*>(packed), static_cast<const float*>(scales),
               static_cast<const float*>(zeros), static_cast<const float*>(inv_act),
               static_cast<const float*>(bias), out, M, K, N, group, *plan};
  const bool split = plan->passes > 1;
  cudaError_t err = cudaErrorInvalidValue;
  switch (x_dtype) {
    case morph::kF32:
      if (split) err = launch_bits<float, true, NARROW>(bits, a, stream);
      break;
    case morph::kBF16:
      err = split ? launch_bits<__nv_bfloat16, true, NARROW>(bits, a, stream)
                  : launch_bits<__nv_bfloat16, false, NARROW>(bits, a, stream);
      break;
    case morph::kF16:
      err = split ? launch_bits<__half, true, NARROW>(bits, a, stream)
                  : launch_bits<__half, false, NARROW>(bits, a, stream);
      break;
    default:
      break;
  }
  return static_cast<int>(err);
}

}  // namespace
