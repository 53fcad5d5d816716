// bf16 building blocks of the SSD kernels that run on the tensor cores
// (ssd.cu's chunk-parallel forward, ssd_bwd.cu's chunk-parallel backward):
// the launch geometry, and the staging of operand tiles into the swizzled
// layout wgmma reads (hopper.cuh) by 16-byte stores of one warpgroup, with
// float32 operands split into bf16 hi + lo tiles.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace repro_ssd_tc {

using namespace repro_tc;

constexpr int kTcThreads = 128;  // one warpgroup
typedef __nv_bfloat16 bf16;

// Launch geometry shared by the host and the kernels: a chunk occupies LT
// rows (L rounded up to 64-row tiles); nc chunks cover S.
struct Geo {
  int S, H, G, P, N, L, LT, nc;
};

// Rows [0, rows) of a bf16 slice with row stride ld (elements) into a
// Swz<W> tile of `rows` rows: rows at or past `valid` and columns at or past
// `cols` (a multiple of 8, <= W) as zeros, never loaded.
template <int W>
__device__ __forceinline__ void stage(uint32_t tile, const bf16* src,
                                      long long ld, int rows, int valid,
                                      int cols) {
  constexpr int kCh = W / 8;  // 16-byte chunks of a row
  for (int e = threadIdx.x; e < rows * kCh; e += kTcThreads) {
    const int r = e / kCh, col = (e % kCh) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid && col < cols)
      v = *reinterpret_cast<const uint4*>(src + r * ld + col);
    sts128(swz_addr<W>(tile, rows, r, col), v);
  }
}

// Eight floats as bf16 hi + lo into element (r, col) of two Swz<W> tiles.
template <int W>
__device__ __forceinline__ void stage_split8(uint32_t hi_t, uint32_t lo_t,
                                             int rows, int r, int col,
                                             const float (&v)[8]) {
  uint32_t h[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) split_bf16(v[2 * i], v[2 * i + 1], h[i], l[i]);
  sts128(swz_addr<W>(hi_t, rows, r, col), make_uint4(h[0], h[1], h[2], h[3]));
  sts128(swz_addr<W>(lo_t, rows, r, col), make_uint4(l[0], l[1], l[2], l[3]));
}

__device__ __forceinline__ void unpack8(uint4 u, float (&v)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// 64 rows of a bf16 slice (row stride ld), each row r scaled by w[r], as
// bf16 hi + lo into two 64-row Swz<W> tiles: rows at or past `valid` and
// columns at or past `cols` as zeros.
template <int W>
__device__ __forceinline__ void stage_scaled_split(uint32_t hi_t,
                                                   uint32_t lo_t,
                                                   const bf16* src,
                                                   long long ld, int valid,
                                                   int cols, const float* w) {
  constexpr int kCh = W / 8;
  for (int e = threadIdx.x; e < 64 * kCh; e += kTcThreads) {
    const int r = e / kCh, col = (e % kCh) * 8;
    float vals[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (r < valid && col < cols) {
      unpack8(*reinterpret_cast<const uint4*>(src + r * ld + col), vals);
      const float s = w[r];
#pragma unroll
      for (int k = 0; k < 8; ++k) vals[k] *= s;
    }
    stage_split8<W>(hi_t, lo_t, 64, r, col, vals);
  }
}

// A float32 (rows, cols) matrix, contiguous (a state: rows P, cols N), as
// bf16 hi + lo into two 64-row Swz<W> tiles, zero past `rows` and `cols`.
template <int W>
__device__ __forceinline__ void stage_split_f32(uint32_t hi_t, uint32_t lo_t,
                                                const float* src, int rows,
                                                int cols) {
  constexpr int kCh = W / 8;
  for (int e = threadIdx.x; e < 64 * kCh; e += kTcThreads) {
    const int r = e / kCh, col = (e % kCh) * 8;
    float vals[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (r < rows && col < cols) {
      const float4 u0 = *reinterpret_cast<const float4*>(src + r * cols + col);
      const float4 u1 =
          *reinterpret_cast<const float4*>(src + r * cols + col + 4);
      vals[0] = u0.x; vals[1] = u0.y; vals[2] = u0.z; vals[3] = u0.w;
      vals[4] = u1.x; vals[5] = u1.y; vals[6] = u1.z; vals[7] = u1.w;
    }
    stage_split8<W>(hi_t, lo_t, 64, r, col, vals);
  }
}

// A float pair as bf16 hi + mid + lo, each the nearest bf16 pair of what
// the ones before leave, so hi + mid + lo keeps about 24 bits of each
// value's mantissa.
__device__ __forceinline__ void split3_bf16(float x, float y, uint32_t& hi,
                                            uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const float rx = x - hf.x, ry = y - hf.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(rx, ry);
  const float2 mf = __bfloat1622float2(m);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  mid = *reinterpret_cast<const uint32_t*>(&m);
  lo = pack_bf16(rx - mf.x, ry - mf.y);
}

// The register A fragments of a 64 x N float accumulator as bf16 hi + mid
// + lo (hopper.cuh's to_a_frags2, one term more).
template <int N>
__device__ __forceinline__ void to_a_frags3(const float (&d)[N / 2],
                                            uint32_t (&hi)[N / 16][4],
                                            uint32_t (&mid)[N / 16][4],
                                            uint32_t (&lo)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      split3_bf16(d[8 * kk + 2 * r], d[8 * kk + 2 * r + 1], hi[kk][r],
                  mid[kk][r], lo[kk][r]);
}

}  // namespace repro_ssd_tc
