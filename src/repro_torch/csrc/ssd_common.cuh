// Float32 building blocks of the SSD kernels that run on the CUDA cores
// (ssd.cu's ssd_kernel, the forward in float32 FMA, and ssd_bwd.cu's
// backward): a block of kThreads threads as a 16 x 16 grid of register
// tiles, shared-memory products fed by 16-byte reads, and row loads of a
// strided (S, cols) slice that read rows at or past S as zeros.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro_ssd {

constexpr int kThreads = 256;   // a 16 x 16 grid: row group, column group
constexpr int kPad = 4;         // floats of padding per shared row

struct Strides {
  long long b, s, h;
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// acc[i][j] += sum_k a[(rg + 16 i) * lda + k] * b[(cg + 16 j) * ldb + k]
// for k < K: the thread's rows of a (shared by the eight threads of a
// quarter warp, so broadcast) against its interleaved rows of b.
template <int R, int Q, int K>
__device__ __forceinline__ void dot_tile(const float* a, int lda,
                                         const float* b, int ldb, int rg,
                                         int cg, float (&acc)[R][Q]) {
#pragma unroll 4
  for (int k = 0; k < K; k += 4) {
    float4 av[R], bv[Q];
#pragma unroll
    for (int i = 0; i < R; ++i)
      av[i] = *reinterpret_cast<const float4*>(a + (rg + 16 * i) * lda + k);
#pragma unroll
    for (int j = 0; j < Q; ++j)
      bv[j] = *reinterpret_cast<const float4*>(b + (cg + 16 * j) * ldb + k);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < Q; ++j) {
        acc[i][j] = fmaf(av[i].x, bv[j].x, acc[i][j]);
        acc[i][j] = fmaf(av[i].y, bv[j].y, acc[i][j]);
        acc[i][j] = fmaf(av[i].z, bv[j].z, acc[i][j]);
        acc[i][j] = fmaf(av[i].w, bv[j].w, acc[i][j]);
      }
  }
}

// acc[i][j] += sum_k a[(rg + 16 i) * lda + k] * b[k * ldb + cg + 16 j]
// for k < K: as dot_tile, with b stored k-major (its rows are k), so that
// the sixteen threads of a half warp read sixteen neighbouring floats.
template <int R, int Q, int K>
__device__ __forceinline__ void dot_tile_kn(const float* a, int lda,
                                            const float* b, int ldb, int rg,
                                            int cg, float (&acc)[R][Q]) {
#pragma unroll 2
  for (int k = 0; k < K; k += 4) {
    float4 av[R];
#pragma unroll
    for (int i = 0; i < R; ++i)
      av[i] = *reinterpret_cast<const float4*>(a + (rg + 16 * i) * lda + k);
#pragma unroll
    for (int j = 0; j < Q; ++j) {
      const float* bc = b + k * ldb + cg + 16 * j;
      const float b0 = bc[0], b1 = bc[ldb], b2 = bc[2 * ldb],
                  b3 = bc[3 * ldb];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        acc[i][j] = fmaf(av[i].x, b0, acc[i][j]);
        acc[i][j] = fmaf(av[i].y, b1, acc[i][j]);
        acc[i][j] = fmaf(av[i].z, b2, acc[i][j]);
        acc[i][j] = fmaf(av[i].w, b3, acc[i][j]);
      }
    }
  }
}

// rows [s0, s0 + rows) of a (S, cols) slice with row stride ld (elements)
// into dst[r * ldd + c] as float; rows at or past S read as 0
template <typename T, int COLS>
__device__ __forceinline__ void load_rows(float* dst, int ldd, const T* src,
                                          long long ld, int s0, int rows,
                                          int S) {
  for (int e = threadIdx.x; e < rows * COLS; e += kThreads) {
    const int r = e / COLS, c = e % COLS;
    const int s = s0 + r;
    dst[r * ldd + c] = s < S ? to_float(src[s * ld + c]) : 0.f;
  }
}

// the same, transposed: dst[c * ldd + r]
template <typename T, int COLS>
__device__ __forceinline__ void load_rows_t(float* dst, int ldd, const T* src,
                                            long long ld, int s0, int rows,
                                            int S) {
  for (int e = threadIdx.x; e < rows * COLS; e += kThreads) {
    const int r = e / COLS, c = e % COLS;
    const int s = s0 + r;
    dst[c * ldd + r] = s < S ? to_float(src[s * ld + c]) : 0.f;
  }
}

}  // namespace repro_ssd
