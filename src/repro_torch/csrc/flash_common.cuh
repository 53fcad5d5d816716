// Pieces shared by the flash-attention forward (flash_attention.cu) and
// backward (flash_attention_bwd.cu) kernels for Hopper (sm_90a): the
// mask, the row reductions and the strides of every kernel, and the tile
// layout of the float32 FMA kernels (the float32 forward and dkv, and dq
// for both types; the bf16 tensor-core kernels use hopper.cuh's).
//
// FMA tiles are 64 query rows by 64 key rows, staged in shared memory as
// float whatever the input type, with rows padded by 4 floats so that the
// 16-byte reads of neighbouring rows fall on different banks.  A block has
// 256 threads: thread t owns tile row t / 4 and one quarter (t % 4) of its
// columns, so the four threads of a row are neighbouring lanes of one warp
// and reduce a row with two shuffles.
//
// Tensors are (B, heads, S, d) as seen by the caller, given by element
// strides for b, head and s; d is contiguous.  Every kernel is built for a
// width D of 32, 64 or 128 and takes any d <= D that is a multiple of 8:
// the columns at or past d are staged as zeros (they change no product)
// and never stored.  The wrappers check that
// every stride is a multiple of 16 bytes (4 float32 or 8 bf16 elements,
// as TMA needs) and every base 16-byte aligned, so a row chunk of 4
// elements is one vector load.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro_fa {

constexpr int kBQ = 64;        // query rows per tile
constexpr int kBK = 64;        // key rows per tile
constexpr int kThreads = 256;  // 4 threads per tile row
constexpr int kPad = 4;        // floats of padding per shared row
constexpr int kCols = kBK / 4; // score columns per thread: sub + 4 * j
constexpr float kNegInf = -1e30f;  // the reference's NEG_INF: finite

struct Strides {
  long long b, h, s;
};

// The width a head dim d runs at: the next of 32, 64 and 128, or 0 for a d
// the kernels do not take (not a multiple of 8, or over 128).
__host__ __device__ constexpr int built_width(int d) {
  return d <= 0 || d % 8 != 0 || d > 128 ? 0
         : d <= 32                       ? 32
         : d <= 64                       ? 64
                                         : 128;
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  const float2 a = __bfloat1622float2(h[0]);
  const float2 b = __bfloat1622float2(h[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  __nv_bfloat162 a = __floats2bfloat162_rn(x.x, x.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(x.z, x.w);
  uint2 u;
  u.x = *reinterpret_cast<unsigned*>(&a);
  u.y = *reinterpret_cast<unsigned*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ void axpy4(float a, float4 x, float* y) {
  y[0] = fmaf(a, x.x, y[0]);
  y[1] = fmaf(a, x.y, y[1]);
  y[2] = fmaf(a, x.z, y[2]);
  y[3] = fmaf(a, x.w, y[3]);
}

__device__ __forceinline__ float row_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float row_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Stage rows [row0, row0 + 64) of one (b, head) slice of head dim d into
// dst (64 rows of D + kPad floats, D the built width >= d); rows at or past
// n_rows and columns at or past d read as 0 and are never loaded (d is a
// multiple of 8, so a 4-column chunk is wholly inside or outside).
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* base,
                                          long long row_stride, int row0,
                                          int n_rows, int d) {
  constexpr int kV = D / 4;
  for (int i = threadIdx.x; i < 64 * kV; i += kThreads) {
    const int r = i / kV, c = (i % kV) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n_rows && c < d)
      x = load4(base + (row0 + r) * row_stride + c);
    store4(dst + r * (D + kPad) + c, x);
  }
}

// The reference's mask (flash_attention.py::_fa_kernel): a key is visible
// when it lies inside the sequence, at or before the query (causal), and
// less than `window` behind it (sliding window).
__device__ __forceinline__ bool visible(int qpos, int kpos, int sk,
                                        int causal, int window) {
  return kpos < sk && (!causal || kpos <= qpos) &&
         (window <= 0 || kpos > qpos - window);
}

// Whether the tile pair (q rows from q0, k rows from k0) has any visible
// entry by position alone: the reference's block-level short-outs.
__device__ __forceinline__ bool tile_runs(int q0, int k0, int causal,
                                          int window) {
  if (causal && k0 > q0 + kBQ - 1) return false;
  if (window > 0 && k0 + kBK - 1 <= q0 - window) return false;
  return true;
}

}  // namespace repro_fa
