// Paged-attention decode for Hopper (sm_90a), bound through a plain C entry.
//
// Replaces the Pallas TPU kernel `_pa_kernel` in
// src/repro/kernels/paged_attention/paged_attention.py: one new query token
// per sequence attends over KV that lives in a paged pool, walking the
// sequence's row of the MMU block table.
//
//   q       (B, H, d)          T, contiguous
//   k, v    (P, page, K, d)    T, contiguous (a per-layer view of the pool)
//   tables  (B, maxp)          int32 physical page ids, -1 = unmapped
//   lens    (B,)               int32 valid tokens per sequence
//   out     (B, H, d)          T
//
// d is any multiple of 8 up to 128; it runs on the next built width D (32,
// 64 or 128): each lane keeps D/32 accumulator elements, those at or past
// d never loaded, summed or stored.
//
// The G = H / K query heads of KV head kh are heads kh*G .. kh*G+G-1 (the
// reference reshapes q to (B, K, G, D)).  Positions at or past lens[b] are
// masked; a page whose table entry is -1 is skipped without being read
// (the TPU kernel fetched page 0 in its place and masked it).  The softmax
// runs online in float32 with scale 1/sqrt(d) unless the caller gives one;
// a row with no valid position writes exactly 0.
//
// Design (first version: simple and right).  One block per (b, kh, group of
// up to 4 query heads, split of the row's pages), one warp per query head.
// The block stages up to 32 tokens of a page's K and V rows into shared
// memory as float; lane t scores token t, the warp reduces max and sum with
// shuffles, and each lane keeps D/32 elements of the output accumulator
// plus the running max and sum in registers.  A page walk is a chain of
// dependent loads, so one block per (b, kh) leaves most of the card idle at
// decode batch sizes: the wrapper splits each row's pages over enough
// blocks to fill the SMs (flash-decoding), each split writes its partial
// (max, sum, accumulator) to a float32 workspace, and a second kernel
// combines the splits.  With a single split the first kernel writes the
// output itself.  What bounds it on the card: bytes of K and V read
// (sum_b lens[b] * K * D * 2 * sizeof(T)) over 3.35 TB/s; the arithmetic
// is 4 * H * D flops per token, far below the tensor-core line.  K and V
// are read once per (b, kh, split), shared by the G heads of the group.
// Not yet done: cp.async/TMA double buffering and 16-byte vector loads.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kTile = 32;   // tokens staged per pass: one per lane
constexpr int kWarps = 4;   // query heads per block: one warp each
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                       const T* __restrict__ v_pages,
                       const int* __restrict__ tables,
                       const int* __restrict__ lens, T* __restrict__ out,
                       float* __restrict__ ws, int H, int K, int G, int P,
                       int page, int maxp, int split_pages, int d,
                       float scale) {
  constexpr int E = D / 32;                // accumulator elements per lane
  __shared__ float k_s[kTile][D + 1];      // +1: lane t reads row t, no
  __shared__ float v_s[kTile][D];          //     bank conflicts
  __shared__ float q_s[kWarps][D];
  __shared__ float p_s[kWarps][kTile];

  const int wpb = blockDim.x / 32;
  const int chunks = (G + wpb - 1) / wpb;  // head groups per KV head
  const int b = blockIdx.x;
  const int kh = blockIdx.y / chunks;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = (blockIdx.y % chunks) * wpb + warp;
  const bool active = g < G;               // last group may be partial
  const int h = kh * G + g;
  const size_t qo = (static_cast<size_t>(b) * H + h) * d;

  if (active)
    for (int c = lane; c < d; c += 32) q_s[warp][c] = to_float(q[qo + c]);

  float m = kNegInf, l = 0.f, acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;

  const int len = lens[b];
  const int n_pages = len > 0 ? min((len + page - 1) / page, maxp) : 0;
  const int j_end = min(n_pages, (blockIdx.z + 1) * split_pages);
  const int* row = tables + static_cast<size_t>(b) * maxp;
  const size_t tok = static_cast<size_t>(K) * d;   // stride between tokens

  // every branch below depends on (b, j) only: uniform over the block, so
  // the __syncthreads inside the loops are reached by all threads
  for (int j = blockIdx.z * split_pages; j < j_end; ++j) {
    const int pp = row[j];
    if (pp < 0 || pp >= P) continue;               // unmapped: never read
    const int valid = min(page, len - j * page);
    const size_t base = static_cast<size_t>(pp) * page * tok +
                        static_cast<size_t>(kh) * d;
    for (int t0 = 0; t0 < valid; t0 += kTile) {
      const int n = min(kTile, valid - t0);
      __syncthreads();                             // last tile consumed
      for (int i = threadIdx.x; i < n * d; i += blockDim.x) {
        const int t = i / d, c = i % d;
        const size_t off = base + static_cast<size_t>(t0 + t) * tok + c;
        k_s[t][c] = to_float(k_pages[off]);
        v_s[t][c] = to_float(v_pages[off]);
      }
      __syncthreads();
      if (!active) continue;
      float s = kNegInf;
      if (lane < n) {
        float dot = 0.f;
#pragma unroll 8
        for (int c = 0; c < d; ++c) dot += q_s[warp][c] * k_s[lane][c];
        s = dot * scale;
      }
      const float m_new = fmaxf(m, warp_max(s));  // finite: n >= 1
      const float alpha = expf(m - m_new);
      const float p = lane < n ? expf(s - m_new) : 0.f;
      l = l * alpha + warp_sum(p);
      p_s[warp][lane] = p;
      __syncwarp();
#pragma unroll
      for (int e = 0; e < E; ++e) {
        if (lane + 32 * e >= d) continue;          // the tail past d
        float a = 0.f;
        for (int t = 0; t < n; ++t) a += p_s[warp][t] * v_s[t][lane + 32 * e];
        acc[e] = acc[e] * alpha + a;
      }
      m = m_new;
    }
  }
  if (!active) return;
  if (gridDim.z == 1) {
    const float inv = l > 0.f ? 1.f / l : 0.f;     // empty row -> exactly 0
#pragma unroll
    for (int e = 0; e < E; ++e)
      if (lane + 32 * e < d) store(&out[qo + lane + 32 * e], acc[e] * inv);
    return;
  }
  // partial result of this split: ws row (b, h, split) = [m, l, acc[d]]
  float* w = ws + ((static_cast<size_t>(b) * H + h) * gridDim.z +
                   blockIdx.z) * (d + 2);
  if (lane == 0) {
    w[0] = m;
    w[1] = l;
  }
#pragma unroll
  for (int e = 0; e < E; ++e)
    if (lane + 32 * e < d) w[2 + lane + 32 * e] = acc[e];
}

// Combine the splits of each (b, h): one warp per output row.  A split that
// saw no valid token has l = 0 and m = -1e30, so it weighs nothing; a row
// with no valid token at all writes exactly 0.
template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32)
combine_kernel(const float* __restrict__ ws, T* __restrict__ out, int rows,
               int splits, int d) {
  constexpr int E = D / 32;
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const float* w = ws + static_cast<size_t>(row) * splits * (d + 2);
  float mx = kNegInf;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, w[s * (d + 2)]);
  float l = 0.f, acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float* ws_s = w + s * (d + 2);
    const float c = expf(ws_s[0] - mx);
    l += c * ws_s[1];
#pragma unroll
    for (int e = 0; e < E; ++e)
      if (lane + 32 * e < d) acc[e] += c * ws_s[2 + lane + 32 * e];
  }
  const float inv = l > 0.f ? 1.f / l : 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e)
    if (lane + 32 * e < d)
      store(&out[static_cast<size_t>(row) * d + lane + 32 * e], acc[e] * inv);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* tables, const void* lens, void* out, void* ws,
                   int B, int H, int K, int P, int page, int maxp, int splits,
                   int d, float scale, cudaStream_t stream) {
  const int G = H / K;
  const int warps = G < kWarps ? G : kWarps;
  const int split_pages = (maxp + splits - 1) / splits;
  dim3 grid(B, K * ((G + warps - 1) / warps), splits);
  paged_attention_kernel<T, D><<<grid, warps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(tables),
      static_cast<const int*>(lens), static_cast<T*>(out),
      static_cast<float*>(ws), H, K, G, P, page, maxp, split_pages, d, scale);
  if (splits > 1) {
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const int rows = B * H;
    combine_kernel<T, D><<<(rows + kWarps - 1) / kWarps, kWarps * 32, 0,
                           stream>>>(static_cast<const float*>(ws),
                                     static_cast<T*>(out), rows, splits, d);
  }
  return cudaGetLastError();
}

// d runs on the next built width: 32, 64 or 128.
template <typename T>
cudaError_t launch_d(int d, const void* q, const void* k, const void* v,
                     const void* tables, const void* lens, void* out,
                     void* ws, int B, int H, int K, int P, int page, int maxp,
                     int splits, float scale, cudaStream_t stream) {
#define REPRO_PA_ARGS q, k, v, tables, lens, out, ws, B, H, K, P, page, maxp, \
                      splits, d, scale, stream
  if (d <= 0 || d % 8 != 0 || d > 128) return cudaErrorInvalidValue;
  if (d <= 32) return launch<T, 32>(REPRO_PA_ARGS);
  if (d <= 64) return launch<T, 64>(REPRO_PA_ARGS);
  return launch<T, 128>(REPRO_PA_ARGS);
#undef REPRO_PA_ARGS
}

}  // namespace

// D: the head dim, any multiple of 8 up to 128.  dtype: 0 = float32, 1 =
// bfloat16.  splits: blocks each row's pages are
// divided over; with splits > 1, ws is a float32 workspace of
// B * H * splits * (D + 2) elements.  Returns the launches' cudaError_t (0
// on success); the Python wrapper raises on anything else.  Shapes, dtypes
// and contiguity are checked by the wrapper before the call.
extern "C" int repro_paged_attention(const void* q, const void* k,
                                     const void* v, const void* tables,
                                     const void* lens, void* out, void* ws,
                                     int B, int H, int K, int D, int P,
                                     int page, int maxp, int splits,
                                     float scale, int dtype, void* stream) {
  if (B <= 0 || K <= 0 || H % K != 0 || page <= 0 || maxp <= 0 ||
      splits <= 0 || splits > maxp || (splits > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();  // the code returned below belongs to this call
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch_d<float>(D, q, k, v, tables, lens, out, ws, B, H, K, P,
                          page, maxp, splits, scale, s);
  else if (dtype == 1)
    err = launch_d<__nv_bfloat16>(D, q, k, v, tables, lens, out, ws, B, H,
                                  K, P, page, maxp, splits, scale, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
