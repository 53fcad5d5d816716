// Flash-attention forward for Hopper (sm_90a), bound through a plain C entry.
//
// Replaces the Pallas TPU kernel `_fa_kernel` in
// src/repro/kernels/flash_attention/flash_attention.py: blockwise
// online-softmax attention that never writes the score matrix to device
// memory, with an optional log-sum-exp output for the backward pass.
//
//   q    (B, H, Sq, D)   T, strided (see flash_common.cuh)
//   k, v (B, K, Sk, D)   T, strided; query head h reads KV head h / (H / K)
//   o    (B, H, Sq, D)   T, strided
//   lse  (B, H, Sq)      float32, contiguous (may be null)
//
// Masking follows the reference: keys past Sk, after the query (causal) or
// `window` or more behind it are replaced by -1e30 before the softmax, and
// tile pairs that are masked by position alone are skipped.  Scores,
// softmax state and the output accumulator are float32 for both input
// types; a row whose running sum is 0 divides by 1, as the reference does.
//
// Design (first version: simple and right).  One block per (q tile of 64
// rows, query head, batch row); the KV head is h / G and is never
// materialised per query head.  The block stages its q tile once, then for
// each k tile stages K and V as float in shared memory; each thread scores
// 16 keys of its row with 16-byte shared reads, the row's four threads
// reduce max and sum with shuffles, P goes through shared memory, and each
// thread accumulates D / 4 output columns in registers.  What bounds it on
// an H100: its arithmetic, 4 * D flops per visible (query, key) pair (38.7
// GFLOP for the causal main shape B 8, H 9, S 2048, D 64) over the tensor
// cores' 989 TFLOP/s in bf16; the bytes (q, k, v, o once each) are far
// below that line.  This kernel runs on the CUDA cores in float32 FMA, so
// it stays well above that bound: wgmma tiles fed by TMA are later work.
#include "flash_common.cuh"

namespace {

using namespace repro_fa;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
fa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o,
              float* __restrict__ lse, int H, int G, int Sq, int Sk,
              Strides sq, Strides sk, Strides sv, Strides so, int causal,
              int window, float scale) {
  constexpr int LD = D + kPad;
  constexpr int PLD = kBK + kPad;
  constexpr int kOut = D / 16;             // float4 output chunks per thread
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  float* k_s = q_s + kBQ * LD;
  float* v_s = k_s + kBK * LD;
  float* p_s = v_s + kBK * LD;

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y, b = blockIdx.z, kh = h / G;
  const int tid = threadIdx.x, r = tid >> 2, sub = tid & 3;
  const int qpos = q0 + r;
  const T* qp = q + b * sq.b + h * sq.h;
  const T* kp = k + b * sk.b + kh * sk.h;
  const T* vp = v + b * sv.b + kh * sv.h;

  load_tile<T, D>(q_s, qp, sq.s, q0, Sq);

  float m = kNegInf, l = 0.f;
  float acc[4 * kOut];
#pragma unroll
  for (int i = 0; i < 4 * kOut; ++i) acc[i] = 0.f;

  const int nk = (Sk + kBK - 1) / kBK;
  for (int kb = 0; kb < nk; ++kb) {
    const int k0 = kb * kBK;
    if (!tile_runs(q0, k0, causal, window)) continue;
    __syncthreads();                       // last tile's readers are done
    load_tile<T, D>(k_s, kp, sk.s, k0, Sk);
    load_tile<T, D>(v_s, vp, sv.s, k0, Sk);
    __syncthreads();

    float s[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) s[j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float4 qv = *reinterpret_cast<const float4*>(q_s + r * LD + d);
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        s[j] = dot4(qv, *reinterpret_cast<const float4*>(
                            k_s + (sub + 4 * j) * LD + d), s[j]);
    }
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int kpos = k0 + sub + 4 * j;
      s[j] = visible(qpos, kpos, Sk, causal, window) ? s[j] * scale
                                                     : kNegInf;
      mx = fmaxf(mx, s[j]);
    }
    const float m_new = fmaxf(m, row_max(mx));
    const float alpha = expf(m - m_new);
    float ls = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const float p = expf(s[j] - m_new);
      ls += p;
      p_s[r * PLD + sub + 4 * j] = p;
    }
    l = alpha * l + row_sum(ls);
    m = m_new;
#pragma unroll
    for (int i = 0; i < 4 * kOut; ++i) acc[i] *= alpha;
    __syncwarp();                          // row r's P is written by its warp

#pragma unroll 2
    for (int c = 0; c < kBK; c += 4) {
      const float4 p4 = *reinterpret_cast<const float4*>(p_s + r * PLD + c);
      const float pc[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
      for (int cc = 0; cc < 4; ++cc)
#pragma unroll
        for (int i = 0; i < kOut; ++i)
          axpy4(pc[cc], *reinterpret_cast<const float4*>(
                            v_s + (c + cc) * LD + 16 * i + 4 * sub),
                acc + 4 * i);
    }
  }

  if (qpos < Sq) {
    const float ll = l == 0.f ? 1.f : l;
    const float inv = 1.f / ll;
    T* op = o + b * so.b + h * so.h + qpos * so.s;
#pragma unroll
    for (int i = 0; i < kOut; ++i)
      store4(op + 16 * i + 4 * sub,
             make_float4(acc[4 * i] * inv, acc[4 * i + 1] * inv,
                         acc[4 * i + 2] * inv, acc[4 * i + 3] * inv));
    if (lse != nullptr && sub == 0)
      lse[(static_cast<long long>(b) * H + h) * Sq + qpos] = m + logf(ll);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, const long long* st, int B, int H, int K,
                   int Sq, int Sk, int causal, int window, float scale,
                   cudaStream_t stream) {
  constexpr int smem = (3 * 64 * (D + kPad) + 64 * (kBK + kPad)) * 4;
  auto kernel = fa_fwd_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o),
      static_cast<float*>(lse), H, H / K, Sq, Sk,
      Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
      Strides{st[6], st[7], st[8]}, Strides{st[9], st[10], st[11]}, causal,
      window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v,
                     void* o, void* lse, const long long* st, int B, int H,
                     int K, int Sq, int Sk, int causal, int window,
                     float scale, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, o, lse, st, B, H, K, Sq, Sk, causal,
                           window, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, lse, st, B, H, K, Sq, Sk, causal,
                           window, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, lse, st, B, H, K, Sq, Sk, causal,
                            window, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// strides: 12 int64 element strides, (b, head, s) of q, k, v and o in that
// order.  dtype: 0 = float32, 1 = bfloat16.  lse may be null.  Returns the
// launch's cudaError_t (0 on success); the Python wrapper checks shapes,
// dtypes, devices and alignment before the call and raises on a non-zero
// return.
extern "C" int repro_flash_attention_fwd(const void* q, const void* k,
                                         const void* v, void* o, void* lse,
                                         const long long* strides, int B,
                                         int H, int K, int Sq, int Sk, int D,
                                         int causal, int window, float scale,
                                         int dtype, void* stream) {
  if (B <= 0 || K <= 0 || H % K != 0 || Sq <= 0 || Sk <= 0 ||
      H > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();  // the code returned below belongs to this call
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(launch_d<float>(D, q, k, v, o, lse, strides, B,
                                            H, K, Sq, Sk, causal, window,
                                            scale, s));
  if (dtype == 1)
    return static_cast<int>(launch_d<__nv_bfloat16>(
        D, q, k, v, o, lse, strides, B, H, K, Sq, Sk, causal, window, scale,
        s));
  return static_cast<int>(cudaErrorInvalidValue);
}
