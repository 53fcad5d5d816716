// Flash-attention backward for Hopper (sm_90a): the dq and dkv kernels,
// bound through plain C entries.
//
// Replace the Pallas TPU kernels `_dq_kernel` and `_dkv_kernel` in
// src/repro/kernels/flash_attention/flash_attention_bwd.py.  With
// P = exp(q k^T * scale - lse) recomputed from the forward's log-sum-exp and
// D = rowsum(dO * O):
//
//   dq = sum_k P * (dO v^T - D) k * scale           (fa_dq_kernel)
//   dv = sum_q P^T dO,  dk = sum_q (P * (dO v^T - D))^T q * scale
//                                                   (fa_dkv_kernel)
//
//   q, o, dO, dq (B, H, Sq, D)   T, strided (see flash_common.cuh)
//   k, v, dk, dv (B, K, Sk, D)   T, strided
//   lse, delta   (B, H, Sq)      float32, contiguous
//
// Masking and tile skipping follow the forward; query rows past Sq and key
// rows past Sk contribute nothing.  Everything is float32 inside.
//
// Design (first version: simple and right).  fa_dq_kernel: one block per
// (q tile, query head, batch row), as the reference's grid with the k axis
// walked inside the block; it computes D for its rows once, writes it to
// `delta` for the dkv kernel, and accumulates dq in registers.  The
// wrapper launches it before fa_dkv_kernel on the same stream.
// fa_dkv_kernel: one block per (k tile, KV head, batch row), looping over
// the G query heads of the group and their q tiles, so dk and dv are
// summed in registers with no atomics (the reference's design).  Each
// thread owns one key row's quarter; P and dS go through shared memory.
// What bounds them on an H100: their arithmetic, 6 * D flops per visible
// (query, key) pair for dq (q k^T, dO v^T, dS k) and 8 * D for dkv (q k^T,
// dO v^T, P^T dO, dS^T q): 135 GFLOP together at the causal main shape (B
// 8, H 9, S 2048, D 64), over the tensor cores' 989 TFLOP/s in bf16.
// These kernels run on the CUDA cores in float32 FMA: wgmma is later work.
#include "flash_common.cuh"

namespace {

using namespace repro_fa;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
fa_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ o,
             const T* __restrict__ dout, const float* __restrict__ lse,
             T* __restrict__ dq, float* __restrict__ delta, int H, int G,
             int Sq, int Sk, Strides sq, Strides sk, Strides sv, Strides so,
             Strides sdo, Strides sdq, int causal, int window, float scale) {
  constexpr int LD = D + kPad;
  constexpr int PLD = kBK + kPad;
  constexpr int kOut = D / 16;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  float* do_s = q_s + kBQ * LD;
  float* k_s = do_s + kBQ * LD;
  float* v_s = k_s + kBK * LD;
  float* ds_s = v_s + kBK * LD;

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y, b = blockIdx.z, kh = h / G;
  const int tid = threadIdx.x, r = tid >> 2, sub = tid & 3;
  const int qpos = q0 + r;
  const T* kp = k + b * sk.b + kh * sk.h;
  const T* vp = v + b * sv.b + kh * sv.h;

  load_tile<T, D>(q_s, q + b * sq.b + h * sq.h, sq.s, q0, Sq);
  load_tile<T, D>(do_s, dout + b * sdo.b + h * sdo.h, sdo.s, q0, Sq);
  __syncthreads();

  const long long row = (static_cast<long long>(b) * H + h) * Sq + qpos;
  float dl = 0.f;
  if (qpos < Sq) {
    const T* op = o + b * so.b + h * so.h + qpos * so.s;
#pragma unroll
    for (int i = 0; i < kOut; ++i)
      dl = dot4(load4(op + 16 * i + 4 * sub),
                *reinterpret_cast<const float4*>(do_s + r * LD + 16 * i +
                                                 4 * sub),
                dl);
  }
  dl = row_sum(dl);
  const float lse_r = qpos < Sq ? lse[row] : 0.f;
  if (qpos < Sq && sub == 0) delta[row] = dl;

  float acc[4 * kOut];
#pragma unroll
  for (int i = 0; i < 4 * kOut; ++i) acc[i] = 0.f;

  const int nk = (Sk + kBK - 1) / kBK;
  for (int kb = 0; kb < nk; ++kb) {
    const int k0 = kb * kBK;
    if (!tile_runs(q0, k0, causal, window)) continue;
    __syncthreads();
    load_tile<T, D>(k_s, kp, sk.s, k0, Sk);
    load_tile<T, D>(v_s, vp, sv.s, k0, Sk);
    __syncthreads();

    float s[kCols], dp[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) s[j] = dp[j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      const float4 qv = *reinterpret_cast<const float4*>(q_s + r * LD + d);
      const float4 dov = *reinterpret_cast<const float4*>(do_s + r * LD + d);
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = sub + 4 * j;
        s[j] = dot4(qv, *reinterpret_cast<const float4*>(k_s + c * LD + d),
                    s[j]);
        dp[j] = dot4(dov, *reinterpret_cast<const float4*>(v_s + c * LD + d),
                     dp[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int kpos = k0 + sub + 4 * j;
      const float p = visible(qpos, kpos, Sk, causal, window)
                          ? expf(s[j] * scale - lse_r)
                          : 0.f;
      ds_s[r * PLD + sub + 4 * j] = p * (dp[j] - dl);
    }
    __syncwarp();                          // row r's dS is written by its warp

#pragma unroll 2
    for (int c = 0; c < kBK; c += 4) {
      const float4 d4 = *reinterpret_cast<const float4*>(ds_s + r * PLD + c);
      const float dc[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
      for (int cc = 0; cc < 4; ++cc)
#pragma unroll
        for (int i = 0; i < kOut; ++i)
          axpy4(dc[cc], *reinterpret_cast<const float4*>(
                            k_s + (c + cc) * LD + 16 * i + 4 * sub),
                acc + 4 * i);
    }
  }

  if (qpos < Sq) {
    T* dqp = dq + b * sdq.b + h * sdq.h + qpos * sdq.s;
#pragma unroll
    for (int i = 0; i < kOut; ++i)
      store4(dqp + 16 * i + 4 * sub,
             make_float4(acc[4 * i] * scale, acc[4 * i + 1] * scale,
                         acc[4 * i + 2] * scale, acc[4 * i + 3] * scale));
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
fa_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dk, T* __restrict__ dv, int H, int G, int Sq,
              int Sk, Strides sq, Strides sk, Strides sv, Strides sdo,
              Strides sdk, Strides sdv, int causal, int window,
              float scale) {
  constexpr int LD = D + kPad;
  constexpr int PLD = kBQ + kPad;
  constexpr int kOut = D / 16;
  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);
  float* v_s = k_s + kBK * LD;
  float* q_s = v_s + kBK * LD;
  float* do_s = q_s + kBQ * LD;
  float* p_s = do_s + kBQ * LD;
  float* ds_s = p_s + kBK * PLD;
  float* lse_s = ds_s + kBK * PLD;
  float* dl_s = lse_s + kBQ;

  const int k0 = blockIdx.x * kBK;
  const int kh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, rk = tid >> 2, sub = tid & 3;
  const int kpos = k0 + rk;

  load_tile<T, D>(k_s, k + b * sk.b + kh * sk.h, sk.s, k0, Sk);
  load_tile<T, D>(v_s, v + b * sv.b + kh * sv.h, sv.s, k0, Sk);

  float dk_acc[4 * kOut], dv_acc[4 * kOut];
#pragma unroll
  for (int i = 0; i < 4 * kOut; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  const int nq = (Sq + kBQ - 1) / kBQ;
  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    const T* qp = q + b * sq.b + h * sq.h;
    const T* dop = dout + b * sdo.b + h * sdo.h;
    const long long lrow = (static_cast<long long>(b) * H + h) * Sq;
    for (int qb = 0; qb < nq; ++qb) {
      const int q0 = qb * kBQ;
      if (!tile_runs(q0, k0, causal, window)) continue;
      __syncthreads();                     // last tile's readers are done
      load_tile<T, D>(q_s, qp, sq.s, q0, Sq);
      load_tile<T, D>(do_s, dop, sdo.s, q0, Sq);
      if (tid < kBQ) {
        const int qq = q0 + tid;
        lse_s[tid] = qq < Sq ? lse[lrow + qq] : 0.f;
        dl_s[tid] = qq < Sq ? delta[lrow + qq] : 0.f;
      }
      __syncthreads();

      float st[kCols], dpt[kCols];
#pragma unroll
      for (int j = 0; j < kCols; ++j) st[j] = dpt[j] = 0.f;
#pragma unroll 2
      for (int d = 0; d < D; d += 4) {
        const float4 kv = *reinterpret_cast<const float4*>(k_s + rk * LD + d);
        const float4 vv = *reinterpret_cast<const float4*>(v_s + rk * LD + d);
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const int c = sub + 4 * j;
          st[j] = dot4(kv, *reinterpret_cast<const float4*>(q_s + c * LD + d),
                       st[j]);
          dpt[j] = dot4(vv,
                        *reinterpret_cast<const float4*>(do_s + c * LD + d),
                        dpt[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = sub + 4 * j, qpos = q0 + c;
        const float p = qpos < Sq && visible(qpos, kpos, Sk, causal, window)
                            ? expf(st[j] * scale - lse_s[c])
                            : 0.f;
        p_s[rk * PLD + c] = p;
        ds_s[rk * PLD + c] = p * (dpt[j] - dl_s[c]);
      }
      __syncwarp();                        // key row rk's P, dS: its warp

#pragma unroll 2
      for (int c = 0; c < kBQ; c += 4) {
        const float4 p4 =
            *reinterpret_cast<const float4*>(p_s + rk * PLD + c);
        const float4 d4 =
            *reinterpret_cast<const float4*>(ds_s + rk * PLD + c);
        const float pc[4] = {p4.x, p4.y, p4.z, p4.w};
        const float dc[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
        for (int cc = 0; cc < 4; ++cc)
#pragma unroll
          for (int i = 0; i < kOut; ++i) {
            const int off = (c + cc) * LD + 16 * i + 4 * sub;
            axpy4(pc[cc], *reinterpret_cast<const float4*>(do_s + off),
                  dv_acc + 4 * i);
            axpy4(dc[cc], *reinterpret_cast<const float4*>(q_s + off),
                  dk_acc + 4 * i);
          }
      }
    }
  }

  if (kpos < Sk) {
    T* dkp = dk + b * sdk.b + kh * sdk.h + kpos * sdk.s;
    T* dvp = dv + b * sdv.b + kh * sdv.h + kpos * sdv.s;
#pragma unroll
    for (int i = 0; i < kOut; ++i) {
      const int c = 16 * i + 4 * sub;
      store4(dkp + c, make_float4(dk_acc[4 * i] * scale,
                                  dk_acc[4 * i + 1] * scale,
                                  dk_acc[4 * i + 2] * scale,
                                  dk_acc[4 * i + 3] * scale));
      store4(dvp + c, make_float4(dv_acc[4 * i], dv_acc[4 * i + 1],
                                  dv_acc[4 * i + 2], dv_acc[4 * i + 3]));
    }
  }
}

Strides at(const long long* st, int i) {
  return Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
}

template <typename T, int D>
cudaError_t launch_dq(const void* const* t, const long long* st, int B,
                      int H, int K, int Sq, int Sk, int causal, int window,
                      float scale, cudaStream_t stream) {
  constexpr int smem = (4 * 64 * (D + kPad) + 64 * (kBK + kPad)) * 4;
  auto kernel = fa_dq_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(t[0]), static_cast<const T*>(t[1]),
      static_cast<const T*>(t[2]), static_cast<const T*>(t[3]),
      static_cast<const T*>(t[4]), static_cast<const float*>(t[5]),
      static_cast<T*>(const_cast<void*>(t[6])),
      static_cast<float*>(const_cast<void*>(t[7])), H, H / K, Sq, Sk,
      at(st, 0), at(st, 1), at(st, 2), at(st, 3), at(st, 4), at(st, 5),
      causal, window, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const void* const* t, const long long* st, int B,
                       int H, int K, int Sq, int Sk, int causal, int window,
                       float scale, cudaStream_t stream) {
  constexpr int smem =
      (4 * 64 * (D + kPad) + 2 * 64 * (kBQ + kPad) + 2 * kBQ) * 4;
  auto kernel = fa_dkv_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sk + kBK - 1) / kBK, K, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(t[0]), static_cast<const T*>(t[1]),
      static_cast<const T*>(t[2]), static_cast<const T*>(t[3]),
      static_cast<const float*>(t[4]), static_cast<const float*>(t[5]),
      static_cast<T*>(const_cast<void*>(t[6])),
      static_cast<T*>(const_cast<void*>(t[7])), H, H / K, Sq, Sk,
      at(st, 0), at(st, 1), at(st, 2), at(st, 3), at(st, 4), at(st, 5),
      causal, window, scale);
  return cudaGetLastError();
}

using Launch = cudaError_t (*)(const void* const*, const long long*, int, int,
                               int, int, int, int, int, float, cudaStream_t);

template <template <typename, int> class Pick>
Launch pick(int D, int dtype) {
  if (dtype == 0) {
    if (D == 32) return Pick<float, 32>::fn;
    if (D == 64) return Pick<float, 64>::fn;
    if (D == 128) return Pick<float, 128>::fn;
  } else if (dtype == 1) {
    if (D == 32) return Pick<__nv_bfloat16, 32>::fn;
    if (D == 64) return Pick<__nv_bfloat16, 64>::fn;
    if (D == 128) return Pick<__nv_bfloat16, 128>::fn;
  }
  return nullptr;
}

template <typename T, int D>
struct PickDq {
  static constexpr Launch fn = launch_dq<T, D>;
};

template <typename T, int D>
struct PickDkv {
  static constexpr Launch fn = launch_dkv<T, D>;
};

int run(Launch fn, const void* const* t, const long long* st, int B, int H,
        int K, int Sq, int Sk, int causal, int window, float scale,
        void* stream) {
  if (fn == nullptr || B <= 0 || K <= 0 || H % K != 0 || Sq <= 0 ||
      Sk <= 0 || H > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();  // the code returned below belongs to this call
  return static_cast<int>(fn(t, st, B, H, K, Sq, Sk, causal, window, scale,
                             static_cast<cudaStream_t>(stream)));
}

}  // namespace

// dq: tensors = {q, k, v, o, dO, lse, dq, delta}; strides: 18 int64
// element strides, (b, head, s) of q, k, v, o, dO and dq.  Writes dq and
// delta = rowsum(dO * O) (float32, (B, H, Sq), contiguous), which the dkv
// launch reads.  dtype: 0 = float32, 1 = bfloat16.  Returns the launch's
// cudaError_t (0 on success); the Python wrapper checks shapes, dtypes,
// devices and alignment before the call and raises on a non-zero return.
extern "C" int repro_flash_attention_dq(const void* const* tensors,
                                        const long long* strides, int B,
                                        int H, int K, int Sq, int Sk, int D,
                                        int causal, int window, float scale,
                                        int dtype, void* stream) {
  return run(pick<PickDq>(D, dtype), tensors, strides, B, H, K, Sq, Sk,
             causal, window, scale, stream);
}

// dkv: tensors = {q, k, v, dO, lse, delta, dk, dv}; strides: (b, head, s)
// of q, k, v, dO, dk and dv.  delta comes from the dq launch before it on
// the same stream.
extern "C" int repro_flash_attention_dkv(const void* const* tensors,
                                         const long long* strides, int B,
                                         int H, int K, int Sq, int Sk, int D,
                                         int causal, int window, float scale,
                                         int dtype, void* stream) {
  return run(pick<PickDkv>(D, dtype), tensors, strides, B, H, K, Sq, Sk,
             causal, window, scale, stream);
}
