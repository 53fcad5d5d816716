// Flash-attention backward for Hopper (sm_90a): the dq and dkv kernels,
// bound through plain C entries.
//
// Replace the Pallas TPU kernels `_dq_kernel` and `_dkv_kernel` in
// src/repro/kernels/flash_attention/flash_attention_bwd.py.  With
// P = exp(q k^T * scale - lse) recomputed from the forward's log-sum-exp and
// D = rowsum(dO * O):
//
//   dq = sum_k P * (dO v^T - D) k * scale
//                                (fa_dq_wgmma_kernel, fa_dq_kernel)
//   dv = sum_q P^T dO,  dk = sum_q (P * (dO v^T - D))^T q * scale
//                                (fa_dkv_wgmma_kernel, fa_dkv_kernel)
//
//   q, o, dO, dq (B, H, Sq, d)   T, strided (see flash_common.cuh)
//   k, v, dk, dv (B, K, Sk, d)   T, strided
//   lse, delta   (B, H, Sq)      float32, contiguous
//
// Masking and tile skipping follow the forward; query rows past Sq and key
// rows past Sk contribute nothing.  Sums are float32; the bf16 kernels
// round dS (dq) and P^T, dS^T (dkv) to bf16 as the operands of their last
// products.  Any head dim d <= 128 that is a multiple of 8 runs on the next
// built width (32, 64, 128) with zero columns past d, never stored.
//
// What bounds them on an H100: their arithmetic, 6 * D flops per visible
// (query, key) pair for dq (q k^T, dO v^T, dS k) and 8 * D for dkv (q k^T,
// dO v^T, P^T dO, dS^T q): 135 GFLOP together at the causal main shape (B
// 8, H 9, S 2048, D 64), over the tensor cores' 989 TFLOP/s in bf16.  The
// wrapper launches dq before dkv on the same stream: dq writes `delta`.
//
// fa_dq_wgmma_kernel (bf16).  One block per (query tile of 128 rows, query
// head, batch row), the heaviest causal tiles of each (head, batch row)
// first, of 384 threads: two consumer warpgroups of 64 query rows and a
// producer warpgroup (registers given away by setmaxnreg) whose first
// thread stages q and dO once by TMA and streams K and V tiles through a
// two-stage ring.  Each consumer first computes delta = rowsum(dO o) for
// its rows (a quad of lanes per row, 16-byte loads) and writes it for the
// dkv kernel.  Per key tile, on wgmma with float32 accumulators: S = q K^T
// and dP = dO V^T from shared memory; P = exp2(S scale log2e - lse log2e)
// (computed while dP is still on the tensor cores) and dS = P (dP -
// delta) in registers, masked only on tiles that straddle the diagonal,
// the window edge, Sq or Sk; then dq += dS K with dS rounded to bf16 as
// the register A operand and K read MN-major.  dq is scaled once in the
// epilogue.  Key tiles of 64 (32 at D 128, to keep S, dP and dq in
// registers); shared memory 65 KB at D 64, 97 KB at D 128.
//
// fa_dq_kernel (float32): the first version in float32 FMA, one block per
// (q tile of 64 rows, query head, batch row) staging tiles as float in
// shared memory, dq accumulated in registers.
//
// fa_dkv_wgmma_kernel (bf16).  One block per (key tile of 128 rows, KV
// head, batch row), the early (heaviest causal) key tiles first across
// all heads and batch rows, of 384 threads: two consumer warpgroups of 64
// key rows and a producer warpgroup (registers given to the consumers by
// setmaxnreg) whose first warp does the copies.  K and V are staged once
// by TMA; the block then loops over the G query heads of the group and
// their query tiles from the first visible one, so dk and dv sum in
// registers with no atomics (the reference's design).  The producer
// streams q and dO tiles through a two-stage ring by TMA and writes each
// tile's lse (times log2 e) and delta beside them.  Per (key tile, query
// tile), all on wgmma with float32 accumulators: S^T = K q^T and
// dP^T = V dO^T from shared memory; P^T = exp(S^T scale - lse) and
// dS^T = P^T (dP^T - delta) in registers, masked only on tiles that
// straddle the diagonal, the window edge, Sq or Sk; then dV += P^T dO and
// dK += dS^T q with P^T and dS^T rounded to bf16 as register A operands and
// dO, q read MN-major.  P^T is computed while dP^T is still on the tensor
// cores, dS^T while dV += P^T dO is.  dk is scaled once in the epilogue.
// Query tiles of 64 rows (32 at D 128, to keep S^T, dP^T, dk and dv in
// registers); shared memory 65 KB at D 64, 97 KB at D 128, 33 KB at D 32;
// one block per SM.
//
// fa_dkv_kernel (float32): the first version in float32 FMA, as the
// forward's float32 kernel (a float32 input is held to atol 5e-4 on its
// gradients, which TF32 products cannot promise).  Same grid and loop over
// 64-row tiles; each thread owns one key row's quarter; P and dS go
// through shared memory.
#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using namespace repro_fa;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
fa_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ o,
             const T* __restrict__ dout, const float* __restrict__ lse,
             T* __restrict__ dq, float* __restrict__ delta, int H, int G,
             int Sq, int Sk, int d, Strides sq, Strides sk, Strides sv, Strides so,
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

  load_tile<T, D>(q_s, q + b * sq.b + h * sq.h, sq.s, q0, Sq, d);
  load_tile<T, D>(do_s, dout + b * sdo.b + h * sdo.h, sdo.s, q0, Sq, d);
  __syncthreads();

  const long long row = (static_cast<long long>(b) * H + h) * Sq + qpos;
  float dl = 0.f;
  if (qpos < Sq) {
    const T* op = o + b * so.b + h * so.h + qpos * so.s;
#pragma unroll
    for (int i = 0; i < kOut; ++i)
      if (16 * i + 4 * sub < d)
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
    load_tile<T, D>(k_s, kp, sk.s, k0, Sk, d);
    load_tile<T, D>(v_s, vp, sv.s, k0, Sk, d);
    __syncthreads();

    float s[kCols], dp[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) s[j] = dp[j] = 0.f;
#pragma unroll 2
    for (int dd = 0; dd < D; dd += 4) {
      const float4 qv = *reinterpret_cast<const float4*>(q_s + r * LD + dd);
      const float4 dov = *reinterpret_cast<const float4*>(do_s + r * LD + dd);
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = sub + 4 * j;
        s[j] = dot4(qv, *reinterpret_cast<const float4*>(k_s + c * LD + dd),
                    s[j]);
        dp[j] = dot4(dov, *reinterpret_cast<const float4*>(v_s + c * LD + dd),
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
      if (16 * i + 4 * sub < d)
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
              int Sk, int d, Strides sq, Strides sk, Strides sv, Strides sdo,
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

  load_tile<T, D>(k_s, k + b * sk.b + kh * sk.h, sk.s, k0, Sk, d);
  load_tile<T, D>(v_s, v + b * sv.b + kh * sv.h, sv.s, k0, Sk, d);

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
      load_tile<T, D>(q_s, qp, sq.s, q0, Sq, d);
      load_tile<T, D>(do_s, dop, sdo.s, q0, Sq, d);
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
      for (int dd = 0; dd < D; dd += 4) {
        const float4 kv = *reinterpret_cast<const float4*>(k_s + rk * LD + dd);
        const float4 vv = *reinterpret_cast<const float4*>(v_s + rk * LD + dd);
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const int c = sub + 4 * j;
          st[j] = dot4(kv, *reinterpret_cast<const float4*>(q_s + c * LD + dd),
                       st[j]);
          dpt[j] = dot4(vv,
                        *reinterpret_cast<const float4*>(do_s + c * LD + dd),
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
      if (c >= d) continue;
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
                      int H, int K, int Sq, int Sk, int d, int causal,
                      int window, float scale, cudaStream_t stream) {
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
      static_cast<float*>(const_cast<void*>(t[7])), H, H / K, Sq, Sk, d,
      at(st, 0), at(st, 1), at(st, 2), at(st, 3), at(st, 4), at(st, 5),
      causal, window, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const void* const* t, const long long* st, int B,
                       int H, int K, int Sq, int Sk, int d, int causal,
                       int window, float scale, cudaStream_t stream) {
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
      static_cast<T*>(const_cast<void*>(t[7])), H, H / K, Sq, Sk, d,
      at(st, 0), at(st, 1), at(st, 2), at(st, 3), at(st, 4), at(st, 5),
      causal, window, scale);
  return cudaGetLastError();
}

// ------------------------------------------------ bf16: wgmma fed by TMA
using namespace repro_tc;

constexpr int kTcThreads = 3 * 128;  // two consumer warpgroups, a producer one
constexpr int kStages = 2;                // q/dO ring depth
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct DkvTile {
  static constexpr int kBK = 128;                 // key rows per block
  static constexpr int kBQ = D == 128 ? 32 : 64;  // query rows per step
  static constexpr int kKBytes = kBK * D * 2;     // K or V
  static constexpr int kQBytes = kBQ * D * 2;     // q or dO, one stage
  static constexpr int kBars = 1 + 2 * kStages;   // kv, full[], empty[]
  static constexpr int kSmem = 2 * kKBytes + 2 * kStages * kQBytes +
                               2 * kStages * kBQ * 4 + 8 * kBars + 1024;
};

template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
fa_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    const __grid_constant__ CUtensorMap domap,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dk,
                    __nv_bfloat16* __restrict__ dv, int B, int H, int K,
                    int Sq, int Sk, int d, Strides sdk, Strides sdv, int causal,
                    int window, float scale) {
  using L = Swz<D>;
  using Tl = DkvTile<D>;
  constexpr int BQ = Tl::kBQ, BK = Tl::kBK, NO = L::kW / 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  const uint32_t k_s = smem_u32(smem), v_s = k_s + Tl::kKBytes;
  const uint32_t qd_s = v_s + Tl::kKBytes;      // stage st: q, then dO
  float* lse_s = reinterpret_cast<float*>(smem + 2 * Tl::kKBytes +
                                          2 * kStages * Tl::kQBytes);
  float* dl_s = lse_s + kStages * BQ;
  const uint32_t bars = smem_u32(dl_s + kStages * BQ);
  const uint32_t kv_bar = bars;
  auto full = [&](int st) { return bars + 8 * (1 + st); };
  auto empty = [&](int st) { return bars + 8 * (1 + kStages + st); };
  auto q_tile = [&](int st) { return qd_s + 2 * st * Tl::kQBytes; };
  auto do_tile = [&](int st) { return q_tile(st) + Tl::kQBytes; };

  // the key tile is the slowest grid index, so the heaviest causal tiles
  // (the first ones) start first across all KV heads and batch rows
  const int nkb = K * B;
  const int k0 = blockIdx.x / nkb * BK;
  const int kh = blockIdx.x % nkb % K, b = blockIdx.x % nkb / K, G = H / K;
  const int nq = (Sq + BQ - 1) / BQ;            // query tiles that run
  const int qb_lo = causal ? k0 / BQ : 0;
  const int qb_hi =
      window > 0 ? min(nq - 1, (k0 + BK - 2 + window) / BQ) : nq - 1;
  const int per_head = max(0, qb_hi - qb_lo + 1);
  const int n = G * per_head;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    bar_init(kv_bar, 1);
    for (int st = 0; st < kStages; ++st) {
      bar_init(full(st), 32);                 // the producer warp's lanes
      bar_init(empty(st), 8);                 // lane 0 of each consumer warp
    }
    bar_init_fence();
  }
  __syncthreads();

  if (warp >= 8) {          // producer warpgroup: its first warp copies
    regs_release<40>();
    if (warp == 8) {
      if (lane == 0) {
        bar_expect(kv_bar, 2 * Tl::kKBytes);
        tma_tile<D>(k_s, &kmap, kv_bar, BK, k0, kh, b);
        tma_tile<D>(v_s, &vmap, kv_bar, BK, k0, kh, b);
      }
      for (int i = 0; i < n; ++i) {
        const int st = i % kStages;
        const int h = kh * G + i / per_head;
        const int q0 = (qb_lo + i % per_head) * BQ;
        bar_wait(empty(st), ((i / kStages) & 1) ^ 1);
        const long long row = (static_cast<long long>(b) * H + h) * Sq;
        for (int r = lane; r < BQ; r += 32) {
          const bool in = q0 + r < Sq;
          lse_s[st * BQ + r] = in ? lse[row + q0 + r] * kLog2e : 0.f;
          dl_s[st * BQ + r] = in ? delta[row + q0 + r] : 0.f;
        }
        if (lane == 0) {
          bar_expect(full(st), 2 * Tl::kQBytes);
          tma_tile<D>(q_tile(st), &qmap, full(st), BQ, q0, h, b);
          tma_tile<D>(do_tile(st), &domap, full(st), BQ, q0, h, b);
        } else {
          bar_arrive(full(st));
        }
      }
    }
  } else {                  // consumer warpgroups
    regs_claim<232>();

    // consumer warpgroup wg: key rows k0 + 64 wg + [0, 64); this thread's
    // key rows r0 and r0 + 8, query columns 8 j + c and + 1 of each n8 block
    const int wg = warp >> 2, wrow = k0 + 64 * wg;
    const int r0 = wrow + 16 * (warp & 3) + (lane >> 2), c = 2 * (lane & 3);
    const float scale_log2 = scale * kLog2e;
    float dk_acc[L::kHalves][NO], dv_acc[L::kHalves][NO];
#pragma unroll
    for (int hh = 0; hh < L::kHalves; ++hh)
#pragma unroll
      for (int i = 0; i < NO; ++i) dk_acc[hh][i] = dv_acc[hh][i] = 0.f;
    bar_wait(kv_bar, 0);

    // Per query tile: S^T and dP^T as two product groups; P^T is computed
    // while dP^T still runs, dS^T while dV += P^T dO runs.
    for (int i = 0; i < n; ++i) {
      const int st = i % kStages;
      const int q0 = (qb_lo + i % per_head) * BQ;
      bar_wait(full(st), (i / kStages) & 1);
      float s[BQ / 2], dp[BQ / 2];               // S^T and dP^T
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss(s, desc_k<D>(k_s, BK, 64 * wg, kk),
                 desc_k<D>(q_tile(st), BQ, 0, kk), kk > 0);
      wg_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss(dp, desc_k<D>(v_s, BK, 64 * wg, kk),
                 desc_k<D>(do_tile(st), BQ, 0, kk), kk > 0);
      wg_commit();

      const bool masked = q0 + BQ > Sq || wrow + 63 >= Sk ||
                          (causal && wrow + 63 > q0) ||
                          (window > 0 && wrow <= q0 + BQ - 1 - window);
      const float* ls = lse_s + st * BQ;
      const float* dls = dl_s + st * BQ;
      wg_wait<1>();
      pin(s);
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + c + (e & 1);
          float p = ex2(s[4 * j + e] * scale_log2 - ls[col]);
          if (masked && !(q0 + col < Sq &&
                          visible(q0 + col, r0 + 8 * (e >> 1), Sk, causal,
                                  window)))
            p = 0.f;
          s[4 * j + e] = p;
        }
      uint32_t pa[BQ / 16][4], da[BQ / 16][4];
      to_a_frags<BQ>(s, pa);
      pin(pa);
      wg_wait<0>();
      pin(dp);
#pragma unroll
      for (int hh = 0; hh < L::kHalves; ++hh) pin(dv_acc[hh]);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
        for (int hh = 0; hh < L::kHalves; ++hh)
          wgmma_rs(dv_acc[hh], pa[kk], desc_mn<D>(do_tile(st), BQ, hh, kk),
                   1);
      wg_commit();
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[4 * j + e] = s[4 * j + e] * (dp[4 * j + e] - dls[8 * j + c +
                                                              (e & 1)]);
      to_a_frags<BQ>(dp, da);
      pin(da);
#pragma unroll
      for (int hh = 0; hh < L::kHalves; ++hh) pin(dk_acc[hh]);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
        for (int hh = 0; hh < L::kHalves; ++hh)
          wgmma_rs(dk_acc[hh], da[kk], desc_mn<D>(q_tile(st), BQ, hh, kk),
                   1);
      wg_commit();
      wg_wait<0>();
      pin(pa);
      pin(da);
#pragma unroll
      for (int hh = 0; hh < L::kHalves; ++hh) {
        pin(dk_acc[hh]);
        pin(dv_acc[hh]);
      }
      __syncwarp();
      if (lane == 0) bar_arrive(empty(st));
    }

#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int row = r0 + 8 * rr;
      if (row >= Sk) continue;
      __nv_bfloat16* dkp = dk + b * sdk.b + kh * sdk.h + row * sdk.s;
      __nv_bfloat16* dvp = dv + b * sdv.b + kh * sdv.h + row * sdv.s;
#pragma unroll
      for (int hh = 0; hh < L::kHalves; ++hh)
#pragma unroll
        for (int j = 0; j < L::kW / 8; ++j) {
          const int col = hh * L::kW + 8 * j + c, e = 4 * j + 2 * rr;
          if (hh * L::kW + 8 * j >= d) continue;
          *reinterpret_cast<uint32_t*>(dkp + col) = pack_bf16(
              dk_acc[hh][e] * scale, dk_acc[hh][e + 1] * scale);
          *reinterpret_cast<uint32_t*>(dvp + col) =
              pack_bf16(dv_acc[hh][e], dv_acc[hh][e + 1]);
        }
    }
  }
}

// tensors = {q, k, v, dO, lse, delta, dk, dv}; strides as in launch_dkv
template <int D>
cudaError_t launch_dkv_tc(const void* const* t, const long long* st, int B,
                          int H, int K, int Sq, int Sk, int d, int causal,
                          int window, float scale, cudaStream_t stream) {
  using Tl = DkvTile<D>;
  CUtensorMap qm, km, vm, dom;
  if (!tile_map<D>(&qm, t[0], B, H, Sq, st, Tl::kBQ, d) ||
      !tile_map<D>(&km, t[1], B, K, Sk, st + 3, Tl::kBK, d) ||
      !tile_map<D>(&vm, t[2], B, K, Sk, st + 6, Tl::kBK, d) ||
      !tile_map<D>(&dom, t[3], B, H, Sq, st + 9, Tl::kBQ, d))
    return cudaErrorInvalidValue;
  auto kernel = fa_dkv_wgmma_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Tl::kSmem);
  if (err != cudaSuccess) return err;
  const long long blocks =
      static_cast<long long>((Sk + Tl::kBK - 1) / Tl::kBK) * K * B;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(blocks));
  kernel<<<grid, kTcThreads, Tl::kSmem, stream>>>(
      qm, km, vm, dom, static_cast<const float*>(t[4]),
      static_cast<const float*>(t[5]),
      static_cast<__nv_bfloat16*>(const_cast<void*>(t[6])),
      static_cast<__nv_bfloat16*>(const_cast<void*>(t[7])), B, H, K, Sq, Sk,
      d, at(st, 4), at(st, 5), causal, window, scale);
  return cudaGetLastError();
}

template <int D>
struct DqTile {
  static constexpr int kBQ = 128;                 // two consumer warpgroups
  static constexpr int kBK = D == 128 ? 32 : 64;  // key rows per step
  static constexpr int kQBytes = kBQ * D * 2;     // q or dO
  static constexpr int kKBytes = kBK * D * 2;     // K or V, one stage
  static constexpr int kBars = 1 + 2 * kStages;   // q/dO, full[], empty[]
  static constexpr int kSmem = 2 * kQBytes + 2 * kStages * kKBytes +
                               8 * kBars + 1024;
};

template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
fa_dq_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   const __grid_constant__ CUtensorMap domap,
                   const __nv_bfloat16* __restrict__ o,
                   const __nv_bfloat16* __restrict__ dout,
                   const float* __restrict__ lse,
                   __nv_bfloat16* __restrict__ dq, float* __restrict__ delta,
                   int H, int G, int Sq, int Sk, int d, Strides so,
                   Strides sdo, Strides sdq, int causal, int window,
                   float scale) {
  using L = Swz<D>;
  using Tl = DqTile<D>;
  constexpr int BQ = Tl::kBQ, BK = Tl::kBK, NO = L::kW / 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  const uint32_t q_s = smem_u32(smem), do_s = q_s + Tl::kQBytes;
  const uint32_t kv_s = do_s + Tl::kQBytes;       // stage st: K, then V
  const uint32_t bars = kv_s + 2 * kStages * Tl::kKBytes;
  const uint32_t q_bar = bars;
  auto full = [&](int st) { return bars + 8 * (1 + st); };
  auto empty = [&](int st) { return bars + 8 * (1 + kStages + st); };
  auto k_tile = [&](int st) { return kv_s + 2 * st * Tl::kKBytes; };
  auto v_tile = [&](int st) { return k_tile(st) + Tl::kKBytes; };

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heavy tiles first
  const int h = blockIdx.y, b = blockIdx.z, kh = h / G;
  int kb_lo = 0, kb_hi = (Sk + BK - 1) / BK - 1;     // key tiles that run
  if (causal) kb_hi = min(kb_hi, (q0 + BQ - 1) / BK);
  if (window > 0 && q0 - window + 1 > 0) kb_lo = (q0 - window + 1) / BK;
  const int n = max(0, kb_hi - kb_lo + 1);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    bar_init(q_bar, 1);
    for (int st = 0; st < kStages; ++st) {
      bar_init(full(st), 1);
      bar_init(empty(st), 8);                 // lane 0 of each consumer warp
    }
    bar_init_fence();
  }
  __syncthreads();

  if (warp >= 8) {          // producer warpgroup: its first thread copies
    regs_release<40>();
    if (warp == 8 && lane == 0) {
      bar_expect(q_bar, 2 * Tl::kQBytes);
      tma_tile<D>(q_s, &qmap, q_bar, BQ, q0, h, b);
      tma_tile<D>(do_s, &domap, q_bar, BQ, q0, h, b);
      for (int i = 0; i < n; ++i) {
        const int st = i % kStages;
        bar_wait(empty(st), ((i / kStages) & 1) ^ 1);
        const int k0 = (kb_lo + i) * BK;
        bar_expect(full(st), 2 * Tl::kKBytes);
        tma_tile<D>(k_tile(st), &kmap, full(st), BK, k0, kh, b);
        tma_tile<D>(v_tile(st), &vmap, full(st), BK, k0, kh, b);
      }
    }
  } else {                  // consumer warpgroups
    regs_claim<232>();

    // consumer warpgroup wg: rows q0 + 64 wg + [0, 64); this thread's rows
    // r0 and r0 + 8, key columns 8 j + c and + 1 of each n8 block
    const int wg = warp >> 2, wrow = q0 + 64 * wg;
    const int r0 = wrow + 16 * (warp & 3) + (lane >> 2), c = 2 * (lane & 3);
    const long long lrow = (static_cast<long long>(b) * H + h) * Sq;

    // delta = rowsum(dO o) of rows r0 and r0 + 8, each summed by the four
    // lanes of its quad over 16-byte chunks, before the loop; written for
    // the dkv kernel.  lse in log2 units.
    float dl[2], ls[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int row = r0 + 8 * rr;
      float sum = 0.f;
      if (row < Sq) {
        const __nv_bfloat16* op = o + b * so.b + h * so.h + row * so.s;
        const __nv_bfloat16* dop = dout + b * sdo.b + h * sdo.h + row * sdo.s;
        for (int col = 8 * (lane & 3); col < d; col += 32) {
          const uint4 ov = *reinterpret_cast<const uint4*>(op + col);
          const uint4 gv = *reinterpret_cast<const uint4*>(dop + col);
          const __nv_bfloat162* o2 =
              reinterpret_cast<const __nv_bfloat162*>(&ov);
          const __nv_bfloat162* g2 =
              reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 x = __bfloat1622float2(o2[e]);
            const float2 y = __bfloat1622float2(g2[e]);
            sum = fmaf(x.y, y.y, fmaf(x.x, y.x, sum));
          }
        }
      }
      dl[rr] = row_sum(sum);
      ls[rr] = row < Sq ? lse[lrow + row] * kLog2e : 0.f;
      if (row < Sq && (lane & 3) == 0) delta[lrow + row] = dl[rr];
    }

    const float scale_log2 = scale * kLog2e;
    float acc[L::kHalves][NO];
#pragma unroll
    for (int hh = 0; hh < L::kHalves; ++hh)
#pragma unroll
      for (int i = 0; i < NO; ++i) acc[hh][i] = 0.f;
    bar_wait(q_bar, 0);

    // Per key tile: S and dP as two product groups; P is computed while dP
    // still runs; then dq += dS K with dS rounded to bf16.
    for (int i = 0; i < n; ++i) {
      const int st = i % kStages;
      const int k0 = (kb_lo + i) * BK;
      bar_wait(full(st), (i / kStages) & 1);
      float s[BK / 2], dp[BK / 2];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss(s, desc_k<D>(q_s, BQ, 64 * wg, kk),
                 desc_k<D>(k_tile(st), BK, 0, kk), kk > 0);
      wg_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss(dp, desc_k<D>(do_s, BQ, 64 * wg, kk),
                 desc_k<D>(v_tile(st), BK, 0, kk), kk > 0);
      wg_commit();

      const bool masked = wrow + 63 >= Sq || k0 + BK > Sk ||
                          (causal && k0 + BK - 1 > wrow) ||
                          (window > 0 && k0 <= wrow + 63 - window);
      wg_wait<1>();
      pin(s);
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = r0 + 8 * (e >> 1);
          float p = ex2(s[4 * j + e] * scale_log2 - ls[e >> 1]);
          if (masked && !(row < Sq && visible(row, k0 + 8 * j + c + (e & 1),
                                              Sk, causal, window)))
            p = 0.f;
          s[4 * j + e] = p;
        }
      wg_wait<0>();
      pin(dp);
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[4 * j + e] = s[4 * j + e] * (dp[4 * j + e] - dl[e >> 1]);
      uint32_t da[BK / 16][4];
      to_a_frags<BK>(dp, da);
      pin(da);
#pragma unroll
      for (int hh = 0; hh < L::kHalves; ++hh) pin(acc[hh]);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int hh = 0; hh < L::kHalves; ++hh)
          wgmma_rs(acc[hh], da[kk], desc_mn<D>(k_tile(st), BK, hh, kk), 1);
      wg_commit();
      wg_wait<0>();
      pin(da);
#pragma unroll
      for (int hh = 0; hh < L::kHalves; ++hh) pin(acc[hh]);
      __syncwarp();
      if (lane == 0) bar_arrive(empty(st));
    }

#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int row = r0 + 8 * rr;
      if (row >= Sq) continue;
      __nv_bfloat16* dqp = dq + b * sdq.b + h * sdq.h + row * sdq.s;
#pragma unroll
      for (int hh = 0; hh < L::kHalves; ++hh)
#pragma unroll
        for (int j = 0; j < L::kW / 8; ++j) {
          if (hh * L::kW + 8 * j >= d) continue;
          const int e = 4 * j + 2 * rr;
          *reinterpret_cast<uint32_t*>(dqp + hh * L::kW + 8 * j + c) =
              pack_bf16(acc[hh][e] * scale, acc[hh][e + 1] * scale);
        }
    }
  }
}

// tensors = {q, k, v, o, dO, lse, dq, delta}; strides as in launch_dq
template <int D>
cudaError_t launch_dq_tc(const void* const* t, const long long* st, int B,
                         int H, int K, int Sq, int Sk, int d, int causal,
                         int window, float scale, cudaStream_t stream) {
  using Tl = DqTile<D>;
  CUtensorMap qm, km, vm, dom;
  if (!tile_map<D>(&qm, t[0], B, H, Sq, st, Tl::kBQ, d) ||
      !tile_map<D>(&km, t[1], B, K, Sk, st + 3, Tl::kBK, d) ||
      !tile_map<D>(&vm, t[2], B, K, Sk, st + 6, Tl::kBK, d) ||
      !tile_map<D>(&dom, t[4], B, H, Sq, st + 12, Tl::kBQ, d))
    return cudaErrorInvalidValue;
  auto kernel = fa_dq_wgmma_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Tl::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + Tl::kBQ - 1) / Tl::kBQ, H, B);
  kernel<<<grid, kTcThreads, Tl::kSmem, stream>>>(
      qm, km, vm, dom, static_cast<const __nv_bfloat16*>(t[3]),
      static_cast<const __nv_bfloat16*>(t[4]),
      static_cast<const float*>(t[5]),
      static_cast<__nv_bfloat16*>(const_cast<void*>(t[6])),
      static_cast<float*>(const_cast<void*>(t[7])), H, H / K, Sq, Sk, d,
      at(st, 3), at(st, 4), at(st, 5), causal, window, scale);
  return cudaGetLastError();
}

using Launch = cudaError_t (*)(const void* const*, const long long*, int, int,
                               int, int, int, int, int, int, float,
                               cudaStream_t);

// A head dim d runs on the next built width D (32, 64 or 128).
Launch pick_dq(int d, int dtype) {
  const int D = built_width(d);
  if (dtype == 0 && D == 32) return launch_dq<float, 32>;
  if (dtype == 0 && D == 64) return launch_dq<float, 64>;
  if (dtype == 0 && D == 128) return launch_dq<float, 128>;
  if (dtype == 1 && D == 32) return launch_dq_tc<32>;
  if (dtype == 1 && D == 64) return launch_dq_tc<64>;
  if (dtype == 1 && D == 128) return launch_dq_tc<128>;
  return nullptr;
}

Launch pick_dkv(int d, int dtype) {
  const int D = built_width(d);
  if (dtype == 0 && D == 32) return launch_dkv<float, 32>;
  if (dtype == 0 && D == 64) return launch_dkv<float, 64>;
  if (dtype == 0 && D == 128) return launch_dkv<float, 128>;
  if (dtype == 1 && D == 32) return launch_dkv_tc<32>;
  if (dtype == 1 && D == 64) return launch_dkv_tc<64>;
  if (dtype == 1 && D == 128) return launch_dkv_tc<128>;
  return nullptr;
}

int run(Launch fn, const void* const* t, const long long* st, int B, int H,
        int K, int Sq, int Sk, int d, int causal, int window, float scale,
        void* stream) {
  if (fn == nullptr || B <= 0 || K <= 0 || H % K != 0 || Sq <= 0 ||
      Sk <= 0 || H > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();  // the code returned below belongs to this call
  return static_cast<int>(fn(t, st, B, H, K, Sq, Sk, d, causal, window,
                             scale, static_cast<cudaStream_t>(stream)));
}

}  // namespace

// dq: tensors = {q, k, v, o, dO, lse, dq, delta}; strides: 18 int64
// element strides, (b, head, s) of q, k, v, o, dO and dq.  Writes dq and
// delta = rowsum(dO * O) (float32, (B, H, Sq), contiguous), which the dkv
// launch reads.  D: the head dim, any multiple of 8 up to 128.  dtype: 0 =
// float32 (fa_dq_kernel), 1 = bfloat16 (fa_dq_wgmma_kernel; strides
// multiples of 8 elements, bases 16-byte aligned).  Returns the launch's
// cudaError_t (0 on success); the Python wrapper checks shapes, dtypes,
// devices and alignment before the call and raises on a non-zero return.
extern "C" int repro_flash_attention_dq(const void* const* tensors,
                                        const long long* strides, int B,
                                        int H, int K, int Sq, int Sk, int D,
                                        int causal, int window, float scale,
                                        int dtype, void* stream) {
  return run(pick_dq(D, dtype), tensors, strides, B, H, K, Sq, Sk, D,
             causal, window, scale, stream);
}

// dkv: tensors = {q, k, v, dO, lse, delta, dk, dv}; strides: (b, head, s)
// of q, k, v, dO, dk and dv.  delta comes from the dq launch before it on
// the same stream.  dtype: 0 = float32 (fa_dkv_kernel), 1 = bfloat16
// (fa_dkv_wgmma_kernel; strides multiples of 8 elements, bases 16-byte
// aligned).
extern "C" int repro_flash_attention_dkv(const void* const* tensors,
                                         const long long* strides, int B,
                                         int H, int K, int Sq, int Sk, int D,
                                         int causal, int window, float scale,
                                         int dtype, void* stream) {
  return run(pick_dkv(D, dtype), tensors, strides, B, H, K, Sq, Sk, D,
             causal, window, scale, stream);
}
