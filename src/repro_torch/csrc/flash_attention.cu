// Flash-attention forward for Hopper (sm_90a), bound through a plain C entry.
//
// Replaces the Pallas TPU kernel `_fa_kernel` in
// src/repro/kernels/flash_attention/flash_attention.py: blockwise
// online-softmax attention that never writes the score matrix to device
// memory, with an optional log-sum-exp output for the backward pass.
//
//   q    (B, H, Sq, d)   T, strided (see flash_common.cuh)
//   k, v (B, K, Sk, d)   T, strided; query head h reads KV head h / (H / K)
//   o    (B, H, Sq, d)   T, strided
//   lse  (B, H, Sq)      float32, contiguous (may be null)
//
// Any head dim d <= 128 that is a multiple of 8 runs on the next built
// width D (32, 64 or 128): the bf16 kernel's tensor maps give the columns
// past d as zeros, the float32 kernel stages zeros there, and neither
// stores them.
//
// Masking follows the reference: keys past Sk, after the query (causal) or
// `window` or more behind it are replaced by -1e30 before the softmax, and
// tile pairs that are masked by position alone are skipped.  Scores,
// softmax state and the output accumulator are float32 for both input
// types; a row whose running sum is 0 divides by 1, as the reference does.
//
// What bounds it on an H100: its arithmetic, 4 * D flops per visible
// (query, key) pair (38.7 GFLOP for the causal main shape B 8, H 9, S 2048,
// D 64), over the tensor cores' 989 TFLOP/s in bf16; the bytes (q, k, v, o
// once each) are far below that line.  Two kernels, chosen by dtype:
//
// fa_fwd_wgmma_kernel (bf16).  One block per (query tile of 128 rows,
// query head, batch row), the heaviest causal tiles of each (head, batch
// row) launched first, of 384 threads: two consumer warpgroups of 64 rows
// and a producer warpgroup that gives most of its registers to them
// (setmaxnreg) and whose first thread issues the copies.  It loads the q
// tile once and streams K and V tiles through a two-stage ring in shared
// memory by TMA (bf16, swizzled as wgmma reads them, zero rows past Sk),
// paced by mbarriers.  Each consumer computes S = q K^T with wgmma
// (float32 accumulator), runs the online softmax on the accumulator
// fragment in registers (a row's max and sum over the four lanes of a
// quad, exp2 on the multi-function unit), masks only the tiles that
// straddle the diagonal, the window edge or Sk, rounds P to bf16 in
// registers as the A operand of O += P V (V read MN-major) and rescales O
// by alpha.  The two consumers overlap each other's softmax and products;
// within one, the steps run in order (a software-pipelined version that
// overlapped tile i's softmax with tile i - 1's P V ran slower).  Shared
// memory: 80 KB at D 64 (key tiles of 128), 96 KB at D 128 (key tiles of
// 64, to keep S and O in registers), 40 KB at D 32; one block per SM.
//
// fa_fwd_kernel (float32).  The first version, float32 FMA on the CUDA
// cores: a float32 input is held to atol 2e-5, which TF32 products
// cannot meet.  One block per (q tile of 64 rows, query head, batch row)
// stages its q tile once, then each K and V tile as float in shared
// memory; each thread scores 16 keys of its row, the row's four threads
// reduce max and sum with shuffles, P goes through shared memory, and
// each thread accumulates D / 4 output columns in registers.
#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using namespace repro_fa;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
fa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o,
              float* __restrict__ lse, int H, int G, int Sq, int Sk, int d,
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

  load_tile<T, D>(q_s, qp, sq.s, q0, Sq, d);

  float m = kNegInf, l = 0.f;
  float acc[4 * kOut];
#pragma unroll
  for (int i = 0; i < 4 * kOut; ++i) acc[i] = 0.f;

  const int nk = (Sk + kBK - 1) / kBK;
  for (int kb = 0; kb < nk; ++kb) {
    const int k0 = kb * kBK;
    if (!tile_runs(q0, k0, causal, window)) continue;
    __syncthreads();                       // last tile's readers are done
    load_tile<T, D>(k_s, kp, sk.s, k0, Sk, d);
    load_tile<T, D>(v_s, vp, sv.s, k0, Sk, d);
    __syncthreads();

    float s[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) s[j] = 0.f;
#pragma unroll 4
    for (int dd = 0; dd < D; dd += 4) {
      const float4 qv = *reinterpret_cast<const float4*>(q_s + r * LD + dd);
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        s[j] = dot4(qv, *reinterpret_cast<const float4*>(
                            k_s + (sub + 4 * j) * LD + dd), s[j]);
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
      if (16 * i + 4 * sub < d)
        store4(op + 16 * i + 4 * sub,
             make_float4(acc[4 * i] * inv, acc[4 * i + 1] * inv,
                         acc[4 * i + 2] * inv, acc[4 * i + 3] * inv));
    if (lse != nullptr && sub == 0)
      lse[(static_cast<long long>(b) * H + h) * Sq + qpos] = m + logf(ll);
  }
}

// ------------------------------------------------ bf16: wgmma fed by TMA
using namespace repro_tc;

constexpr int kTcThreads = 3 * 128;  // two consumer warpgroups, a producer one
constexpr int kStages = 2;                // K/V ring depth
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int D>
struct FwdTile {
  static constexpr int kBQ = 128;
  static constexpr int kBK = D == 128 ? 64 : 128;
  static constexpr int kQBytes = kBQ * D * 2;
  static constexpr int kKBytes = kBK * D * 2;
  static constexpr int kBars = 1 + 2 * kStages;  // q, full[], empty[]
  static constexpr int kSmem = kQBytes + 2 * kStages * kKBytes + 8 * kBars +
                               1024;              // + alignment slack
};

template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
fa_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                    int H, int G, int Sq, int Sk, int d, Strides so, int causal,
                    int window, float scale_log2) {
  using L = Swz<D>;
  using Tl = FwdTile<D>;
  constexpr int BQ = Tl::kBQ, BK = Tl::kBK, NO = L::kW / 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  const uint32_t q_s = smem_u32(smem);
  const uint32_t kv_s = q_s + Tl::kQBytes;          // stage st: K, then V
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
    if (warp == 8) {
      if (lane == 0) {
        bar_expect(q_bar, Tl::kQBytes);
        tma_tile<D>(q_s, &qmap, q_bar, BQ, q0, h, b);
        for (int i = 0; i < n; ++i) {
          const int st = i % kStages;
          bar_wait(empty(st), ((i / kStages) & 1) ^ 1);
          const int k0 = (kb_lo + i) * BK;
          bar_expect(full(st), 2 * Tl::kKBytes);
          tma_tile<D>(k_tile(st), &kmap, full(st), BK, k0, kh, b);
          tma_tile<D>(v_tile(st), &vmap, full(st), BK, k0, kh, b);
        }
      }
    }
  } else {                  // consumer warpgroups
    regs_claim<232>();

    // consumer warpgroup wg: rows q0 + 64 wg + [0, 64); this thread's rows
    // r0 and r0 + 8, columns 8 j + c and + 1 of each n8 block
    const int wg = warp >> 2, wrow = q0 + 64 * wg;
    const int r0 = wrow + 16 * (warp & 3) + (lane >> 2), c = 2 * (lane & 3);
    float acc[L::kHalves][NO];
#pragma unroll
    for (int hh = 0; hh < L::kHalves; ++hh)
#pragma unroll
      for (int i = 0; i < NO; ++i) acc[hh][i] = 0.f;
    // running max (log2 units) and this lane's part of the running sum
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    bar_wait(q_bar, 0);

    for (int i = 0; i < n; ++i) {
      const int st = i % kStages;
      const int k0 = (kb_lo + i) * BK;
      bar_wait(full(st), (i / kStages) & 1);
      float s[BK / 2];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss(s, desc_k<D>(q_s, BQ, 64 * wg, kk),
                 desc_k<D>(k_tile(st), BK, 0, kk), kk > 0);
      wg_commit();
      wg_wait<0>();
      pin(s);

      const bool masked = k0 + BK > Sk || (causal && k0 + BK - 1 > wrow) ||
                          (window > 0 && k0 <= wrow + 63 - window);
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[4 * j + e] * scale_log2;
          if (masked && !visible(r0 + 8 * (e >> 1), k0 + 8 * j + c + (e & 1),
                                 Sk, causal, window))
            x = kNegInf;
          s[4 * j + e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float alpha[2];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        mx[rr] = row_max(mx[rr]);
        alpha[rr] = ex2(m[rr] - mx[rr]);
        m[rr] = mx[rr];
        l[rr] *= alpha[rr];
      }
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = ex2(s[4 * j + e] - m[e >> 1]);
          l[e >> 1] += p;
          s[4 * j + e] = p;
        }
#pragma unroll
      for (int hh = 0; hh < L::kHalves; ++hh)
#pragma unroll
        for (int i2 = 0; i2 < NO; ++i2) acc[hh][i2] *= alpha[(i2 >> 1) & 1];
      uint32_t pa[BK / 16][4];
      to_a_frags<BK>(s, pa);
      pin(pa);
#pragma unroll
      for (int hh = 0; hh < L::kHalves; ++hh) pin(acc[hh]);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int hh = 0; hh < L::kHalves; ++hh)
          wgmma_rs(acc[hh], pa[kk], desc_mn<D>(v_tile(st), BK, hh, kk), 1);
      wg_commit();
      wg_wait<0>();
#pragma unroll
      for (int hh = 0; hh < L::kHalves; ++hh) pin(acc[hh]);
      __syncwarp();
      if (lane == 0) bar_arrive(empty(st));
    }

#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int row = r0 + 8 * rr;
      const float ll = row_sum(l[rr]);
      const float den = ll == 0.f ? 1.f : ll;
      const float inv = 1.f / den;
      if (row < Sq) {
        __nv_bfloat16* op = o + b * so.b + h * so.h + row * so.s;
#pragma unroll
        for (int hh = 0; hh < L::kHalves; ++hh)
#pragma unroll
          for (int j = 0; j < L::kW / 8; ++j)
            if (hh * L::kW + 8 * j < d)
              *reinterpret_cast<uint32_t*>(op + hh * L::kW + 8 * j + c) =
                pack_bf16(acc[hh][4 * j + 2 * rr] * inv,
                          acc[hh][4 * j + 2 * rr + 1] * inv);
        if (lse != nullptr && (lane & 3) == 0)
          lse[(static_cast<long long>(b) * H + h) * Sq + row] =
              m[rr] * kLn2 + logf(den);
      }
    }
  }
}

template <int D>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o,
                      void* lse, const long long* st, int B, int H, int K,
                      int Sq, int Sk, int d, int causal, int window,
                      float scale, cudaStream_t stream) {
  using Tl = FwdTile<D>;
  CUtensorMap qm, km, vm;
  if (!tile_map<D>(&qm, q, B, H, Sq, st, Tl::kBQ, d) ||
      !tile_map<D>(&km, k, B, K, Sk, st + 3, Tl::kBK, d) ||
      !tile_map<D>(&vm, v, B, K, Sk, st + 6, Tl::kBK, d))
    return cudaErrorInvalidValue;
  auto kernel = fa_fwd_wgmma_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Tl::kSmem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + Tl::kBQ - 1) / Tl::kBQ, H, B);
  kernel<<<grid, kTcThreads, Tl::kSmem, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse),
      H, H / K, Sq, Sk, d, Strides{st[9], st[10], st[11]}, causal, window,
      scale * kLog2e);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, const long long* st, int B, int H, int K,
                   int Sq, int Sk, int d, int causal, int window, float scale,
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
      static_cast<float*>(lse), H, H / K, Sq, Sk, d,
      Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
      Strides{st[6], st[7], st[8]}, Strides{st[9], st[10], st[11]}, causal,
      window, scale);
  return cudaGetLastError();
}

// d runs on the next built width D (32, 64 or 128) with zero columns.
cudaError_t launch_d(int d, int dtype, const void* q, const void* k,
                     const void* v, void* o, void* lse, const long long* st,
                     int B, int H, int K, int Sq, int Sk, int causal,
                     int window, float scale, cudaStream_t stream) {
#define REPRO_FWD_ARGS q, k, v, o, lse, st, B, H, K, Sq, Sk, d, causal, \
                       window, scale, stream
  const int D = built_width(d);
  if (dtype == 0 && D == 32) return launch<float, 32>(REPRO_FWD_ARGS);
  if (dtype == 0 && D == 64) return launch<float, 64>(REPRO_FWD_ARGS);
  if (dtype == 0 && D == 128) return launch<float, 128>(REPRO_FWD_ARGS);
  if (dtype == 1 && D == 32) return launch_tc<32>(REPRO_FWD_ARGS);
  if (dtype == 1 && D == 64) return launch_tc<64>(REPRO_FWD_ARGS);
  if (dtype == 1 && D == 128) return launch_tc<128>(REPRO_FWD_ARGS);
#undef REPRO_FWD_ARGS
  return cudaErrorInvalidValue;
}

}  // namespace

// strides: 12 int64 element strides, (b, head, s) of q, k, v and o in that
// order.  D: the head dim, any multiple of 8 up to 128.  dtype: 0 = float32 (fa_fwd_kernel), 1 = bfloat16
// (fa_fwd_wgmma_kernel, which also needs every stride a multiple of 8
// elements and 16-byte aligned bases for its tensor maps).  lse may be
// null.  Returns the launch's cudaError_t (0 on success); the Python
// wrapper checks shapes, dtypes, devices and alignment before the call and
// raises on a non-zero return.
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
  return static_cast<int>(launch_d(D, dtype, q, k, v, o, lse, strides, B, H,
                                   K, Sq, Sk, causal, window, scale,
                                   static_cast<cudaStream_t>(stream)));
}
