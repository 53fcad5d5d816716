// Mamba-2 SSD chunked scan for Hopper (sm_90a), bound through a plain C
// entry.
//
// Replaces the Pallas TPU kernel `_ssd_kernel` in
// src/repro/kernels/ssd/ssd.py: the chunked state-space-duality scan of
// Mamba-2 (arXiv:2405.21060).  Per (batch row, head) and per chunk of L
// positions, with cum = the inclusive prefix sum of dt * A over the chunk
// and seg = cum[L-1]:
//
//   y_i   = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j     (diagonal)
//         + exp(cum_i) C_i . state^T                               (off-diag)
//   state = exp(seg) state + sum_j exp(seg - cum_j) dt_j x_j^T B_j
//
//   x     (B, S, H, P)  T, strided (p contiguous)
//   dt    (B, S, H)     float32, strided; after softplus, >= 0
//   A     (H,)          float32, negative
//   Bm, C (B, S, G, N)  T, strided (n contiguous); head h reads h / (H / G)
//   init  (B, H, P, N)  float32, contiguous, or null for zeros
//   y     (B, S, H, P)  T, contiguous
//   st    (B, H, P, N)  float32, contiguous: the state after position S-1
//
// Positions at or past S act as dt = 0 and x = B = C = 0 (exact: identity
// decay, no input) and their y is not written, so a ragged S needs no
// padded copy.  The decay is formed only where i >= j: for j > i the
// exponent is positive and could overflow to inf, and inf * 0 would be NaN
// where the reference's jnp.where gives 0.
//
// What bounds it on an H100: at the main prefill shape (B 8, S 2048, H 64,
// P 64, N 128, L 256, bf16) the visible work is 86 GFLOP (the lower
// triangles of the two L x L products and the two state products) and the
// least traffic 298 MB (x and y in bf16, B, C, dt, the float32 state),
// which take about the same time at 989 TFLOP/s and 3.35 TB/s.
//
// bf16: the standard chunk-parallel SSD split, four kernels on one stream,
// every product on wgmma (float32 accumulators), 128 threads (one
// warpgroup) a block:
//   ssd_cb_kernel     C B^T of each (64-row tile, chunk, B/C group, batch
//                     row), its lower triangle of 64 x 64 tiles, once for
//                     all the group's heads, to a float32 workspace;
//   ssd_state_kernel  per (chunk, head, batch row): cum and dt of the
//                     chunk to a workspace, and the chunk's own state
//                     X^T (w B), w = exp(seg - cum) dt, to a float32
//                     workspace, over 64-row slabs of the chunk;
//   ssd_pass_kernel   per (state element, head, batch row): the only
//                     serial part, S / L steps of state = exp(seg) state +
//                     chunk state, leaving in the workspace the state
//                     entering each chunk, and writing the final state;
//   ssd_scan_kernel   per (64-row tile, head, chunk, batch row), tiles and
//                     heads fastest so a chunk's C B^T stays in L2:
//                     exp(cum_i) C_i state^T, then + (C B^T o decay o dt) X
//                     over the key tiles up to the diagonal, each staged
//                     alone (59 KB of shared memory: three blocks an SM).
// The first three also rebuild the backward's inputs (repro_ssd_states;
// ssd_bwd.cu).  The bf16 staging helpers live in ssd_tc.cuh, shared with
// the backward.
// bf16 operands (x, B, C) enter the products as they are.  The float32
// ones (w B, the decayed scores, the state entering a chunk) are split
// into bf16 hi + lo and go through two products, so each term keeps about
// 16 bits of its weight (a relative error under 2^-16, against 2^-8 for
// one bf16 rounding): the float32 tolerances of y and the state hold for
// the bf16 path too.  Operand tiles are staged by 16-byte loads into the
// swizzled layout wgmma reads (hopper.cuh), zero past S, L, P and N; N 16
// runs on tiles 32 wide and P 32 on tiles 64 wide, the zero columns never
// stored.  Chunks of 32 run as 64-row tiles with rows past L zero.
//
// float32: ssd_kernel, the first version in float32 FMA on the CUDA cores
// (the float32 path is held to the reference's atol, which one bf16 hi +
// lo product does not promise for every input).  One block of 256 threads
// per (head, batch row) walks the chunks in order with the float32 (P, N)
// state in shared memory, in BT-row tiles (BT = 64, or 32 when L = 32) so
// that no L x L matrix is ever held: for query tile i the block stages
// C_i, adds the off-diagonal term from the state, then for each key tile
// j <= i stages B_j and x_j (transposed), forms the BT x BT scores in
// registers with the decay where i >= j, stages them and accumulates
// scores . x_j; the last query tile also accumulates the state update.
// Every product is a 16 x 16 thread grid of register tiles fed by 16-byte
// shared-memory reads (rows padded by 4 floats).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "ssd_common.cuh"
#include "ssd_tc.cuh"

namespace {

using namespace repro_ssd;

constexpr int kMaxChunk = 256;  // one scan element per thread

template <int BT, int P, int N>
constexpr int smem_floats(int L) {
  return P * (N + kPad) + 2 * BT * (N + kPad) + P * (BT + kPad) +
         BT * (BT + kPad) + 3 * L;
}

template <typename T, int BT, int P, int N>
__global__ void __launch_bounds__(kThreads)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ A, const T* __restrict__ Bm,
           const T* __restrict__ Cm, const float* __restrict__ init,
           T* __restrict__ y, float* __restrict__ st_out, Strides sx,
           Strides sdt, Strides sb, Strides sc, int S, int H, int G, int L) {
  constexpr int R = BT / 16;      // tile rows (and score columns) per thread
  constexpr int QP = P / 16;      // head-dim columns per thread
  constexpr int QN = N / 16;      // state columns per thread
  constexpr int LDN = N + kPad;   // row stride of the state, C and B tiles
  constexpr int LDT = BT + kPad;  // row stride of x^T and the score tile
  extern __shared__ float4 smem4[];
  float* st_s = reinterpret_cast<float*>(smem4);  // P x LDN
  float* c_s = st_s + P * LDN;                     // BT x LDN
  float* b_s = c_s + BT * LDN;                     // BT x LDN
  float* xt_s = b_s + BT * LDN;                    // P x LDT
  float* s_s = xt_s + P * LDT;                     // BT x LDT
  float* cum_s = s_s + BT * LDT;                   // L
  float* dt_s = cum_s + L;                         // L
  float* w_s = dt_s + L;                           // L: exp(seg - cum) dt
  __shared__ float warp_tot[kThreads / 32];

  const int h = blockIdx.x, b = blockIdx.y, g = h / (H / G);
  const int tid = threadIdx.x, rg = tid >> 4, cg = tid & 15;
  const int lane = tid & 31, warp = tid >> 5;
  const float a_h = A[h];
  const T* xp = x + b * sx.b + h * sx.h;
  const float* dtp = dt + b * sdt.b + h * sdt.h;
  const T* bp = Bm + b * sb.b + g * sb.h;
  const T* cp = Cm + b * sc.b + g * sc.h;
  const long long ys = static_cast<long long>(H) * P;
  T* yp = y + static_cast<long long>(b) * S * ys + h * P;
  const long long st_off = (static_cast<long long>(b) * H + h) * P * N;

  for (int e = tid; e < P * N; e += kThreads)
    st_s[(e / N) * LDN + e % N] = init != nullptr ? init[st_off + e] : 0.f;

  const int ntiles = L / BT;
  for (int c0 = 0; c0 < S; c0 += L) {
    // dt, and cum = inclusive prefix sum of dt * A: a shuffle scan per warp,
    // then each thread adds the totals of the warps before its own
    float d = 0.f;
    if (tid < L && c0 + tid < S) d = dtp[(c0 + tid) * sdt.s];
    float v = d * a_h;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += u;
    }
    __syncthreads();  // last chunk's readers of the shared tiles are done
    if (lane == 31) warp_tot[warp] = v;
    __syncthreads();
    for (int i = 0; i < warp; ++i) v += warp_tot[i];
    if (tid < L) {
      cum_s[tid] = v;
      dt_s[tid] = d;
    }
    __syncthreads();
    const float seg = cum_s[L - 1];
    if (tid < L) w_s[tid] = expf(seg - cum_s[tid]) * dt_s[tid];

    for (int qi = 0; qi < ntiles; ++qi) {
      const int r0 = c0 + qi * BT;
      const bool rows_live = r0 < S;        // uniform over the block
      const bool update = qi == ntiles - 1;  // visits every key tile
      if (!rows_live && !update) continue;

      float yacc[R][QP];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < QP; ++j) yacc[i][j] = 0.f;
      if (rows_live) {
        __syncthreads();  // last tile's readers of c_s are done
        load_rows<T, N>(c_s, LDN, cp, sc.s, r0, BT, S);
        __syncthreads();
        dot_tile<R, QP, N>(c_s, LDN, st_s, LDN, rg, cg, yacc);
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const float e = expf(cum_s[qi * BT + rg + 16 * i]);
#pragma unroll
          for (int j = 0; j < QP; ++j) yacc[i][j] *= e;
        }
      }
      float sacc[QP][QN];
      if (update) {
        const float es = expf(seg);
#pragma unroll
        for (int i = 0; i < QP; ++i)
#pragma unroll
          for (int j = 0; j < QN; ++j)
            sacc[i][j] = es * st_s[(rg + 16 * i) * LDN + cg + 16 * j];
      }

      for (int kj = 0; kj <= qi; ++kj) {
        const int k0 = c0 + kj * BT;
        if (k0 >= S) break;  // tiles past S add nothing
        __syncthreads();     // last key tile's readers are done
        load_rows<T, N>(b_s, LDN, bp, sb.s, k0, BT, S);
        load_rows_t<T, P>(xt_s, LDT, xp, sx.s, k0, BT, S);
        __syncthreads();
        if (rows_live) {
          float sc_r[R][R];
#pragma unroll
          for (int i = 0; i < R; ++i)
#pragma unroll
            for (int j = 0; j < R; ++j) sc_r[i][j] = 0.f;
          dot_tile<R, R, N>(c_s, LDN, b_s, LDN, rg, cg, sc_r);
#pragma unroll
          for (int i = 0; i < R; ++i) {
            const int rl = qi * BT + rg + 16 * i;
#pragma unroll
            for (int j = 0; j < R; ++j) {
              const int cl = kj * BT + cg + 16 * j;
              // the decay only where rl >= cl: never exp of a positive sum
              s_s[(rg + 16 * i) * LDT + cg + 16 * j] =
                  rl >= cl ? sc_r[i][j] * expf(cum_s[rl] - cum_s[cl]) *
                                 dt_s[cl]
                           : 0.f;
            }
          }
          __syncthreads();
          dot_tile<R, QP, BT>(s_s, LDT, xt_s, LDT, rg, cg, yacc);
        }
        if (update) {
#pragma unroll 4
          for (int k = 0; k < BT; k += 4) {
            const float4 w4 =
                *reinterpret_cast<const float4*>(w_s + kj * BT + k);
            float4 xv[QP];
#pragma unroll
            for (int i = 0; i < QP; ++i) {
              xv[i] = *reinterpret_cast<const float4*>(
                  xt_s + (rg + 16 * i) * LDT + k);
              xv[i].x *= w4.x;
              xv[i].y *= w4.y;
              xv[i].z *= w4.z;
              xv[i].w *= w4.w;
            }
#pragma unroll
            for (int j = 0; j < QN; ++j) {
              const float* bc = b_s + k * LDN + cg + 16 * j;
              const float b0 = bc[0], b1 = bc[LDN], b2 = bc[2 * LDN],
                          b3 = bc[3 * LDN];
#pragma unroll
              for (int i = 0; i < QP; ++i) {
                sacc[i][j] = fmaf(xv[i].x, b0, sacc[i][j]);
                sacc[i][j] = fmaf(xv[i].y, b1, sacc[i][j]);
                sacc[i][j] = fmaf(xv[i].z, b2, sacc[i][j]);
                sacc[i][j] = fmaf(xv[i].w, b3, sacc[i][j]);
              }
            }
          }
        }
      }

      if (rows_live) {
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const int s = r0 + rg + 16 * i;
          if (s < S)
#pragma unroll
            for (int j = 0; j < QP; ++j)
              store(yp + s * ys + cg + 16 * j, yacc[i][j]);
        }
      }
      if (update) {
        __syncthreads();  // every reader of the old state is done
#pragma unroll
        for (int i = 0; i < QP; ++i)
#pragma unroll
          for (int j = 0; j < QN; ++j)
            st_s[(rg + 16 * i) * LDN + cg + 16 * j] = sacc[i][j];
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < P * N; e += kThreads)
    st_out[st_off + e] = st_s[(e / N) * LDN + e % N];
}

template <typename T, int BT, int P, int N>
cudaError_t launch(const void* x, const void* dt, const void* A,
                   const void* Bm, const void* C, const void* init, void* y,
                   void* st, const long long* sd, int B, int S, int H, int G,
                   int L, cudaStream_t stream) {
  const int smem = smem_floats<BT, P, N>(L) * 4;
  auto kernel = ssd_kernel<T, BT, P, N>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(H, B), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(C), static_cast<const float*>(init),
      static_cast<T*>(y), static_cast<float*>(st),
      Strides{sd[0], sd[1], sd[2]}, Strides{sd[3], sd[4], sd[5]},
      Strides{sd[6], sd[7], sd[8]}, Strides{sd[9], sd[10], sd[11]}, S, H, G,
      L);
  return cudaGetLastError();
}

template <typename T, int BT>
cudaError_t launch_pn(int P, int N, const void* x, const void* dt,
                      const void* A, const void* Bm, const void* C,
                      const void* init, void* y, void* st,
                      const long long* sd, int B, int S, int H, int G, int L,
                      cudaStream_t s) {
  if (P == 64 && N == 128)
    return launch<T, BT, 64, 128>(x, dt, A, Bm, C, init, y, st, sd, B, S, H,
                                  G, L, s);
  if (P == 64 && N == 64)
    return launch<T, BT, 64, 64>(x, dt, A, Bm, C, init, y, st, sd, B, S, H,
                                 G, L, s);
  if (P == 64 && N == 32)
    return launch<T, BT, 64, 32>(x, dt, A, Bm, C, init, y, st, sd, B, S, H,
                                 G, L, s);
  if (P == 32 && N == 16)
    return launch<T, BT, 32, 16>(x, dt, A, Bm, C, init, y, st, sd, B, S, H,
                                 G, L, s);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_t(int P, int N, const void* x, const void* dt,
                     const void* A, const void* Bm, const void* C,
                     const void* init, void* y, void* st,
                     const long long* sd, int B, int S, int H, int G, int L,
                     cudaStream_t s) {
  if (L == 32)
    return launch_pn<T, 32>(P, N, x, dt, A, Bm, C, init, y, st, sd, B, S, H,
                            G, L, s);
  return launch_pn<T, 64>(P, N, x, dt, A, Bm, C, init, y, st, sd, B, S, H, G,
                          L, s);
}

// ------------------------------------- bf16: chunk-parallel, on wgmma
using namespace repro_ssd_tc;

// C B^T of chunk c, group g, batch row b: rows [64 i, 64 i + 64) against
// key tiles j <= i, to cb (B, nc, G, LT, LT) float32.  Grid (LT / 64,
// nc * G, B).
template <int NW>
__global__ void __launch_bounds__(kTcThreads)
ssd_cb_kernel(const bf16* __restrict__ Bm, const bf16* __restrict__ Cm,
              float* __restrict__ cb, Strides sb, Strides sc, Geo q) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t c_s = smem_u32(align1024(smem_raw));
  const uint32_t b_s = c_s + 64 * NW * 2;
  const int i = blockIdx.x, c = blockIdx.y / q.G, g = blockIdx.y % q.G;
  const int b = blockIdx.z, c0 = c * q.L, live = min(q.L, q.S - c0);
  stage<NW>(c_s, Cm + b * sc.b + g * sc.h + (c0 + 64 * i) * sc.s, sc.s, 64,
            live - 64 * i, q.N);
  stage<NW>(b_s, Bm + b * sb.b + g * sb.h + c0 * sb.s, sb.s, 64 * (i + 1),
            live, q.N);
  fence_async_smem();
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = 16 * warp + (lane >> 2), cc = 2 * (lane & 3);
  float* out = cb + (static_cast<long long>(b) * gridDim.y + blockIdx.y) *
                        q.LT * q.LT +
               static_cast<long long>(64 * i) * q.LT;
  for (int j = 0; j <= i; ++j) {
    float acc[32];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < NW / 16; ++kk)
      wgmma_ss(acc, desc_k<NW>(c_s, 64, 0, kk),
               desc_k<NW>(b_s, 64 * (i + 1), 64 * j, kk), kk > 0);
    wg_commit();
    wg_wait<0>();
    pin(acc);
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
        *reinterpret_cast<float2*>(out + (r + 8 * rr) * q.LT + 64 * j +
                                   8 * jj + cc) =
            make_float2(acc[4 * jj + 2 * rr], acc[4 * jj + 2 * rr + 1]);
  }
}

// Chunk c of head h, batch row b: cum and dt to cum_ws and dt_ws (B, H, nc,
// LT), and the chunk's state X^T (w B) to states (B, nc, H, P, N).  Grid
// (nc, H, B).
template <int NW>
__global__ void __launch_bounds__(kTcThreads)
ssd_state_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const bf16* __restrict__ Bm,
                 float* __restrict__ states, float* __restrict__ cum_ws,
                 float* __restrict__ dt_ws, Strides sx, Strides sdt,
                 Strides sb, Geo q) {
  using LN = Swz<NW>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  const uint32_t x_s = smem_u32(smem);             // 64 x 64, one slab
  const uint32_t whi = x_s + 64 * 64 * 2;          // 64 x NW
  const uint32_t wlo = whi + 64 * NW * 2;
  float* cum_s = reinterpret_cast<float*>(smem + 64 * 64 * 2 + 4 * 64 * NW);
  float* dt_s = cum_s + q.LT;
  float* w_s = dt_s + q.LT;
  __shared__ float warp_tot[kTcThreads / 32];

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (q.H / q.G), c0 = c * q.L, live = min(q.L, q.S - c0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // dt and cum = the inclusive prefix sum of dt * A: two positions a
  // thread, a shuffle scan per warp, then the totals of earlier warps
  const float a_h = A[h];
  const float* dtp = dt + b * sdt.b + h * sdt.h;
  const int l0 = 2 * tid;
  const float d0 = l0 < live ? dtp[(c0 + l0) * sdt.s] : 0.f;
  const float d1 = l0 + 1 < live ? dtp[(c0 + l0 + 1) * sdt.s] : 0.f;
  const float a0 = d0 * a_h, a1 = a0 + d1 * a_h;
  float v = a1;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += u;
  }
  if (lane == 31) warp_tot[warp] = v;
  __syncthreads();
  float base = v - a1;
  for (int w = 0; w < warp; ++w) base += warp_tot[w];
  if (l0 < q.LT) {
    cum_s[l0] = base + a0;
    dt_s[l0] = d0;
  }
  if (l0 + 1 < q.LT) {
    cum_s[l0 + 1] = base + a1;
    dt_s[l0 + 1] = d1;
  }
  __syncthreads();
  const float seg = cum_s[q.L - 1];
  const long long cd = (static_cast<long long>(b) * q.H + h) * q.nc * q.LT +
                       static_cast<long long>(c) * q.LT;
  for (int l = tid; l < q.LT; l += kTcThreads) {
    w_s[l] = l < q.L ? expf(seg - cum_s[l]) * dt_s[l] : 0.f;
    cum_ws[cd + l] = cum_s[l];
    dt_ws[cd + l] = dt_s[l];
  }
  __syncthreads();

  float acc[LN::kHalves][LN::kW / 2];
#pragma unroll
  for (int hh = 0; hh < LN::kHalves; ++hh)
#pragma unroll
    for (int e = 0; e < LN::kW / 2; ++e) acc[hh][e] = 0.f;
  const bf16* xp = x + b * sx.b + h * sx.h;
  const bf16* bp = Bm + b * sb.b + g * sb.h;
  for (int l64 = 0; l64 < live; l64 += 64) {        // uniform over the block
    stage<64>(x_s, xp + (c0 + l64) * sx.s, sx.s, 64, live - l64, q.P);
    stage_scaled_split<NW>(whi, wlo, bp + (c0 + l64) * sb.s, sb.s,
                           live - l64, q.N, w_s + l64);
    fence_async_smem();
    __syncthreads();
#pragma unroll
    for (int hh = 0; hh < LN::kHalves; ++hh) pin(acc[hh]);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int hh = 0; hh < LN::kHalves; ++hh) {
        wgmma_ss<1, 1>(acc[hh], desc_mn<64>(x_s, 64, 0, kk),
                       desc_mn<NW>(whi, 64, hh, kk), 1);
        wgmma_ss<1, 1>(acc[hh], desc_mn<64>(x_s, 64, 0, kk),
                       desc_mn<NW>(wlo, 64, hh, kk), 1);
      }
    wg_commit();
    wg_wait<0>();
#pragma unroll
    for (int hh = 0; hh < LN::kHalves; ++hh) pin(acc[hh]);
    __syncthreads();                     // the slab's readers are done
  }

  // acc: rows p, columns n of the chunk's state
  const int r = 16 * warp + (lane >> 2), cc = 2 * (lane & 3);
  float* sp = states + ((static_cast<long long>(b) * q.nc + c) * q.H + h) *
                          q.P * q.N;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int p = r + 8 * rr;
    if (p >= q.P) continue;
#pragma unroll
    for (int hh = 0; hh < LN::kHalves; ++hh)
#pragma unroll
      for (int jj = 0; jj < LN::kW / 8; ++jj) {
        const int n = hh * LN::kW + 8 * jj + cc;
        if (n < q.N)
          *reinterpret_cast<float2*>(sp + p * q.N + n) =
              make_float2(acc[hh][4 * jj + 2 * rr],
                          acc[hh][4 * jj + 2 * rr + 1]);
      }
  }
}

// The state passing: for each chunk, replace its own state by the state
// entering it, then step; write the final state.  Grid (ceil(P N / 256), H,
// B), 256 threads, one state element each.  The loads of eight chunks are
// issued together, ahead of the serial chain of updates.
__global__ void __launch_bounds__(256)
ssd_pass_kernel(float* __restrict__ states, const float* __restrict__ cum_ws,
                const float* __restrict__ init, float* __restrict__ st_out,
                Geo q) {
  constexpr int kAhead = 8;
  const int h = blockIdx.y, b = blockIdx.z;
  const int e = blockIdx.x * 256 + threadIdx.x, pn = q.P * q.N;
  if (e >= pn) return;
  const long long bh = static_cast<long long>(b) * q.H + h;
  auto at = [&](int c) {
    return states + ((static_cast<long long>(b) * q.nc + c) * q.H + h) * pn +
           e;
  };
  float st = init != nullptr ? init[bh * pn + e] : 0.f;
  for (int c0 = 0; c0 < q.nc; c0 += kAhead) {
    float own[kAhead], seg[kAhead];
#pragma unroll
    for (int k = 0; k < kAhead; ++k)
      if (c0 + k < q.nc) {
        own[k] = *at(c0 + k);
        seg[k] = cum_ws[(bh * q.nc + c0 + k) * q.LT + q.L - 1];
      }
#pragma unroll
    for (int k = 0; k < kAhead; ++k)
      if (c0 + k < q.nc) {
        *at(c0 + k) = st;
        st = expf(seg[k]) * st + own[k];
      }
  }
  st_out[bh * pn + e] = st;
}

// y of rows [64 i, 64 i + 64) of chunk c, head h, batch row b: exp(cum_i)
// C_i state^T, then + (C B^T o decay o dt) X over key tiles j <= i, one
// 64-row tile of X staged at a time.  Grid (LT / 64, H, nc B): the row
// tiles and heads of one chunk run together, so its C B^T stays in L2.
template <int NW>
__global__ void __launch_bounds__(kTcThreads)
ssd_scan_kernel(const bf16* __restrict__ x, const bf16* __restrict__ Cm,
                const float* __restrict__ cb,
                const float* __restrict__ states,
                const float* __restrict__ cum_ws,
                const float* __restrict__ dt_ws, bf16* __restrict__ y,
                Strides sx, Strides sc, Geo q) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  const uint32_t phi = smem_u32(smem);             // 64 x NW: state hi
  const uint32_t plo = phi + 64 * NW * 2;          //          state lo
  const uint32_t c_s = plo + 64 * NW * 2;          // 64 x NW: C_i
  const uint32_t x_s = c_s + 64 * NW * 2;          // 64 x 64: X_j
  float* cum_s = reinterpret_cast<float*>(smem + 3 * 64 * NW * 2 +
                                          64 * 64 * 2);
  float* dt_s = cum_s + q.LT;

  const int i = blockIdx.x, h = blockIdx.y;
  const int c = blockIdx.z % q.nc, b = blockIdx.z / q.nc;
  const int g = h / (q.H / q.G), c0 = c * q.L, live = min(q.L, q.S - c0);
  if (64 * i >= live) return;                      // uniform over the block
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long cd = (static_cast<long long>(b) * q.H + h) * q.nc * q.LT +
                       static_cast<long long>(c) * q.LT;
  for (int l = tid; l < 64 * (i + 1); l += kTcThreads) {
    cum_s[l] = cum_ws[cd + l];
    dt_s[l] = dt_ws[cd + l];
  }
  stage_split_f32<NW>(phi, plo,
                      states + ((static_cast<long long>(b) * q.nc + c) *
                                    q.H + h) * q.P * q.N,
                      q.P, q.N);
  stage<NW>(c_s, Cm + b * sc.b + g * sc.h + (c0 + 64 * i) * sc.s, sc.s, 64,
            live - 64 * i, q.N);
  fence_async_smem();
  __syncthreads();

  float acc[32];
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < NW / 16; ++kk)
    wgmma_ss(acc, desc_k<NW>(c_s, 64, 0, kk), desc_k<NW>(phi, 64, 0, kk),
             kk > 0);
#pragma unroll
  for (int kk = 0; kk < NW / 16; ++kk)
    wgmma_ss(acc, desc_k<NW>(c_s, 64, 0, kk), desc_k<NW>(plo, 64, 0, kk), 1);
  wg_commit();

  const float* cbp = cb + ((static_cast<long long>(b) * q.nc + c) * q.G + g) *
                              q.LT * q.LT;
  const int r = 16 * warp + (lane >> 2), cc = 2 * (lane & 3);
  const int row0 = 64 * i + r;           // this thread's rows: row0, + 8
  // A fragments outlive each product: pinned after its wait, so the
  // compiler never reuses their registers while the tensor cores read them
  uint32_t ahi[4][4] = {}, alo[4][4] = {};
  for (int j = 0; j <= i; ++j) {
    // the decayed scores of key tile j, from C B^T in L2, while the last
    // product still runs
    float sc_f[32];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int row = row0 + 8 * rr, col = 64 * j + 8 * jj + cc;
        const float2 v =
            *reinterpret_cast<const float2*>(cbp + row * q.LT + col);
        // the decay only where row >= col: never exp of a positive sum
        sc_f[4 * jj + 2 * rr] =
            row >= col ? v.x * expf(cum_s[row] - cum_s[col]) * dt_s[col]
                       : 0.f;
        sc_f[4 * jj + 2 * rr + 1] =
            row >= col + 1
                ? v.y * expf(cum_s[row] - cum_s[col + 1]) * dt_s[col + 1]
                : 0.f;
      }
    wg_wait<0>();
    pin(acc);
    pin(ahi);
    pin(alo);
    if (j == 0) {                        // the off-diagonal term's decay
      const float e0 = expf(cum_s[row0]), e1 = expf(cum_s[row0 + 8]);
#pragma unroll
      for (int k = 0; k < 32; ++k) acc[k] *= (k & 2) ? e1 : e0;
    }
    to_a_frags2<64>(sc_f, ahi, alo);
    __syncthreads();                     // the last X_j's readers are done
    stage<64>(x_s, x + b * sx.b + h * sx.h + (c0 + 64 * j) * sx.s, sx.s, 64,
              live - 64 * j, q.P);
    fence_async_smem();
    __syncthreads();
    pin(ahi);
    pin(alo);
    pin(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs(acc, ahi[kk], desc_mn<64>(x_s, 64, 0, kk), 1);
      wgmma_rs(acc, alo[kk], desc_mn<64>(x_s, 64, 0, kk), 1);
    }
    wg_commit();
  }
  wg_wait<0>();
  pin(acc);
  pin(ahi);
  pin(alo);

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = row0 + 8 * rr;
    if (row >= live) continue;
    bf16* yp =
        y + ((static_cast<long long>(b) * q.S + c0 + row) * q.H + h) * q.P;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
      if (8 * jj < q.P)
        *reinterpret_cast<uint32_t*>(yp + 8 * jj + cc) =
            pack_bf16(acc[4 * jj + 2 * rr], acc[4 * jj + 2 * rr + 1]);
  }
}

// ws = {cb, states, cum, dt}: float32 workspaces of B nc G LT^2, B nc H P
// N, B H nc LT and B H nc LT elements.  With y null, the first three
// kernels alone (the backward's rebuild of C B^T, cum, dt and the states).
template <int NW>
cudaError_t launch_tc(const void* x, const void* dt, const void* A,
                      const void* Bm, const void* C, const void* init,
                      void* y, void* st, void* const* ws,
                      const long long* sd, Geo q, int B,
                      cudaStream_t stream) {
  const Strides sx{sd[0], sd[1], sd[2]}, sdt{sd[3], sd[4], sd[5]},
      sb{sd[6], sd[7], sd[8]}, sc{sd[9], sd[10], sd[11]};
  float* cb = static_cast<float*>(ws[0]);
  float* states = static_cast<float*>(ws[1]);
  float* cum = static_cast<float*>(ws[2]);
  float* dtw = static_cast<float*>(ws[3]);
  const int smem_cb = (64 + q.LT) * NW * 2 + 1024;
  const int smem_state = 64 * 64 * 2 + 2 * 64 * NW * 2 + 3 * q.LT * 4 + 1024;
  const int smem_scan = 3 * 64 * NW * 2 + 64 * 64 * 2 + 2 * q.LT * 4 + 1024;
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(ssd_cb_kernel<NW>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  smem_cb)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(ssd_state_kernel<NW>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  smem_state)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(ssd_scan_kernel<NW>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  smem_scan)) != cudaSuccess)
    return err;
  ssd_cb_kernel<NW><<<dim3(q.LT / 64, q.nc * q.G, B), kTcThreads, smem_cb,
                      stream>>>(static_cast<const bf16*>(Bm),
                                static_cast<const bf16*>(C), cb, sb, sc, q);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_state_kernel<NW><<<dim3(q.nc, q.H, B), kTcThreads, smem_state,
                         stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const bf16*>(Bm), states,
      cum, dtw, sx, sdt, sb, q);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_pass_kernel<<<dim3((q.P * q.N + 255) / 256, q.H, B), 256, 0,
                    stream>>>(states, cum, static_cast<const float*>(init),
                              static_cast<float*>(st), q);
  if ((err = cudaGetLastError()) != cudaSuccess || y == nullptr) return err;
  ssd_scan_kernel<NW><<<dim3(q.LT / 64, q.H, q.nc * B), kTcThreads,
                        smem_scan, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(C), cb, states,
      cum, dtw, static_cast<bf16*>(y), sx, sc, q);
  return cudaGetLastError();
}

int run_tc(const void* x, const void* dt, const void* A, const void* Bm,
           const void* C, const void* init, void* y, void* st,
           void* const* ws, const long long* strides, int B, int S, int H,
           int G, int P, int N, int L, cudaStream_t s) {
  const bool shape = (P == 64 && (N == 128 || N == 64 || N == 32)) ||
                     (P == 32 && N == 16);
  if (!shape || ws == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int nc = (S + L - 1) / L;
  if (static_cast<long long>(nc) * B > 65535 ||
      static_cast<long long>(nc) * G > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Geo q{S, H, G, P, N, L, (L + 63) / 64 * 64, nc};
  if (N <= 32)
    return static_cast<int>(
        launch_tc<32>(x, dt, A, Bm, C, init, y, st, ws, strides, q, B, s));
  if (N <= 64)
    return static_cast<int>(
        launch_tc<64>(x, dt, A, Bm, C, init, y, st, ws, strides, q, B, s));
  return static_cast<int>(
      launch_tc<128>(x, dt, A, Bm, C, init, y, st, ws, strides, q, B, s));
}

}  // namespace

// strides: 12 int64 element strides, (b, s, head) of x and dt and
// (b, s, group) of Bm and C, in that order.  init may be null (zeros).
// (P, N) is one of (64, 128), (64, 64), (64, 32), (32, 16); L one of 32,
// 64, 128, 256.  dtype: 0 = float32 (ssd_kernel; ws unused), 1 = bfloat16
// (x, Bm, C and y; the four tensor-core kernels, with ws = {cb, states,
// cum, dt}, float32 workspaces of B nc G LT^2, B nc H P N, B H nc LT and
// B H nc LT elements, nc = ceil(S / L), LT = L rounded up to 64; x, Bm
// and C with 16-byte aligned bases and strides).  Returns the launches'
// cudaError_t (0 on success); the Python wrapper checks shapes, dtypes and
// devices before the call and raises on a non-zero return.
extern "C" int repro_ssd_scan(const void* x, const void* dt, const void* A,
                              const void* Bm, const void* C,
                              const void* init, void* y, void* st,
                              void* const* ws, const long long* strides,
                              int B, int S, int H, int G, int P, int N,
                              int L, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G != 0 || B > 65535 ||
      (L != 32 && L != 64 && L != 128 && L != kMaxChunk))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();  // the code returned below belongs to this call
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(launch_t<float>(P, N, x, dt, A, Bm, C, init, y,
                                            st, strides, B, S, H, G, L, s));
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  return run_tc(x, dt, A, Bm, C, init, y, st, ws, strides, B, S, H, G, P, N,
                L, s);
}

// The bf16 path's first three kernels (ssd_cb_kernel, ssd_state_kernel,
// ssd_pass_kernel) alone, for the backward (ssd_bwd.cu): ws as above ends
// with C B^T, the state entering each chunk, cum and dt; st gets the final
// state.  Arguments as repro_ssd_scan's, bf16 only.
extern "C" int repro_ssd_states(const void* x, const void* dt,
                                const void* A, const void* Bm, const void* C,
                                const void* init, void* st, void* const* ws,
                                const long long* strides, int B, int S,
                                int H, int G, int P, int N, int L,
                                void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G != 0 || B > 65535 ||
      (L != 32 && L != 64 && L != 128 && L != kMaxChunk))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();  // the code returned below belongs to this call
  return run_tc(x, dt, A, Bm, C, init, nullptr, st, ws, strides, B, S, H, G,
                P, N, L, static_cast<cudaStream_t>(stream));
}
