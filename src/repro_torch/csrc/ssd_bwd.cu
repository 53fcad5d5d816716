// Backward of the Mamba-2 SSD chunked scan for Hopper (sm_90a), bound
// through a plain C entry.
//
// No Pallas kernel has this job: the JAX package trains mamba models by
// differentiating its jnp scan (jax.grad of src/repro/models/ssm.py
// ssd_chunked).  On the card the forward runs ssd.cu's kernels, and this
// kernel is its gradient, held to the plain chunked backward
// (kernels/ssd/ref.py ssd_chunked_bwd), which the CPU tests hold to
// jax.grad.  Per chunk of L positions, with cum the inclusive prefix sum of
// dt A, seg = cum[L-1], decay[t,s] = exp(cum_t - cum_s) for s <= t (formed
// only there: above the diagonal the exponent is positive and could
// overflow, and inf * 0 would be NaN), h_in the state entering the chunk
// and dh the gradient of the state leaving it:
//
//   g_s    = sum_{t>=s} (C_t . B_s) decay[t,s] dy_t + exp(seg - cum_s) dh B_s
//   dx_s   = dt_s g_s
//   dB_s   = dt_s [sum_{t>=s} decay[t,s] (x_s . dy_t) C_t
//                  + exp(seg - cum_s) x_s dh]
//   dC_t   = sum_{s<=t} decay[t,s] dt_s (dy_t . x_s) B_s + exp(cum_t) dy_t h_in
//   dh_in  = exp(seg) dh + sum_t exp(cum_t) dy_t (x) C_t
//   dcum_t = dy_t . y_t - dt_t x_t . g_t  (+ <dh, h_out> at t = L - 1)
//   ddt_u  = x_u . g_u + A sum_{t>=u} dcum_t;  dA = sum_u dt_u sum_{t>=u} dcum_t
//
// with y recomputed in float32 (the forward's stored y is bf16 on the main
// path, and its rounding would enter ddt and dA).
//
//   x, dy (B, S, H, P)   T, strided (p contiguous)
//   dt    (B, S, H)      float32, strided
//   A     (H,)           float32
//   Bm, C (B, S, G, N)   T, strided (n contiguous); head h reads h / (H / G)
//   init, dfinal (B, H, P, N) float32, contiguous, or null for zeros
//   dx    (B, S, H, P)   T, contiguous
//   ddt   (B, S, H)      float32, contiguous
//   dA_part (B, H), dB_part, dC_part (B, S, H, N): float32 per-head
//         partials, contiguous; the wrapper sums dA over the batch and dB,
//         dC over the heads of each group
//   dinit (B, H, P, N)   float32, contiguous
//   hin   (B, nc, H, P, N) float32 workspace: the state entering each chunk
//
// Design: one block of 256 threads per (head, batch row), in float32 FMA on
// the CUDA cores (the forward's float32 ssd_kernel's building blocks,
// ssd_common.cuh).  A forward walk over the chunks recomputes the state
// entering each one into the workspace and ends on the final state; a
// reverse walk carries dh (P x N float32) in shared memory.  Per chunk, a
// loop over key tiles s (with the query tiles t >= s inside) gives g, dx,
// dB and x . g; a loop over query tiles t (with s <= t inside) gives y,
// dC, dy . y and the dy (x) C sum of dh_in; then a suffix scan of dcum gives
// ddt and the block's share of dA.  The per-head partials of dB and dC (no
// atomics) keep the result the same bits from run to run; at mamba2's
// shape they are 268 MB each for a batch of 4, transient.  Positions at or
// past S read as dt = 0 and x = B = C = dy = 0, and nothing is written
// there.
//
// What bounds it on an H100: operations.  Per chunk and head, the two
// loops form the lower triangles of C B^T and dy x^T twice each and three
// products with them (about 2 L^2 (N + P) multiply-adds), plus five
// L x P x N products: at mamba2's training shape (B 4, S 2048, H 64, P 64,
// N 128, L 256) about 150 GFLOP, on the CUDA cores' 67 TFLOP/s float32.
// Moving the products to wgmma is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "ssd_common.cuh"

namespace {

using namespace repro_ssd;

constexpr int kMaxChunk = 256;  // one scan element per thread

template <int BT, int P, int N>
constexpr int bwd_smem_floats(int L) {
  return 2 * P * (N + kPad)       // h_in, dh
         + 2 * BT * (N + kPad)    // C and B tiles
         + 2 * BT * (P + kPad)    // dy and x tiles
         + P * (BT + kPad)        // a transposed, scaled x or dy tile
         + 2 * BT * (BT + kPad)   // the two score tiles
         + 4 * L;                 // cum, dt, w or dy . y, x . g
}

// sum of v over the block; every thread gets it (all must call)
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();  // the last readers of red are done
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int i = 0; i < kThreads / 32; ++i) t += red[i];
  return t;
}

// sum over the sixteen threads of a half warp (one row group)
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// inclusive prefix sum over threadIdx.x of v (all must call)
__device__ __forceinline__ float block_scan(float v, float* warp_tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += u;
  }
  __syncthreads();  // the last readers of warp_tot are done
  if (lane == 31) warp_tot[warp] = v;
  __syncthreads();
  for (int i = 0; i < warp; ++i) v += warp_tot[i];
  return v;
}

// dt of the chunk at c0 (0 at or past S) and cum = its prefix sum of dt A
__device__ __forceinline__ void chunk_cum(const float* dtp, long long ld,
                                          float a_h, int c0, int S, int L,
                                          float* cum_s, float* dt_s,
                                          float* warp_tot) {
  const int tid = threadIdx.x;
  float d = 0.f;
  if (tid < L && c0 + tid < S) d = dtp[(c0 + tid) * ld];
  const float v = block_scan(d * a_h, warp_tot);
  if (tid < L) {
    cum_s[tid] = v;
    dt_s[tid] = d;
  }
  __syncthreads();
}

template <typename T, int BT, int P, int N>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const T* __restrict__ Bm,
               const T* __restrict__ Cm, const float* __restrict__ init,
               const T* __restrict__ dy, const float* __restrict__ dfinal,
               T* __restrict__ dx, float* __restrict__ ddt,
               float* __restrict__ dA_part, float* __restrict__ dB_part,
               float* __restrict__ dC_part, float* __restrict__ dinit,
               float* __restrict__ hin_ws, Strides sx, Strides sdt,
               Strides sb, Strides sc, Strides sdy, int S, int H, int G,
               int L) {
  constexpr int R = BT / 16;      // tile rows per thread
  constexpr int QP = P / 16;      // head-dim columns per thread
  constexpr int QN = N / 16;      // state columns per thread
  constexpr int LDN = N + kPad;
  constexpr int LDP = P + kPad;
  constexpr int LDT = BT + kPad;
  extern __shared__ float4 smem4[];
  float* hin_s = reinterpret_cast<float*>(smem4);  // P x LDN
  float* dh_s = hin_s + P * LDN;                    // P x LDN
  float* c_s = dh_s + P * LDN;                      // BT x LDN
  float* b_s = c_s + BT * LDN;                      // BT x LDN
  float* dy_s = b_s + BT * LDN;                     // BT x LDP
  float* x_s = dy_s + BT * LDP;                     // BT x LDP
  float* t_s = x_s + BT * LDP;                      // P x LDT
  float* s_s = t_s + P * LDT;                       // BT x LDT
  float* m_s = s_s + BT * LDT;                      // BT x LDT
  float* cum_s = m_s + BT * LDT;                    // L
  float* dt_s = cum_s + L;                          // L
  float* dyy_s = dt_s + L;                          // L: w, then dy . y
  float* xg_s = dyy_s + L;                          // L: x . g
  __shared__ float red[kThreads / 32];

  const int h = blockIdx.x, b = blockIdx.y, g = h / (H / G);
  const int tid = threadIdx.x, rg = tid >> 4, cg = tid & 15;
  const float a_h = A[h];
  const T* xp = x + b * sx.b + h * sx.h;
  const float* dtp = dt + b * sdt.b + h * sdt.h;
  const T* bp = Bm + b * sb.b + g * sb.h;
  const T* cp = Cm + b * sc.b + g * sc.h;
  const T* dyp = dy + b * sdy.b + h * sdy.h;
  const long long hp = static_cast<long long>(H) * P;
  const long long hn = static_cast<long long>(H) * N;
  T* dxp = dx + static_cast<long long>(b) * S * hp + h * P;
  float* ddtp = ddt + static_cast<long long>(b) * S * H + h;
  float* dbp = dB_part + static_cast<long long>(b) * S * hn + h * N;
  float* dcp = dC_part + static_cast<long long>(b) * S * hn + h * N;
  const long long st_off = (static_cast<long long>(b) * H + h) * P * N;
  const int nc = (S + L - 1) / L, ntiles = L / BT;
  auto hin_at = [&](int c) {
    return hin_ws + ((static_cast<long long>(b) * nc + c) * H + h) * P * N;
  };

  // ---- forward walk: the state entering each chunk, then the final state
  for (int e = tid; e < P * N; e += kThreads)
    hin_s[(e / N) * LDN + e % N] = init != nullptr ? init[st_off + e] : 0.f;
  for (int c = 0; c < nc; ++c) {
    const int c0 = c * L;
    chunk_cum(dtp, sdt.s, a_h, c0, S, L, cum_s, dt_s, red);
    const float seg = cum_s[L - 1];
    if (tid < L) dyy_s[tid] = expf(seg - cum_s[tid]) * dt_s[tid];
    float* out = hin_at(c);
    for (int e = tid; e < P * N; e += kThreads)
      out[e] = hin_s[(e / N) * LDN + e % N];
    float sacc[QP][QN];
    const float es = expf(seg);
#pragma unroll
    for (int i = 0; i < QP; ++i)
#pragma unroll
      for (int j = 0; j < QN; ++j)
        sacc[i][j] = es * hin_s[(rg + 16 * i) * LDN + cg + 16 * j];
    for (int kj = 0; kj < ntiles; ++kj) {
      const int k0 = c0 + kj * BT;
      if (k0 >= S) break;
      __syncthreads();  // w is written; the last tile's readers are done
      load_rows<T, N>(b_s, LDN, bp, sb.s, k0, BT, S);
      for (int e = tid; e < BT * P; e += kThreads) {  // (w x)^T
        const int r = e / P, col = e % P, s = k0 + r;
        t_s[col * LDT + r] =
            s < S ? to_float(xp[s * sx.s + col]) * dyy_s[kj * BT + r] : 0.f;
      }
      __syncthreads();
      dot_tile_kn<QP, QN, BT>(t_s, LDT, b_s, LDN, rg, cg, sacc);
    }
    __syncthreads();  // every reader of the old state is done
#pragma unroll
    for (int i = 0; i < QP; ++i)
#pragma unroll
      for (int j = 0; j < QN; ++j)
        hin_s[(rg + 16 * i) * LDN + cg + 16 * j] = sacc[i][j];
  }
  __syncthreads();

  // ---- reverse walk, carrying dh and <dh, h_out>
  float part = 0.f;
  for (int e = tid; e < P * N; e += kThreads) {
    const int idx = (e / N) * LDN + e % N;
    const float d = dfinal != nullptr ? dfinal[st_off + e] : 0.f;
    dh_s[idx] = d;
    part += d * hin_s[idx];
  }
  float carry = block_sum(part, red);
  float da_acc = 0.f;

  for (int c = nc - 1; c >= 0; --c) {
    const int c0 = c * L;
    chunk_cum(dtp, sdt.s, a_h, c0, S, L, cum_s, dt_s, red);
    const float seg = cum_s[L - 1];
    const float* in = hin_at(c);
    for (int e = tid; e < P * N; e += kThreads)
      hin_s[(e / N) * LDN + e % N] = in[e];
    if (tid < L) dyy_s[tid] = xg_s[tid] = 0.f;
    __syncthreads();

    // key tiles s: g (so dx), dB and x . g
    for (int kj = 0; kj < ntiles; ++kj) {
      const int k0 = c0 + kj * BT;
      if (k0 >= S) break;
      __syncthreads();  // the last tile's readers are done
      load_rows<T, N>(b_s, LDN, bp, sb.s, k0, BT, S);
      load_rows<T, P>(x_s, LDP, xp, sx.s, k0, BT, S);
      __syncthreads();
      float gacc[R][QP], dbacc[R][QN];
#pragma unroll
      for (int i = 0; i < R; ++i) {
#pragma unroll
        for (int j = 0; j < QP; ++j) gacc[i][j] = 0.f;
#pragma unroll
        for (int j = 0; j < QN; ++j) dbacc[i][j] = 0.f;
      }
      dot_tile<R, QP, N>(b_s, LDN, dh_s, LDN, rg, cg, gacc);
      dot_tile_kn<R, QN, P>(x_s, LDP, dh_s, LDN, rg, cg, dbacc);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float tail = expf(seg - cum_s[kj * BT + rg + 16 * i]);
#pragma unroll
        for (int j = 0; j < QP; ++j) gacc[i][j] *= tail;
#pragma unroll
        for (int j = 0; j < QN; ++j) dbacc[i][j] *= tail;
      }
      for (int qi = kj; qi < ntiles; ++qi) {
        const int r0 = c0 + qi * BT;
        if (r0 >= S) break;  // dy is zero there
        __syncthreads();
        load_rows<T, N>(c_s, LDN, cp, sc.s, r0, BT, S);
        load_rows<T, P>(dy_s, LDP, dyp, sdy.s, r0, BT, S);
        __syncthreads();
        float t1[R][R], t2[R][R];
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int j = 0; j < R; ++j) t1[i][j] = t2[i][j] = 0.f;
        dot_tile<R, R, N>(b_s, LDN, c_s, LDN, rg, cg, t1);   // B_s . C_t
        dot_tile<R, R, P>(x_s, LDP, dy_s, LDP, rg, cg, t2);  // x_s . dy_t
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const int sl = kj * BT + rg + 16 * i;
#pragma unroll
          for (int j = 0; j < R; ++j) {
            const int tl = qi * BT + cg + 16 * j;
            const float dec = tl >= sl ? expf(cum_s[tl] - cum_s[sl]) : 0.f;
            s_s[(rg + 16 * i) * LDT + cg + 16 * j] = t1[i][j] * dec;
            m_s[(rg + 16 * i) * LDT + cg + 16 * j] = t2[i][j] * dec;
          }
        }
        __syncthreads();
        dot_tile_kn<R, QP, BT>(s_s, LDT, dy_s, LDP, rg, cg, gacc);
        dot_tile_kn<R, QN, BT>(m_s, LDT, c_s, LDN, rg, cg, dbacc);
      }
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int sl = kj * BT + rg + 16 * i, s = c0 + sl;
        const float d = dt_s[sl];
        float xg = 0.f;
#pragma unroll
        for (int j = 0; j < QP; ++j)
          xg += x_s[(rg + 16 * i) * LDP + cg + 16 * j] * gacc[i][j];
        xg = row_sum(xg);
        if (s < S) {
#pragma unroll
          for (int j = 0; j < QP; ++j)
            store(dxp + s * hp + cg + 16 * j, d * gacc[i][j]);
#pragma unroll
          for (int j = 0; j < QN; ++j)
            dbp[s * hn + cg + 16 * j] = d * dbacc[i][j];
          if (cg == 0) xg_s[sl] = xg;
        }
      }
    }

    // dh becomes exp(seg) dh here; the query tiles add sum exp(cum) dy C
    __syncthreads();  // every reader of dh_out is done
    const float es = expf(seg);
#pragma unroll
    for (int i = 0; i < QP; ++i)
#pragma unroll
      for (int j = 0; j < QN; ++j) dh_s[(rg + 16 * i) * LDN + cg + 16 * j] *= es;

    // query tiles t: y, dC, dy . y and dh_in
    for (int qi = 0; qi < ntiles; ++qi) {
      const int r0 = c0 + qi * BT;
      if (r0 >= S) break;
      __syncthreads();
      load_rows<T, N>(c_s, LDN, cp, sc.s, r0, BT, S);
      load_rows<T, P>(dy_s, LDP, dyp, sdy.s, r0, BT, S);
      for (int e = tid; e < BT * P; e += kThreads) {  // (exp(cum) dy)^T
        const int r = e / P, col = e % P, s = r0 + r;
        t_s[col * LDT + r] = s < S ? to_float(dyp[s * sdy.s + col]) *
                                         expf(cum_s[qi * BT + r])
                                   : 0.f;
      }
      __syncthreads();
      float yacc[R][QP], dcacc[R][QN];
#pragma unroll
      for (int i = 0; i < R; ++i) {
#pragma unroll
        for (int j = 0; j < QP; ++j) yacc[i][j] = 0.f;
#pragma unroll
        for (int j = 0; j < QN; ++j) dcacc[i][j] = 0.f;
      }
      dot_tile<R, QP, N>(c_s, LDN, hin_s, LDN, rg, cg, yacc);
      dot_tile_kn<R, QN, P>(dy_s, LDP, hin_s, LDN, rg, cg, dcacc);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float e = expf(cum_s[qi * BT + rg + 16 * i]);
#pragma unroll
        for (int j = 0; j < QP; ++j) yacc[i][j] *= e;
#pragma unroll
        for (int j = 0; j < QN; ++j) dcacc[i][j] *= e;
      }
      for (int kj = 0; kj <= qi; ++kj) {
        const int k0 = c0 + kj * BT;
        __syncthreads();
        load_rows<T, N>(b_s, LDN, bp, sb.s, k0, BT, S);
        load_rows<T, P>(x_s, LDP, xp, sx.s, k0, BT, S);
        __syncthreads();
        float t1[R][R], t2[R][R];
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int j = 0; j < R; ++j) t1[i][j] = t2[i][j] = 0.f;
        dot_tile<R, R, N>(c_s, LDN, b_s, LDN, rg, cg, t1);   // C_t . B_s
        dot_tile<R, R, P>(dy_s, LDP, x_s, LDP, rg, cg, t2);  // dy_t . x_s
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const int tl = qi * BT + rg + 16 * i;
#pragma unroll
          for (int j = 0; j < R; ++j) {
            const int sl = kj * BT + cg + 16 * j;
            const float f =
                tl >= sl ? expf(cum_s[tl] - cum_s[sl]) * dt_s[sl] : 0.f;
            s_s[(rg + 16 * i) * LDT + cg + 16 * j] = t1[i][j] * f;
            m_s[(rg + 16 * i) * LDT + cg + 16 * j] = t2[i][j] * f;
          }
        }
        __syncthreads();
        dot_tile_kn<R, QP, BT>(s_s, LDT, x_s, LDP, rg, cg, yacc);
        dot_tile_kn<R, QN, BT>(m_s, LDT, b_s, LDN, rg, cg, dcacc);
      }
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int tl = qi * BT + rg + 16 * i, s = c0 + tl;
        float dyy = 0.f;
#pragma unroll
        for (int j = 0; j < QP; ++j)
          dyy += dy_s[(rg + 16 * i) * LDP + cg + 16 * j] * yacc[i][j];
        dyy = row_sum(dyy);
        if (s < S) {
#pragma unroll
          for (int j = 0; j < QN; ++j)
            dcp[s * hn + cg + 16 * j] = dcacc[i][j];
          if (cg == 0) dyy_s[tl] = dyy;
        }
      }
      float hacc[QP][QN];
#pragma unroll
      for (int i = 0; i < QP; ++i)
#pragma unroll
        for (int j = 0; j < QN; ++j) hacc[i][j] = 0.f;
      dot_tile_kn<QP, QN, BT>(t_s, LDT, c_s, LDN, rg, cg, hacc);
#pragma unroll
      for (int i = 0; i < QP; ++i)
#pragma unroll
        for (int j = 0; j < QN; ++j)
          dh_s[(rg + 16 * i) * LDN + cg + 16 * j] += hacc[i][j];
    }
    __syncthreads();  // dh_in, dy . y and x . g are complete

    // <dh_in, h_in>: the next chunk's <dh, h_out>
    part = 0.f;
#pragma unroll
    for (int i = 0; i < QP; ++i)
#pragma unroll
      for (int j = 0; j < QN; ++j) {
        const int idx = (rg + 16 * i) * LDN + cg + 16 * j;
        part += dh_s[idx] * hin_s[idx];
      }
    const float next_carry = block_sum(part, red);

    // ddt and dA from the suffix sums of dcum, thread tid at u = L - 1 - tid
    const int u = L - 1 - tid;
    float v = 0.f;
    if (tid < L) {
      v = dyy_s[u] - dt_s[u] * xg_s[u];
      if (tid == 0) v += carry;
    }
    v = block_scan(v, red);
    if (tid < L) {
      if (c0 + u < S) ddtp[(c0 + u) * H] = xg_s[u] + a_h * v;
      da_acc += dt_s[u] * v;
    }
    carry = next_carry;
  }
  __syncthreads();
  for (int e = tid; e < P * N; e += kThreads)
    dinit[st_off + e] = dh_s[(e / N) * LDN + e % N];
  const float da = block_sum(da_acc, red);
  if (tid == 0) dA_part[b * H + h] = da;
}

template <typename T, int BT, int P, int N>
cudaError_t launch(void* const* p, const long long* sd, int B, int S, int H,
                   int G, int L, cudaStream_t stream) {
  const int smem = bwd_smem_floats<BT, P, N>(L) * 4;
  auto kernel = ssd_bwd_kernel<T, BT, P, N>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(H, B), kThreads, smem, stream>>>(
      static_cast<const T*>(p[0]), static_cast<const float*>(p[1]),
      static_cast<const float*>(p[2]), static_cast<const T*>(p[3]),
      static_cast<const T*>(p[4]), static_cast<const float*>(p[5]),
      static_cast<const T*>(p[6]), static_cast<const float*>(p[7]),
      static_cast<T*>(p[8]), static_cast<float*>(p[9]),
      static_cast<float*>(p[10]), static_cast<float*>(p[11]),
      static_cast<float*>(p[12]), static_cast<float*>(p[13]),
      static_cast<float*>(p[14]), Strides{sd[0], sd[1], sd[2]},
      Strides{sd[3], sd[4], sd[5]}, Strides{sd[6], sd[7], sd[8]},
      Strides{sd[9], sd[10], sd[11]}, Strides{sd[12], sd[13], sd[14]}, S, H,
      G, L);
  return cudaGetLastError();
}

template <typename T, int BT>
cudaError_t launch_pn(int P, int N, void* const* p, const long long* sd,
                      int B, int S, int H, int G, int L, cudaStream_t s) {
  if (P == 64 && N == 128)
    return launch<T, BT, 64, 128>(p, sd, B, S, H, G, L, s);
  if (P == 64 && N == 64)
    return launch<T, BT, 64, 64>(p, sd, B, S, H, G, L, s);
  if (P == 64 && N == 32)
    return launch<T, BT, 64, 32>(p, sd, B, S, H, G, L, s);
  if (P == 32 && N == 16)
    return launch<T, BT, 32, 16>(p, sd, B, S, H, G, L, s);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_t(int P, int N, void* const* p, const long long* sd,
                     int B, int S, int H, int G, int L, cudaStream_t s) {
  if (L == 32) return launch_pn<T, 32>(P, N, p, sd, B, S, H, G, L, s);
  return launch_pn<T, 64>(P, N, p, sd, B, S, H, G, L, s);
}

}  // namespace

// ptrs: 15 device pointers, in order x, dt, A, Bm, C, init (may be null),
// dy, dfinal (may be null), dx, ddt, dA_part, dB_part, dC_part, dinit,
// hin (the workspace of B nc H P N floats, nc = ceil(S / L)).  strides: 15
// int64 element strides, (b, s, head) of x, dt and dy and (b, s, group) of
// Bm and C, in the order x, dt, Bm, C, dy.  (P, N) is one of (64, 128),
// (64, 64), (64, 32), (32, 16); L one of 32, 64, 128, 256; dtype 0 =
// float32, 1 = bfloat16 (x, Bm, C, dy and dx).  Returns the launch's
// cudaError_t (0 on success); the Python wrapper checks shapes, dtypes
// and devices before the call and raises on a non-zero return.
extern "C" int repro_ssd_scan_bwd(void* const* ptrs,
                                  const long long* strides, int B, int S,
                                  int H, int G, int P, int N, int L,
                                  int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G != 0 || B > 65535 ||
      (L != 32 && L != 64 && L != 128 && L != kMaxChunk))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();  // the code returned below belongs to this call
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(
        launch_t<float>(P, N, ptrs, strides, B, S, H, G, L, s));
  if (dtype == 1)
    return static_cast<int>(
        launch_t<__nv_bfloat16>(P, N, ptrs, strides, B, S, H, G, L, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
