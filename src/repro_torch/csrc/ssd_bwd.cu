// Backward of the Mamba-2 SSD chunked scan for Hopper (sm_90a), bound
// through a plain C entry: chunk-parallel on wgmma for bf16, float32 FMA
// for float32.
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
//   dA_part (B, H) float32 (B, nc, H) bf16; dB_part, dC_part (B, S, H, N):
//         float32 per-head partials, contiguous; the wrapper sums dA over
//         the batch (and chunks) and dB, dC over the heads of each group
//   dinit (B, H, P, N)   float32, contiguous
//
// bf16: chunk-parallel on the tensor cores, 128-thread warpgroups, float32
// accumulators, every product on wgmma, on one stream:
//   1. ssd.cu's own ssd_cb_kernel, ssd_state_kernel and ssd_pass_kernel
//      (repro_ssd_states, called by the wrapper) rebuild C B^T per group,
//      cum, dt and h_in of every chunk, and the final state;
//   2. ssd_dstate_kernel, per (chunk, head, batch row): the chunk's share
//      of dh_in, dy^T (exp(cum) o C), P x N;
//   3. ssd_dpass_kernel, per (state element, head, batch row), the only
//      serial part: dh <- exp(seg) dh + share from the last chunk to the
//      first, seeded with dfinal; it leaves the dh leaving each chunk in
//      the shares' place, writes dinit, and the parts of <dh_out, h_out>;
//   4. ssd_bwd_key_kernel and ssd_bwd_query_kernel, per (64-row tile,
//      head, chunk, batch row), tiles and heads fastest so a chunk's C B^T
//      stays in L2: over key tiles s, g (so dx), dB and x . g; over query
//      tiles t, y, dC and dy . y.  These are the FMA kernel's two loops,
//      chunk-parallel: the masked scores come from the C B^T workspace
//      (transposed on the key side), and x dy^T is a product of its own;
//   5. ssd_dcum_kernel, per (chunk, head, batch row): dcum, its suffix
//      sums, ddt and the chunk's part of dA.
// x, B, C and dy enter the products as bf16, exactly.  Float32 operands
// are split: dh, h_in, exp(cum) C, w B and the masked x dy^T into bf16 hi
// + lo (each term within 2^-17 of itself), the decayed scores of g and y
// into hi + mid + lo (2^-25).  g's and y's diagonal terms are the largest
// in dcum, and dA sums dt_u R_u over every position, terms far larger
// than the result: with the scores in two parts dA missed phase 3's
// 2^-12 of its largest value by 1.6x on the ragged main shape (the CPU
// emulation, tests/test_torch_ssd.py, gives the card's number).  The
// per-head partials of dB and dC and the per-chunk parts of dA and
// <dh_out, h_out> are summed in a fixed order: no float atomics, the same
// bits every run.  Positions at or past S read as dt = 0 and x = B = C =
// dy = 0 and are never written; L 32 runs as one 64-row tile with rows
// past L zero; P 32 and N 16 run on 64- and 32-wide tiles, zero past P, N.
//
// Workspaces, float32, at mamba2's training shape (B 4, S 2048, H 64, P 64,
// N 128, L 256; nc 8 chunks of LT 256 rows): C B^T 8.4 MB, h_in 67.1 MB,
// cum and dt 2.1 MB each (stage 1); the final state 8.4 MB, the shares
// and dh_out 67.1 MB, dy . y and x . g 2.1 MB each, the parts 0.3 MB: 160
// MB, transient, against the FMA path's 67 MB (h_in alone); dB_part and
// dC_part are 268 MB each on both paths.  Shared memory: 85 KB a stage-4
// block at N 128, and 255 registers a thread: two blocks an SM.
//
// What bounds it on an H100: operations (chip_smoke.py's ssd_bwd_flops_
// bytes: 129 GFLOP visible at mamba2's shape, 0.13 ms at 989 TFLOP/s).
// Each 64 x 64 tile pair takes one x dy^T product, three g (or y) and two
// dB (or dC) products a 64-column half of N; the blocks wait on every
// product before staging the next tile (no pipelining yet).
//
// float32: ssd_bwd_kernel, the first version in float32 FMA on the CUDA
// cores (the float32 path is held to the plain version's float32, which
// a split product does not promise for every input): one block of 256
// threads per (head, batch row), the forward's float32 ssd_kernel's
// building blocks (ssd_common.cuh).  A forward walk over the chunks
// recomputes the state entering each one into the hin workspace (B nc H P
// N) and ends on the final state; a reverse walk carries dh (P x N
// float32) in shared memory.  Per chunk, a loop over key tiles s (with
// the query tiles t >= s inside) gives g, dx, dB and x . g; a loop over
// query tiles t (with s <= t inside) gives y, dC, dy . y and the dy (x) C
// sum of dh_in; then a suffix scan of dcum gives ddt and the block's share
// of dA.  About 150 GFLOP at mamba2's shape on the CUDA cores' 67 TFLOP/s
// float32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "ssd_common.cuh"
#include "ssd_tc.cuh"

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

// ------------------------------------- bf16: chunk-parallel, on wgmma
using namespace repro_ssd_tc;

// Stage 2.  The chunk's share of dh_in, dy^T (exp(cum) o C) (P x N), for
// chunk c, head h, batch row b, to dstates (B, nc, H, P, N), over 64-row
// slabs of the chunk: the transposed twin of ssd.cu's ssd_state_kernel,
// with exp(cum) C split into bf16 hi + lo.  Grid (nc, H, B).
template <int NW>
__global__ void __launch_bounds__(kTcThreads)
ssd_dstate_kernel(const bf16* __restrict__ dy, const bf16* __restrict__ Cm,
                  const float* __restrict__ cum_ws,
                  float* __restrict__ dstates, Strides sdy, Strides sc,
                  Geo q) {
  using LN = Swz<NW>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  const uint32_t dy_s = smem_u32(smem);            // 64 x 64, one slab
  const uint32_t ehi = dy_s + 64 * 64 * 2;         // 64 x NW
  const uint32_t elo = ehi + 64 * NW * 2;
  float* e_s = reinterpret_cast<float*>(smem + 64 * 64 * 2 + 4 * 64 * NW);

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (q.H / q.G), c0 = c * q.L, live = min(q.L, q.S - c0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long cd = (static_cast<long long>(b) * q.H + h) * q.nc * q.LT +
                       static_cast<long long>(c) * q.LT;
  for (int l = tid; l < q.LT; l += kTcThreads) e_s[l] = expf(cum_ws[cd + l]);
  __syncthreads();

  float acc[LN::kHalves][LN::kW / 2];
#pragma unroll
  for (int hh = 0; hh < LN::kHalves; ++hh)
#pragma unroll
    for (int e = 0; e < LN::kW / 2; ++e) acc[hh][e] = 0.f;
  const bf16* dyp = dy + b * sdy.b + h * sdy.h + c0 * sdy.s;
  const bf16* cp = Cm + b * sc.b + g * sc.h + c0 * sc.s;
  for (int l64 = 0; l64 < live; l64 += 64) {        // uniform over the block
    stage<64>(dy_s, dyp + l64 * sdy.s, sdy.s, 64, live - l64, q.P);
    stage_scaled_split<NW>(ehi, elo, cp + l64 * sc.s, sc.s, live - l64, q.N,
                           e_s + l64);
    fence_async_smem();
    __syncthreads();
#pragma unroll
    for (int hh = 0; hh < LN::kHalves; ++hh) pin(acc[hh]);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int hh = 0; hh < LN::kHalves; ++hh) {
        wgmma_ss<1, 1>(acc[hh], desc_mn<64>(dy_s, 64, 0, kk),
                       desc_mn<NW>(ehi, 64, hh, kk), 1);
        wgmma_ss<1, 1>(acc[hh], desc_mn<64>(dy_s, 64, 0, kk),
                       desc_mn<NW>(elo, 64, hh, kk), 1);
      }
    wg_commit();
    wg_wait<0>();
#pragma unroll
    for (int hh = 0; hh < LN::kHalves; ++hh) pin(acc[hh]);
    __syncthreads();                     // the slab's readers are done
  }

  // acc: rows p, columns n of the share
  const int r = 16 * warp + (lane >> 2), cc = 2 * (lane & 3);
  float* sp = dstates + ((static_cast<long long>(b) * q.nc + c) * q.H + h) *
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

// Stage 3.  The reverse pass, the only serial part: per state element,
// from the last chunk to the first, dh <- exp(seg) dh + share, seeded with
// dfinal.  Leaves in dstates the dh leaving each chunk (in place of its
// share), writes dinit, and writes the block's part of <dh_out, h_out> of
// each chunk to part (B, H, nc, gridDim.x), h_out being the state entering
// the next chunk (states) or, for the last, the final state.  Grid
// (ceil(P N / 256), H, B), 256 threads, one state element each.
__global__ void __launch_bounds__(256)
ssd_dpass_kernel(float* __restrict__ dstates,
                 const float* __restrict__ states,
                 const float* __restrict__ fin,
                 const float* __restrict__ cum_ws,
                 const float* __restrict__ dfinal, float* __restrict__ dinit,
                 float* __restrict__ part, Geo q) {
  __shared__ float red[8];
  const int h = blockIdx.y, b = blockIdx.z, pn = q.P * q.N;
  const int e = blockIdx.x * 256 + threadIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool on = e < pn;                // the others join the block sums
  const long long bh = static_cast<long long>(b) * q.H + h;
  auto at = [&](int c) {
    return ((static_cast<long long>(b) * q.nc + c) * q.H + h) * pn + e;
  };
  float dh = on && dfinal != nullptr ? dfinal[bh * pn + e] : 0.f;
  for (int c = q.nc - 1; c >= 0; --c) {
    float share = 0.f, hout = 0.f;
    if (on) {
      share = dstates[at(c)];
      hout = c + 1 < q.nc ? states[at(c + 1)] : fin[bh * pn + e];
      dstates[at(c)] = dh;
    }
    float v = dh * hout;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) red[warp] = v;
    __syncthreads();
    if (threadIdx.x == 0) {
      float t = 0.f;
#pragma unroll
      for (int w = 0; w < 8; ++w) t += red[w];
      part[(bh * q.nc + c) * gridDim.x + blockIdx.x] = t;
    }
    __syncthreads();                     // red is read before it is reused
    dh = expf(cum_ws[(bh * q.nc + c) * q.LT + q.L - 1]) * dh + share;
  }
  if (on) dinit[bh * pn + e] = dh;
}

// Stage 4, key side.  Rows s of 64-row tile i of chunk c, head h, batch row
// b, with dh = dh_out of the chunk:
//   g_s  = exp(seg - cum_s) dh B_s + sum_{t>=s} (C_t . B_s) decay[t,s] dy_t
//   dB_s = dt_s [exp(seg - cum_s) x_s dh
//                + sum_{t>=s} decay[t,s] (x_s . dy_t) C_t]
// over the query tiles j >= i, then dx_s = dt_s g_s, x_s . g_s (to xg_ws,
// for dcum) and dB_s (to the head's partial).  The decayed scores come
// transposed from the C B^T workspace; x_i dy_j^T is a product of its own.
// Grid (LT / 64, H, nc B), tiles and heads fastest, as ssd_scan_kernel's.
template <int NW>
__global__ void __launch_bounds__(kTcThreads)
ssd_bwd_key_kernel(const bf16* __restrict__ x, const bf16* __restrict__ Bm,
                   const bf16* __restrict__ Cm, const bf16* __restrict__ dy,
                   const float* __restrict__ cb,
                   const float* __restrict__ dh_out,
                   const float* __restrict__ cum_ws,
                   const float* __restrict__ dt_ws, bf16* __restrict__ dx,
                   float* __restrict__ dB_part, float* __restrict__ xg_ws,
                   Strides sx, Strides sb, Strides sc, Strides sdy, Geo q) {
  using LN = Swz<NW>;
  constexpr int NH = LN::kHalves, NF = LN::kW / 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  const uint32_t hhi = smem_u32(smem);             // 64 x NW: dh hi
  const uint32_t hlo = hhi + 64 * NW * 2;          //          dh lo
  const uint32_t b_s = hlo + 64 * NW * 2;          // 64 x NW: B_i
  const uint32_t c_s = b_s + 64 * NW * 2;          // 64 x NW: C_j
  const uint32_t x_s = c_s + 64 * NW * 2;          // 64 x 64: x_i
  const uint32_t dy_s = x_s + 64 * 64 * 2;         // 64 x 64: dy_j
  float* cum_s =
      reinterpret_cast<float*>(smem + 4 * 64 * NW * 2 + 2 * 64 * 64 * 2);
  float* dt_s = cum_s + q.LT;

  const int i = blockIdx.x, h = blockIdx.y;
  const int c = blockIdx.z % q.nc, b = blockIdx.z / q.nc;
  const int g = h / (q.H / q.G), c0 = c * q.L, live = min(q.L, q.S - c0);
  if (64 * i >= live) return;                      // uniform over the block
  const int nt = (live + 63) / 64;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long cd = (static_cast<long long>(b) * q.H + h) * q.nc * q.LT +
                       static_cast<long long>(c) * q.LT;
  for (int l = tid; l < 64 * nt; l += kTcThreads) {
    cum_s[l] = cum_ws[cd + l];
    dt_s[l] = dt_ws[cd + l];
  }
  const float seg = cum_ws[cd + q.L - 1];
  const bf16* xp = x + b * sx.b + h * sx.h + c0 * sx.s;
  const bf16* bp = Bm + b * sb.b + g * sb.h + c0 * sb.s;
  const bf16* cp = Cm + b * sc.b + g * sc.h + c0 * sc.s;
  const bf16* dyp = dy + b * sdy.b + h * sdy.h + c0 * sdy.s;
  stage_split_f32<NW>(hhi, hlo,
                      dh_out + ((static_cast<long long>(b) * q.nc + c) *
                                    q.H + h) * q.P * q.N,
                      q.P, q.N);
  stage<NW>(b_s, bp + 64 * i * sb.s, sb.s, 64, live - 64 * i, q.N);
  stage<64>(x_s, xp + 64 * i * sx.s, sx.s, 64, live - 64 * i, q.P);
  fence_async_smem();
  __syncthreads();

  // the dh terms, B_i dh^T and x_i dh, then their rows times exp(seg - cum)
  float gacc[32], bacc[NH][NF];
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < NW / 16; ++kk)
    wgmma_ss(gacc, desc_k<NW>(b_s, 64, 0, kk), desc_k<NW>(hhi, 64, 0, kk),
             kk > 0);
#pragma unroll
  for (int kk = 0; kk < NW / 16; ++kk)
    wgmma_ss(gacc, desc_k<NW>(b_s, 64, 0, kk), desc_k<NW>(hlo, 64, 0, kk), 1);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int hh = 0; hh < NH; ++hh) {
      wgmma_ss<0, 1>(bacc[hh], desc_k<64>(x_s, 64, 0, kk),
                     desc_mn<NW>(hhi, 64, hh, kk), kk > 0);
      wgmma_ss<0, 1>(bacc[hh], desc_k<64>(x_s, 64, 0, kk),
                     desc_mn<NW>(hlo, 64, hh, kk), 1);
    }
  wg_commit();
  wg_wait<0>();
  pin(gacc);
#pragma unroll
  for (int hh = 0; hh < NH; ++hh) pin(bacc[hh]);
  const int r = 16 * warp + (lane >> 2), cc = 2 * (lane & 3);
  const int s0 = 64 * i + r;             // this thread's rows: s0, s0 + 8
  {
    const float t0 = expf(seg - cum_s[s0]), t1 = expf(seg - cum_s[s0 + 8]);
#pragma unroll
    for (int k = 0; k < 32; ++k) gacc[k] *= (k & 2) ? t1 : t0;
#pragma unroll
    for (int hh = 0; hh < NH; ++hh)
#pragma unroll
      for (int k = 0; k < NF; ++k) bacc[hh][k] *= (k & 2) ? t1 : t0;
  }

  const float* cbp = cb + ((static_cast<long long>(b) * q.nc + c) * q.G + g) *
                              q.LT * q.LT;
  uint32_t shi[4][4], smid[4][4], slo[4][4], mhi[4][4], mlo[4][4];
  for (int j = i; j < nt; ++j) {
    __syncthreads();                     // the last dy_j's, C_j's readers
    stage<64>(dy_s, dyp + 64 * j * sdy.s, sdy.s, 64, live - 64 * j, q.P);
    stage<NW>(c_s, cp + 64 * j * sc.s, sc.s, 64, live - 64 * j, q.N);
    fence_async_smem();
    __syncthreads();
    float macc[32];                      // x_i dy_j^T: rows s, columns t
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss(macc, desc_k<64>(x_s, 64, 0, kk), desc_k<64>(dy_s, 64, 0, kk),
               kk > 0);
    wg_commit();
    // while it runs: the decayed scores (C_t . B_s) decay[t,s] at the same
    // (s, t), transposed out of C B^T in L2, split in three, into g
    {
      float sc_f[32];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int s = s0 + 8 * rr, t = 64 * j + 8 * jj + cc + e;
            // the decay only where t >= s: never exp of a positive sum
            sc_f[4 * jj + 2 * rr + e] =
                t >= s ? cbp[t * q.LT + s] * expf(cum_s[t] - cum_s[s]) : 0.f;
          }
      to_a_frags3<64>(sc_f, shi, smid, slo);
    }
    pin(shi);
    pin(smid);
    pin(slo);
    pin(gacc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs(gacc, shi[kk], desc_mn<64>(dy_s, 64, 0, kk), 1);
      wgmma_rs(gacc, smid[kk], desc_mn<64>(dy_s, 64, 0, kk), 1);
      wgmma_rs(gacc, slo[kk], desc_mn<64>(dy_s, 64, 0, kk), 1);
    }
    wg_commit();
    wg_wait<1>();                        // x_i dy_j^T is done
    pin(macc);
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int s = s0 + 8 * rr, t = 64 * j + 8 * jj + cc + e;
          macc[4 * jj + 2 * rr + e] *=
              t >= s ? expf(cum_s[t] - cum_s[s]) : 0.f;
        }
    to_a_frags2<64>(macc, mhi, mlo);
    pin(mhi);
    pin(mlo);
#pragma unroll
    for (int hh = 0; hh < NH; ++hh) pin(bacc[hh]);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int hh = 0; hh < NH; ++hh) {
        wgmma_rs(bacc[hh], mhi[kk], desc_mn<NW>(c_s, 64, hh, kk), 1);
        wgmma_rs(bacc[hh], mlo[kk], desc_mn<NW>(c_s, 64, hh, kk), 1);
      }
    wg_commit();
    wg_wait<0>();
    pin(gacc);
#pragma unroll
    for (int hh = 0; hh < NH; ++hh) pin(bacc[hh]);
    pin(shi);
    pin(smid);
    pin(slo);
    pin(mhi);
    pin(mlo);
  }

  // rows s: dx = dt g, x . g and dB
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int sl = s0 + 8 * rr;
    const bool row_on = sl < live;
    float xg = 0.f;
    if (row_on)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
        if (8 * jj < q.P) {
          const float2 xv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(xp + sl * sx.s +
                                                       8 * jj + cc));
          xg += xv.x * gacc[4 * jj + 2 * rr] +
                xv.y * gacc[4 * jj + 2 * rr + 1];
        }
    xg += __shfl_xor_sync(0xffffffffu, xg, 1);
    xg += __shfl_xor_sync(0xffffffffu, xg, 2);
    if (!row_on) continue;
    if ((lane & 3) == 0) xg_ws[cd + sl] = xg;
    const float d = dt_s[sl];
    const long long row =
        (static_cast<long long>(b) * q.S + c0 + sl) * q.H + h;
    bf16* dxp = dx + row * q.P;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
      if (8 * jj < q.P)
        *reinterpret_cast<uint32_t*>(dxp + 8 * jj + cc) =
            pack_bf16(d * gacc[4 * jj + 2 * rr],
                      d * gacc[4 * jj + 2 * rr + 1]);
    float* dbp = dB_part + row * q.N;
#pragma unroll
    for (int hh = 0; hh < NH; ++hh)
#pragma unroll
      for (int jj = 0; jj < LN::kW / 8; ++jj) {
        const int n = hh * LN::kW + 8 * jj + cc;
        if (n < q.N)
          *reinterpret_cast<float2*>(dbp + n) =
              make_float2(d * bacc[hh][4 * jj + 2 * rr],
                          d * bacc[hh][4 * jj + 2 * rr + 1]);
      }
  }
}

// Stage 4, query side.  Rows t of 64-row tile i of chunk c, head h, batch
// row b, with h_in the state entering the chunk:
//   y_t  = exp(cum_t) C_t h_in^T + sum_{s<=t} (C_t . B_s) decay[t,s] dt_s x_s
//   dC_t = exp(cum_t) dy_t h_in + sum_{s<=t} decay[t,s] dt_s (dy_t . x_s) B_s
// over the key tiles j <= i; y (float32, never stored) gives dy_t . y_t (to
// dyy_ws, for dcum), and dC_t goes to the head's partial.  Grid as the key
// side's.
template <int NW>
__global__ void __launch_bounds__(kTcThreads)
ssd_bwd_query_kernel(const bf16* __restrict__ x, const bf16* __restrict__ Bm,
                     const bf16* __restrict__ Cm, const bf16* __restrict__ dy,
                     const float* __restrict__ cb,
                     const float* __restrict__ states,
                     const float* __restrict__ cum_ws,
                     const float* __restrict__ dt_ws,
                     float* __restrict__ dC_part, float* __restrict__ dyy_ws,
                     Strides sx, Strides sb, Strides sc, Strides sdy, Geo q) {
  using LN = Swz<NW>;
  constexpr int NH = LN::kHalves, NF = LN::kW / 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  const uint32_t hhi = smem_u32(smem);             // 64 x NW: h_in hi
  const uint32_t hlo = hhi + 64 * NW * 2;          //          h_in lo
  const uint32_t c_s = hlo + 64 * NW * 2;          // 64 x NW: C_i
  const uint32_t b_s = c_s + 64 * NW * 2;          // 64 x NW: B_j
  const uint32_t dy_s = b_s + 64 * NW * 2;         // 64 x 64: dy_i
  const uint32_t x_s = dy_s + 64 * 64 * 2;         // 64 x 64: x_j
  float* cum_s =
      reinterpret_cast<float*>(smem + 4 * 64 * NW * 2 + 2 * 64 * 64 * 2);
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
  const bf16* xp = x + b * sx.b + h * sx.h + c0 * sx.s;
  const bf16* bp = Bm + b * sb.b + g * sb.h + c0 * sb.s;
  const bf16* cp = Cm + b * sc.b + g * sc.h + c0 * sc.s;
  const bf16* dyp = dy + b * sdy.b + h * sdy.h + c0 * sdy.s;
  stage_split_f32<NW>(hhi, hlo,
                      states + ((static_cast<long long>(b) * q.nc + c) *
                                    q.H + h) * q.P * q.N,
                      q.P, q.N);
  stage<NW>(c_s, cp + 64 * i * sc.s, sc.s, 64, live - 64 * i, q.N);
  stage<64>(dy_s, dyp + 64 * i * sdy.s, sdy.s, 64, live - 64 * i, q.P);
  fence_async_smem();
  __syncthreads();

  // the h_in terms, C_i h_in^T and dy_i h_in, then their rows times exp(cum)
  float yacc[32], cacc[NH][NF];
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < NW / 16; ++kk)
    wgmma_ss(yacc, desc_k<NW>(c_s, 64, 0, kk), desc_k<NW>(hhi, 64, 0, kk),
             kk > 0);
#pragma unroll
  for (int kk = 0; kk < NW / 16; ++kk)
    wgmma_ss(yacc, desc_k<NW>(c_s, 64, 0, kk), desc_k<NW>(hlo, 64, 0, kk), 1);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int hh = 0; hh < NH; ++hh) {
      wgmma_ss<0, 1>(cacc[hh], desc_k<64>(dy_s, 64, 0, kk),
                     desc_mn<NW>(hhi, 64, hh, kk), kk > 0);
      wgmma_ss<0, 1>(cacc[hh], desc_k<64>(dy_s, 64, 0, kk),
                     desc_mn<NW>(hlo, 64, hh, kk), 1);
    }
  wg_commit();
  wg_wait<0>();
  pin(yacc);
#pragma unroll
  for (int hh = 0; hh < NH; ++hh) pin(cacc[hh]);
  const int r = 16 * warp + (lane >> 2), cc = 2 * (lane & 3);
  const int t0 = 64 * i + r;             // this thread's rows: t0, t0 + 8
  {
    const float e0 = expf(cum_s[t0]), e1 = expf(cum_s[t0 + 8]);
#pragma unroll
    for (int k = 0; k < 32; ++k) yacc[k] *= (k & 2) ? e1 : e0;
#pragma unroll
    for (int hh = 0; hh < NH; ++hh)
#pragma unroll
      for (int k = 0; k < NF; ++k) cacc[hh][k] *= (k & 2) ? e1 : e0;
  }

  const float* cbp = cb + ((static_cast<long long>(b) * q.nc + c) * q.G + g) *
                              q.LT * q.LT;
  uint32_t shi[4][4], smid[4][4], slo[4][4], mhi[4][4], mlo[4][4];
  for (int j = 0; j <= i; ++j) {
    __syncthreads();                     // the last x_j's, B_j's readers
    stage<64>(x_s, xp + 64 * j * sx.s, sx.s, 64, live - 64 * j, q.P);
    stage<NW>(b_s, bp + 64 * j * sb.s, sb.s, 64, live - 64 * j, q.N);
    fence_async_smem();
    __syncthreads();
    float macc[32];                      // dy_i x_j^T: rows t, columns s
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss(macc, desc_k<64>(dy_s, 64, 0, kk), desc_k<64>(x_s, 64, 0, kk),
               kk > 0);
    wg_commit();
    // while it runs: the scores (C_t . B_s) decay[t,s] dt_s from C B^T in
    // L2, split in three, into y
    {
      float sc_f[32];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int t = t0 + 8 * rr, s = 64 * j + 8 * jj + cc;
          const float2 v =
              *reinterpret_cast<const float2*>(cbp + t * q.LT + s);
          // the decay only where t >= s: never exp of a positive sum
          sc_f[4 * jj + 2 * rr] =
              t >= s ? v.x * expf(cum_s[t] - cum_s[s]) * dt_s[s] : 0.f;
          sc_f[4 * jj + 2 * rr + 1] =
              t >= s + 1
                  ? v.y * expf(cum_s[t] - cum_s[s + 1]) * dt_s[s + 1]
                  : 0.f;
        }
      to_a_frags3<64>(sc_f, shi, smid, slo);
    }
    pin(shi);
    pin(smid);
    pin(slo);
    pin(yacc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs(yacc, shi[kk], desc_mn<64>(x_s, 64, 0, kk), 1);
      wgmma_rs(yacc, smid[kk], desc_mn<64>(x_s, 64, 0, kk), 1);
      wgmma_rs(yacc, slo[kk], desc_mn<64>(x_s, 64, 0, kk), 1);
    }
    wg_commit();
    wg_wait<1>();                        // dy_i x_j^T is done
    pin(macc);
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int t = t0 + 8 * rr, s = 64 * j + 8 * jj + cc + e;
          macc[4 * jj + 2 * rr + e] *=
              t >= s ? expf(cum_s[t] - cum_s[s]) * dt_s[s] : 0.f;
        }
    to_a_frags2<64>(macc, mhi, mlo);
    pin(mhi);
    pin(mlo);
#pragma unroll
    for (int hh = 0; hh < NH; ++hh) pin(cacc[hh]);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int hh = 0; hh < NH; ++hh) {
        wgmma_rs(cacc[hh], mhi[kk], desc_mn<NW>(b_s, 64, hh, kk), 1);
        wgmma_rs(cacc[hh], mlo[kk], desc_mn<NW>(b_s, 64, hh, kk), 1);
      }
    wg_commit();
    wg_wait<0>();
    pin(yacc);
#pragma unroll
    for (int hh = 0; hh < NH; ++hh) pin(cacc[hh]);
    pin(shi);
    pin(smid);
    pin(slo);
    pin(mhi);
    pin(mlo);
  }

  // rows t: dy . y and dC
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int tl = t0 + 8 * rr;
    const bool row_on = tl < live;
    float dyy = 0.f;
    if (row_on)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
        if (8 * jj < q.P) {
          const float2 dv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(dyp + tl * sdy.s +
                                                       8 * jj + cc));
          dyy += dv.x * yacc[4 * jj + 2 * rr] +
                 dv.y * yacc[4 * jj + 2 * rr + 1];
        }
    dyy += __shfl_xor_sync(0xffffffffu, dyy, 1);
    dyy += __shfl_xor_sync(0xffffffffu, dyy, 2);
    if (!row_on) continue;
    if ((lane & 3) == 0) dyy_ws[cd + tl] = dyy;
    float* dcp = dC_part +
                 ((static_cast<long long>(b) * q.S + c0 + tl) * q.H + h) * q.N;
#pragma unroll
    for (int hh = 0; hh < NH; ++hh)
#pragma unroll
      for (int jj = 0; jj < LN::kW / 8; ++jj) {
        const int n = hh * LN::kW + 8 * jj + cc;
        if (n < q.N)
          *reinterpret_cast<float2*>(dcp + n) =
              make_float2(cacc[hh][4 * jj + 2 * rr],
                          cacc[hh][4 * jj + 2 * rr + 1]);
      }
  }
}

// Stage 5.  Per (chunk, head, batch row): dcum_t = dy_t . y_t - dt_t x_t .
// g_t, plus <dh_out, h_out> at t = L - 1 (the reverse pass's parts, summed
// in order), its suffix sums R_u = sum_{t>=u} dcum_t, ddt_u = x_u . g_u +
// A R_u (to ddt) and the chunk's part of dA, sum_u dt_u R_u (to dA_part
// (B, nc, H)).  Grid (nc, H, B), 128 threads, two positions each: the
// suffix scan is ssd_state_kernel's prefix scan of cum over the reversed
// chunk.
__global__ void __launch_bounds__(kTcThreads)
ssd_dcum_kernel(const float* __restrict__ dyy_ws,
                const float* __restrict__ xg_ws,
                const float* __restrict__ dt_ws, const float* __restrict__ A,
                const float* __restrict__ part, int nparts,
                float* __restrict__ ddt, float* __restrict__ dA_part, Geo q) {
  __shared__ float warp_tot[kTcThreads / 32];
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int c0 = c * q.L, live = min(q.L, q.S - c0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long bhc = (static_cast<long long>(b) * q.H + h) * q.nc + c;
  const long long cd = bhc * q.LT;
  float carry = 0.f;
  for (int k = 0; k < nparts; ++k) carry += part[bhc * nparts + k];
  // thread tid takes positions u0 = L - 1 - 2 tid and u0 - 1
  auto dcum = [&](int u) {
    float v = 0.f;
    if (u >= 0 && u < live)
      v = dyy_ws[cd + u] - dt_ws[cd + u] * xg_ws[cd + u];
    return u == q.L - 1 ? v + carry : v;
  };
  const int u0 = q.L - 1 - 2 * tid, u1 = u0 - 1;
  const float a0 = dcum(u0), a1 = a0 + dcum(u1);
  float v = a1;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float w = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += w;
  }
  if (lane == 31) warp_tot[warp] = v;
  __syncthreads();
  float base = v - a1;
  for (int w = 0; w < warp; ++w) base += warp_tot[w];
  const float a_h = A[h];
  float da = 0.f;
  const int us[2] = {u0, u1};
  const float rs[2] = {base + a0, base + a1};
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int u = us[k];
    if (u < 0 || u >= live) continue;
    ddt[(static_cast<long long>(b) * q.S + c0 + u) * q.H + h] =
        xg_ws[cd + u] + a_h * rs[k];
    da += dt_ws[cd + u] * rs[k];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) da += __shfl_xor_sync(0xffffffffu, da, o);
  __syncthreads();                       // warp_tot's readers are done
  if (lane == 0) warp_tot[warp] = da;
  __syncthreads();
  if (tid == 0) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kTcThreads / 32; ++w) t += warp_tot[w];
    dA_part[(static_cast<long long>(b) * q.nc + c) * q.H + h] = t;
  }
}

// p: the 23 pointers of repro_ssd_scan_bwd.  Stages 2 to 5 on one stream;
// stage 1 (C B^T, cum, dt, the states) is ssd.cu's repro_ssd_states,
// called by the wrapper just before.
template <int NW>
cudaError_t launch_tc(void* const* p, const long long* sd, Geo q, int B,
                      cudaStream_t stream) {
  const Strides sx{sd[0], sd[1], sd[2]}, sb{sd[6], sd[7], sd[8]},
      sc{sd[9], sd[10], sd[11]}, sdy{sd[12], sd[13], sd[14]};
  const bf16* x = static_cast<const bf16*>(p[0]);
  const float* A = static_cast<const float*>(p[2]);
  const bf16* Bm = static_cast<const bf16*>(p[3]);
  const bf16* C = static_cast<const bf16*>(p[4]);
  const bf16* dy = static_cast<const bf16*>(p[6]);
  const float* dfinal = static_cast<const float*>(p[7]);
  bf16* dx = static_cast<bf16*>(p[8]);
  float* ddt = static_cast<float*>(p[9]);
  float* dA_part = static_cast<float*>(p[10]);
  float* dB_part = static_cast<float*>(p[11]);
  float* dC_part = static_cast<float*>(p[12]);
  float* dinit = static_cast<float*>(p[13]);
  const float* states = static_cast<const float*>(p[14]);
  const float* cb = static_cast<const float*>(p[15]);
  const float* cum = static_cast<const float*>(p[16]);
  const float* dtw = static_cast<const float*>(p[17]);
  const float* fin = static_cast<const float*>(p[18]);
  float* dstates = static_cast<float*>(p[19]);
  float* dyy = static_cast<float*>(p[20]);
  float* xg = static_cast<float*>(p[21]);
  float* part = static_cast<float*>(p[22]);
  const int nparts = (q.P * q.N + 255) / 256;
  const int smem_ds = 64 * 64 * 2 + 2 * 64 * NW * 2 + q.LT * 4 + 1024;
  const int smem_kq = 4 * 64 * NW * 2 + 2 * 64 * 64 * 2 + 2 * q.LT * 4 + 1024;
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(ssd_dstate_kernel<NW>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  smem_ds)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(ssd_bwd_key_kernel<NW>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  smem_kq)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(ssd_bwd_query_kernel<NW>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  smem_kq)) != cudaSuccess)
    return err;
  ssd_dstate_kernel<NW><<<dim3(q.nc, q.H, B), kTcThreads, smem_ds, stream>>>(
      dy, C, cum, dstates, sdy, sc, q);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_dpass_kernel<<<dim3(nparts, q.H, B), 256, 0, stream>>>(
      dstates, states, fin, cum, dfinal, dinit, part, q);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_key_kernel<NW><<<dim3(q.LT / 64, q.H, q.nc * B), kTcThreads,
                           smem_kq, stream>>>(
      x, Bm, C, dy, cb, dstates, cum, dtw, dx, dB_part, xg, sx, sb, sc, sdy,
      q);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_query_kernel<NW><<<dim3(q.LT / 64, q.H, q.nc * B), kTcThreads,
                             smem_kq, stream>>>(
      x, Bm, C, dy, cb, states, cum, dtw, dC_part, dyy, sx, sb, sc, sdy, q);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_dcum_kernel<<<dim3(q.nc, q.H, B), kTcThreads, 0, stream>>>(
      dyy, xg, dtw, A, part, nparts, ddt, dA_part, q);
  return cudaGetLastError();
}

}  // namespace

// ptrs: device pointers, in order x, dt, A, Bm, C, init (may be null), dy,
// dfinal (may be null), dx, ddt, dA_part, dB_part, dC_part, dinit, then
// the workspaces (float32).  dtype 0 = float32 (ssd_bwd_kernel): 15
// pointers, the last hin (B nc H P N).  dtype 1 = bfloat16 (x, Bm, C, dy
// and dx; stages 2-5 on wgmma): 23 pointers, the last nine the states
// entering each chunk (B nc H P N), cb (B nc G LT LT), cum and dt (B H nc
// LT each), as ssd.cu's repro_ssd_states left them on this stream, the
// final state (B H P N), dstates (B nc H P N), dyy and xg (B H nc LT
// each) and part (B H nc ceil(P N / 256)); dA_part is (B, nc, H) there,
// (B, H) for float32.  strides: 15 int64 element strides, (b, s, head) of
// x, dt and dy and (b, s, group) of Bm and C, in the order x, dt, Bm, C,
// dy.  (P, N) is one of (64, 128), (64, 64), (64, 32), (32, 16); L one of
// 32, 64, 128, 256.  Returns the launches' cudaError_t (0 on success); the
// Python wrapper checks shapes, dtypes and devices before the call and
// raises on a non-zero return.
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
  const bool shape = (P == 64 && (N == 128 || N == 64 || N == 32)) ||
                     (P == 32 && N == 16);
  const int nc = (S + L - 1) / L;
  if (dtype != 1 || !shape || static_cast<long long>(nc) * B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Geo q{S, H, G, P, N, L, (L + 63) / 64 * 64, nc};
  if (N <= 32)
    return static_cast<int>(launch_tc<32>(ptrs, strides, q, B, s));
  if (N <= 64)
    return static_cast<int>(launch_tc<64>(ptrs, strides, q, B, s));
  return static_cast<int>(launch_tc<128>(ptrs, strides, q, B, s));
}
