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
// Design (first version: simple and right).  One block of 256 threads per
// (head, batch row) walks the chunks in order, as the TPU grid's sequential
// chunk axis did; the float32 (P, N) state lives in shared memory for the
// whole walk and goes to device memory once, at the end.  A chunk is cut
// into BT-row tiles (BT = 64, or 32 when L = 32) so that no L x L matrix is
// ever held: for query tile i the block stages C_i, adds the off-diagonal
// term from the state, then for each key tile j <= i stages B_j and x_j
// (transposed), forms the BT x BT scores C_i B_j^T in registers, applies
// the decay only where i >= j (for j > i the exponent is positive and
// could overflow to inf, and inf * 0 would be NaN where the reference's
// jnp.where gives 0), stages them, and accumulates scores . x_j.  The last
// query tile visits every key tile, so it also accumulates the state
// update from the tiles it has staged.  Positions at or past S are read as
// dt = 0 and x = B = C = 0 (exact: identity decay, no input) and their y
// is not written, so a ragged S needs no padded copy.  Every product is a
// 16 x 16 thread grid of register tiles fed by 16-byte shared-memory reads
// (rows padded by 4 floats, so eight neighbouring threads hit 32 distinct
// banks), in float32 FMA on the CUDA cores for both input types.
//
// Shared memory at the main shape (L 256, BT 64, P 64, N 128): state,
// C_i and B_j tiles 3 x 64 x 132 floats, x_j^T and the score tile
// 2 x 64 x 68, cum, dt and the state weights 3 x 256: 139,264 bytes, so
// one block per SM.  ptxas (CUDA 12.8) gives that instance 206 registers
// and no spill; four of the other instances are held to 128 registers and
// spill 8-128 bytes.  chip_smoke.py prints the report for every instance.
//
// What bounds it on an H100: at the main prefill shape (B 8, S 2048, H 64,
// P 64, N 128, L 256, bf16) the visible work is 86 GFLOP (the lower
// triangles of the two L x L products and the two state products) and the
// least traffic 298 MB (x and y in bf16, B, C, dt, the float32 state),
// which take about the same time at 989 TFLOP/s and 3.35 TB/s.  This
// kernel runs on the CUDA cores, so it stays far above that bound: a
// tensor-core (wgmma) version and a chunk-parallel split of the scan
// (the state passing between chunks is the only serial part) are later
// work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;   // a 16 x 16 grid: row group, column group
constexpr int kPad = 4;         // floats of padding per shared row
constexpr int kMaxChunk = 256;  // one scan element per thread

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

}  // namespace

// strides: 12 int64 element strides, (b, s, head) of x and dt and
// (b, s, group) of Bm and C, in that order.  init may be null (zeros).
// (P, N) is one of (64, 128), (64, 64), (64, 32), (32, 16); L one of 32,
// 64, 128, 256.  dtype: 0 = float32, 1 = bfloat16 (x, Bm, C and y).
// Returns the launch's cudaError_t (0 on success); the Python wrapper
// checks shapes, dtypes and devices before the call and raises on a
// non-zero return.
extern "C" int repro_ssd_scan(const void* x, const void* dt, const void* A,
                              const void* Bm, const void* C,
                              const void* init, void* y, void* st,
                              const long long* strides, int B, int S, int H,
                              int G, int P, int N, int L, int dtype,
                              void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G != 0 || B > 65535 ||
      (L != 32 && L != 64 && L != 128 && L != kMaxChunk))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();  // the code returned below belongs to this call
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(launch_t<float>(P, N, x, dt, A, Bm, C, init, y,
                                            st, strides, B, S, H, G, L, s));
  if (dtype == 1)
    return static_cast<int>(launch_t<__nv_bfloat16>(
        P, N, x, dt, A, Bm, C, init, y, st, strides, B, S, H, G, L, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
