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
// 64 or 128): the 16-byte chunks at or past d are never loaded or stored.
// The G = H / K query heads of KV head kh are heads kh*G .. kh*G+G-1 (the
// reference reshapes q to (B, K, G, D)).  Positions at or past lens[b] are
// masked; a page whose table entry is -1 (or >= P) is skipped without being
// read (the TPU kernel fetched page 0 in its place and masked it).  The
// softmax runs online in float32 with scale 1/sqrt(d) unless the caller
// gives one; a row with no valid position writes exactly 0.
//
// What bounds it on the card: the bytes of K and V it must read,
// sum_b lens[b] * K * d * 2 * sizeof(T), over 3.35 TB/s (a few MB at decode
// sizes: microseconds).  Its arithmetic, 4 * H * d flops per cached token,
// is far below any compute line, so the design is about keeping enough
// bytes in flight and every lane busy, not about the tensor cores.
//
// Design.  One block of 128 threads per (row b, KV head kh, run of
// `pps` pages of the row), holding all the group's query heads (up to GB =
// 4 or 8 of them; more heads take more blocks along y), so K and V are read
// once per (b, kh, split).  The block
//   1. copies its slice of the table row into shared memory with 4-byte
//      cp.async while it reads lens[b] and q; a split past the row's last
//      valid page exits there, before it touches K or V;
//   2. streams the split's tokens in tiles of kTile = 32 (two pages of 16,
//      or part of a larger page) through a ring of `stages` slots in shared
//      memory with 16-byte cp.async.cg copies, kept in T (not converted at
//      staging), with stages - 1 tiles in flight ahead of the one scored.
//      An unread token, and a chunk past d, lands as zeros (a copy of
//      source size 0), and each slot's page cursor steps without a
//      division, so the scoring loops below have no branch;
//   3. scores with a group of CH = D * sizeof(T) / 16 lanes per token, each
//      lane holding 16 bytes of q and k (8 bf16, or 4 float, elements): the
//      dot product is a shuffle reduction over the CH lanes, so a warp takes
//      32 / CH tokens at once (4 at D 64 bf16) and no lane idles at page 16.
//      Each lane copies exactly the chunks it later reads, so the ring
//      needs no block barrier: cp.async.wait_group orders a thread's own
//      copies before its reads.
//   4. keeps, per token group and query head, the running max and sum and
//      the group's share of the output accumulator in float32 registers,
//      taking the max once per tile (over the group's tokens of the tile);
//      P . V runs in float32 FMA with P unrounded;
//   5. merges the token groups (shuffles within a warp, shared memory across
//      the four warps) into the split's (max, sum, accumulator).
// A row whose valid pages fit one split is written directly.  Otherwise each
// split writes its partial state to a float32 workspace and the last of the
// row's blocks to finish merges them (an int32 arrival counter per (b, head
// block), reset to 0 by that last block): one launch, no second kernel,
// which measured 2.6-3.6 us slower at the decode shape (PERF.md).  Scores
// are kept in log2 units (q is pre-scaled by scale * log2(e)), so every
// exponential is one ex2.approx.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <cstring>

namespace {

constexpr int kThreads = 128;            // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;                // tokens per ring slot
constexpr int kMaxStages = 6;
constexpr int kMaxSplitPages = 1024;     // the table slice in shared memory
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// ------------------------------------------------------------ cp.async
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes from src, or (n = 0) 16 zero bytes with nothing read
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// wait_group takes an immediate: the ring depth is a launch argument
__device__ __forceinline__ void cp_wait_dyn(int n) {
  switch (n) {
    case 0: cp_wait<0>(); break;
    case 1: cp_wait<1>(); break;
    case 2: cp_wait<2>(); break;
    case 3: cp_wait<3>(); break;
    case 4: cp_wait<4>(); break;
    default: cp_wait<5>(); break;
  }
}

// 2^x in one MUFU instruction (denormal results flush to 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ------------------------------------------------- 16 bytes <-> floats
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void load(const uint4& u, float (&f)[4]) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  __device__ static uint4 pack(const float (&f)[4]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const uint4& u, float (&f)[8]) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      __nv_bfloat162 h;
      memcpy(&h, &w[i], 4);
      const float2 x = __bfloat1622float2(h);
      f[2 * i] = x.x;
      f[2 * i + 1] = x.y;
    }
  }
  __device__ static uint4 pack(const float (&f)[8]) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      memcpy(&w[i], &h, 4);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// Valid pages of row b and the splits that hold them (uniform per row).
__device__ __forceinline__ int active_splits(int len, int page, int maxp,
                                             int pps) {
  const int pages = len > 0 ? min((len + page - 1) / page, maxp) : 0;
  return (pages + pps - 1) / pps;
}

// Workspace: per (b, h, split) the unnormalised accumulator, d floats, then
// after all of them the partial (max, sum) as a float2.
struct Workspace {
  float2* ml;
  float* acc;
  __device__ Workspace(float* ws, int rows, int splits, int d)
      : ml(reinterpret_cast<float2*>(ws + static_cast<size_t>(rows) * splits *
                                              d)),
        acc(ws) {}
};

// Merge the `active` partial states of output row `r` = b * H + h, 16-byte
// chunk `cc` of d, and store it.  Splits that saw no valid token have
// l = 0 and m = -1e30 and weigh nothing; a row with none writes 0.  The
// partials are read kBatch at a time, all loads of a batch in flight
// together, and merged with a running max.
constexpr int kBatch = 8;
template <typename T>
__device__ __forceinline__ void combine_chunk(const Workspace& w, T* out,
                                              int r, int cc, int splits,
                                              int active, int d) {
  constexpr int VEC = Vec<T>::N;
  const float2* ml = w.ml + static_cast<size_t>(r) * splits;
  const float* base = w.acc + static_cast<size_t>(r) * splits * d + cc * VEC;
  float mx = kNegInf, l = 0.f, acc[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
  for (int s0 = 0; s0 < active; s0 += kBatch) {
    float2 p[kBatch];
    float4 a[kBatch][VEC / 4];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const bool in = s0 + j < active;
      p[j] = in ? __ldcg(&ml[s0 + j]) : make_float2(kNegInf, 0.f);
      const float4* src =
          reinterpret_cast<const float4*>(base + static_cast<size_t>(s0 + j) *
                                                     d);
#pragma unroll
      for (int e4 = 0; e4 < VEC / 4; ++e4)
        a[j][e4] = in ? __ldcg(&src[e4]) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    float mb = mx;
#pragma unroll
    for (int j = 0; j < kBatch; ++j) mb = fmaxf(mb, p[j].x);
    const float alpha = exp2_approx(mx - mb);
    l *= alpha;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] *= alpha;
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const float c = exp2_approx(p[j].x - mb);
      l += c * p[j].y;
#pragma unroll
      for (int e4 = 0; e4 < VEC / 4; ++e4) {
        acc[4 * e4] += c * a[j][e4].x;
        acc[4 * e4 + 1] += c * a[j][e4].y;
        acc[4 * e4 + 2] += c * a[j][e4].z;
        acc[4 * e4 + 3] += c * a[j][e4].w;
      }
    }
    mx = mb;
  }
  const float inv = l > 0.f ? 1.f / l : 0.f;
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] *= inv;
  *reinterpret_cast<uint4*>(out + static_cast<size_t>(r) * d + cc * VEC) =
      Vec<T>::pack(acc);
}

template <typename T, int D, int GB>
__global__ void __launch_bounds__(kThreads)
pa_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                 const T* __restrict__ v_pages,
                 const int* __restrict__ tables,
                 const int* __restrict__ lens, T* __restrict__ out,
                 float* __restrict__ ws, int* __restrict__ counters, int H,
                 int K, int G, int P, int page, int maxp, int pps,
                 int stages, int d, float qscale) {
  constexpr int VEC = Vec<T>::N;         // elements per 16-byte chunk
  constexpr int CH = D / VEC;            // lanes per token
  constexpr int TPP = kThreads / CH;     // tokens per pass of the block
  constexpr int NK = kTile / TPP;        // token slots per thread per tile
  static_assert(CH <= 32 && 32 % CH == 0 && kTile % TPP == 0, "shape");

  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int s_last;
  int* tab_s = reinterpret_cast<int*>(smem);
  uint8_t* body = smem + ((pps * 4 + 15) & ~15);
  uint4* ring = reinterpret_cast<uint4*>(body);   // [stage][K|V][kTile][CH]
  float* red_acc = reinterpret_cast<float*>(body);  // after the loop:
  float* red_m = red_acc + kWarps * GB * D;         // [warp][head][D], m, l
  float* red_l = red_m + kWarps * GB;

  const int b = blockIdx.x;
  const int hblocks = gridDim.y / K;
  const int kh = blockIdx.y / hblocks;
  const int g0 = (blockIdx.y % hblocks) * GB;    // first head of the block
  const int gn = min(GB, G - g0);                // heads in the block
  const int z = blockIdx.z;
  const int splits = gridDim.z;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int grp = tid / CH;                      // token slot in a pass
  const int c = tid % CH;                        // 16-byte chunk of d
  const int dch = d / VEC;                       // chunks of the real d
  const bool col = c < dch;
  const int rows = gridDim.x * H;
  const int h0 = kh * G + g0;

  // 1. the table slice, lens[b] and q: independent loads, all in flight
  const int first = z * pps;
  const int np = min(pps, maxp - first);
  const int* trow = tables + static_cast<size_t>(b) * maxp + first;
  for (int i = tid; i < np; i += kThreads) cp_async4(&tab_s[i], trow + i);
  cp_commit();
  const int len = lens[b];
  float qf[GB][VEC];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    float f[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) f[e] = 0.f;
    if (g < gn && col)
      Vec<T>::load(*reinterpret_cast<const uint4*>(
                       q + (static_cast<size_t>(b) * H + h0 + g) * d +
                       c * VEC),
                   f);
#pragma unroll
    for (int e = 0; e < VEC; ++e) qf[g][e] = f[e] * qscale;
  }
  const int active = active_splits(len, page, maxp, pps);
  if (z >= active) {                             // no valid token here
    cp_wait<0>();
    if (z == 0) {                                // empty row: exactly 0
      float zero[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) zero[e] = 0.f;
      for (int i = tid; i < gn * dch; i += kThreads)
        *reinterpret_cast<uint4*>(
            out + (static_cast<size_t>(b) * H + h0 + i / dch) * d +
            (i % dch) * VEC) = Vec<T>::pack(zero);
    }
    return;
  }
  cp_wait<0>();
  __syncthreads();                               // the slice is visible

  // 2-4. the ring over the split's tokens [t0, t0 + n_tok)
  const int t0 = first * page;
  const int n_tok = min(len, (first + np) * page) - t0;
  const int n_tiles = (n_tok + kTile - 1) / kTile;
  const size_t tok = static_cast<size_t>(K) * d;   // stride between tokens
  const size_t page_stride = tok * page;
  const size_t col_off = static_cast<size_t>(kh) * d + c * VEC;
  // Issue cursor of each token slot: the page (within the split) and the
  // offset in it of the slot's token in the next tile to issue, stepped by
  // kTile tokens a tile without a division.
  const int step_pages = kTile / page, step_off = kTile % page;
  int ipg[NK], ioff[NK];
#pragma unroll
  for (int sl = 0; sl < NK; ++sl) {
    ipg[sl] = (grp + sl * TPP) / page;
    ioff[sl] = (grp + sl * TPP) % page;
  }
  // Which slots hold a token that is read, NK bits a tile for the tiles in
  // flight, the tile to compute next in the low bits.
  uint64_t okbits = 0;
  int islot = 0, cslot = 0;                      // ring slots
  auto issue = [&](int tile, int ahead) {
    if (tile < n_tiles) {
      uint4* ks = ring + static_cast<size_t>(islot) * 2 * kTile * CH;
      uint4* vs = ks + kTile * CH;
      uint32_t bits = 0;
#pragma unroll
      for (int sl = 0; sl < NK; ++sl) {
        const int i = grp + sl * TPP;
        int pp = tile * kTile + i < n_tok ? tab_s[ipg[sl]] : -1;
        pp = pp < P ? pp : -1;                   // -1 or past the pool
        bits |= static_cast<uint32_t>(pp >= 0) << sl;
        // an unread token (and a chunk past d) lands as zeros
        const size_t off = pp >= 0 && col
                               ? pp * page_stride + ioff[sl] * tok + col_off
                               : 0;
        const int n = pp >= 0 && col ? 16 : 0;
        cp_async16(&ks[i * CH + c], k_pages + off, n);
        cp_async16(&vs[i * CH + c], v_pages + off, n);
        ioff[sl] += step_off;
        ipg[sl] += step_pages;
        if (ioff[sl] >= page) {
          ioff[sl] -= page;
          ++ipg[sl];
        }
      }
      okbits |= static_cast<uint64_t>(bits) << (ahead * NK);
      islot = islot + 1 == stages ? 0 : islot + 1;
    }
    cp_commit();                                 // empty groups keep count
  };

  // Every loop below runs over all GB heads and NK token slots without a
  // branch (a head past the group has q = 0 and is never stored; an unread
  // token has zero K and V and P = 0), so the compiler interleaves their
  // independent chains: one dot product's shuffles hide behind the others'.
  float m[GB], l[GB], acc[GB][VEC];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[g][e] = 0.f;
  }
  for (int t = 0; t < stages - 1; ++t) issue(t, t);
  for (int t = 0; t < n_tiles; ++t) {
    issue(t + stages - 1, stages - 1);  // the slot read at tile t - 1
    cp_wait_dyn(stages - 1);    // this thread's copies of tile t are in
    const uint4* ks = ring + static_cast<size_t>(cslot) * 2 * kTile * CH;
    const uint4* vs = ks + kTile * CH;
    cslot = cslot + 1 == stages ? 0 : cslot + 1;
    const uint32_t bits = static_cast<uint32_t>(okbits);
    okbits >>= NK;
    float kf[NK][VEC], s[NK][GB];
#pragma unroll
    for (int sl = 0; sl < NK; ++sl)
      Vec<T>::load(ks[(grp + sl * TPP) * CH + c], kf[sl]);
#pragma unroll
    for (int sl = 0; sl < NK; ++sl)
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        float d0 = 0.f, d1 = 0.f;
#pragma unroll
        for (int e = 0; e < VEC; e += 2) {
          d0 = fmaf(qf[g][e], kf[sl][e], d0);
          d1 = fmaf(qf[g][e + 1], kf[sl][e + 1], d1);
        }
        s[sl][g] = d0 + d1;
      }
#pragma unroll
    for (int o = CH / 2; o > 0; o >>= 1)
#pragma unroll
      for (int sl = 0; sl < NK; ++sl)
#pragma unroll
        for (int g = 0; g < GB; ++g)
          s[sl][g] += __shfl_xor_sync(0xffffffffu, s[sl][g], o);
    // the max once per tile: over this group's tokens of the tile
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      float mt = kNegInf;
#pragma unroll
      for (int sl = 0; sl < NK; ++sl)
        mt = fmaxf(mt, bits >> sl & 1 ? s[sl][g] : kNegInf);
      const float mn = fmaxf(m[g], mt);
      const float alpha = exp2_approx(m[g] - mn);
      m[g] = mn;
      l[g] *= alpha;
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[g][e] *= alpha;
    }
#pragma unroll
    for (int sl = 0; sl < NK; ++sl) {
      float vf[VEC];
      Vec<T>::load(vs[(grp + sl * TPP) * CH + c], vf);
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        const float p = bits >> sl & 1 ? exp2_approx(s[sl][g] - m[g]) : 0.f;
        l[g] += p;
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[g][e] = fmaf(p, vf[e], acc[g][e]);
      }
    }
  }
  cp_wait<0>();

  // 5. merge the token groups: within the warp by shuffles ...
#pragma unroll
  for (int o = CH; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], o);
      const float lo = __shfl_xor_sync(0xffffffffu, l[g], o);
      const float mn = fmaxf(m[g], mo);
      const float a = exp2_approx(m[g] - mn), bo = exp2_approx(mo - mn);
      l[g] = l[g] * a + lo * bo;
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        acc[g][e] = acc[g][e] * a +
                    __shfl_xor_sync(0xffffffffu, acc[g][e], o) * bo;
      m[g] = mn;
    }
  }
  __syncthreads();                               // every ring read is done
  // ... then across the warps through shared memory (over the ring)
  const int warp = tid / 32;
  if (lane < CH) {
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      if (col)
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          red_acc[(warp * GB + g) * D + c * VEC + e] = acc[g][e];
      if (c == 0) {
        red_m[warp * GB + g] = m[g];
        red_l[warp * GB + g] = l[g];
      }
    }
  }
  __syncthreads();
  const bool single = active == 1;
  const Workspace w(ws, rows, splits, d);
  for (int i = tid; i < gn * dch; i += kThreads) {
    const int g = i / dch, cc = i % dch;
    float mx = kNegInf;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) mx = fmaxf(mx, red_m[wi * GB + g]);
    float lsum = 0.f, a[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) a[e] = 0.f;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) {
      const float f = exp2_approx(red_m[wi * GB + g] - mx);
      lsum += f * red_l[wi * GB + g];
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        a[e] += f * red_acc[(wi * GB + g) * D + cc * VEC + e];
    }
    const int r = b * H + h0 + g;
    if (single) {
      const float inv = lsum > 0.f ? 1.f / lsum : 0.f;
#pragma unroll
      for (int e = 0; e < VEC; ++e) a[e] *= inv;
      *reinterpret_cast<uint4*>(out + static_cast<size_t>(r) * d +
                                cc * VEC) = Vec<T>::pack(a);
    } else {
      float4* dst = reinterpret_cast<float4*>(
          w.acc + (static_cast<size_t>(r) * splits + z) * d + cc * VEC);
#pragma unroll
      for (int e4 = 0; e4 < VEC / 4; ++e4)
        dst[e4] = make_float4(a[4 * e4], a[4 * e4 + 1], a[4 * e4 + 2],
                              a[4 * e4 + 3]);
      if (cc == 0) w.ml[static_cast<size_t>(r) * splits + z] =
          make_float2(mx, lsum);
    }
  }
  if (single) return;

  // the row's last split to finish merges all of them
  __threadfence();
  __syncthreads();
  int* cnt = counters + static_cast<size_t>(b) * gridDim.y + blockIdx.y;
  if (tid == 0) {
    const int before = atomicAdd(cnt, 1);
    s_last = before == active - 1;
    if (s_last) *cnt = 0;                        // ready for the next launch
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int i = tid; i < gn * dch; i += kThreads)
    combine_chunk<T>(w, out, b * H + h0 + i / dch, i % dch, splits, active,
                     d);
}

template <typename T, int D, int GB>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* tables, const void* lens, void* out, void* ws,
                   void* counters, int B, int H, int K, int P, int page,
                   int maxp, int pps, int splits, int stages, int d,
                   float scale, cudaStream_t stream) {
  const int G = H / K;
  const int hblocks = (G + GB - 1) / GB;
  const size_t ring = static_cast<size_t>(stages) * 2 * kTile * D * sizeof(T);
  const size_t red = static_cast<size_t>(kWarps) * GB * (D + 2) * 4;
  const size_t smem = ((pps * 4 + 15) & ~15) + (ring > red ? ring : red);
  if (smem > (48 << 10)) {      // above the default dynamic limit
    static size_t allowed[64] = {};  // per device
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev >= 64 || smem > allowed[dev]) {
      err = cudaFuncSetAttribute(pa_decode_kernel<T, D, GB>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err != cudaSuccess) return err;
      if (dev < 64) allowed[dev] = smem;
    }
  }
  dim3 grid(B, K * hblocks, splits);
  pa_decode_kernel<T, D, GB><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(tables),
      static_cast<const int*>(lens), static_cast<T*>(out),
      static_cast<float*>(ws), static_cast<int*>(counters), H, K, G, P, page,
      maxp, pps, stages, d, scale * kLog2e);
  return cudaGetLastError();
}

// d runs on the next built width (32, 64 or 128); bf16 holds up to 4 query
// heads a block when G <= 4, else 8; float32 (the parity runs) always 8.
template <typename T, int GB>
cudaError_t launch_d(int d, const void* q, const void* k, const void* v,
                     const void* tables, const void* lens, void* out,
                     void* ws, void* counters, int B, int H, int K, int P,
                     int page, int maxp, int pps, int splits, int stages,
                     float scale, cudaStream_t stream) {
#define REPRO_PA_ARGS q, k, v, tables, lens, out, ws, counters, B, H, K, P, \
                      page, maxp, pps, splits, stages, d, scale, stream
  if (d <= 0 || d % 8 != 0 || d > 128) return cudaErrorInvalidValue;
  if (d <= 32) return launch<T, 32, GB>(REPRO_PA_ARGS);
  if (d <= 64) return launch<T, 64, GB>(REPRO_PA_ARGS);
  return launch<T, 128, GB>(REPRO_PA_ARGS);
#undef REPRO_PA_ARGS
}

}  // namespace

// D: the head dim, any multiple of 8 up to 128.  dtype: 0 = float32, 1 =
// bfloat16.  Each row's maxp pages are cut into splits = ceil(maxp / pps)
// runs of pps pages (pps <= 1024), scored through a ring of `stages`
// (1..6) tiles.  With splits > 1, ws is a float32 workspace of
// B * H * splits * (D + 2) elements and counters holds B * K * ceil(G / GB)
// int32 zeros (GB: 4 for bf16 with G <= 4, else 8), which each launch
// leaves at zero.  q, k, v and out must be 16-byte
// aligned.  Returns the launches' cudaError_t (0 on success); the Python
// wrapper raises on anything else.  Shapes, dtypes, alignment and
// contiguity are checked by the wrapper before the call.
extern "C" int repro_paged_attention(const void* q, const void* k,
                                     const void* v, const void* tables,
                                     const void* lens, void* out, void* ws,
                                     void* counters, int B, int H, int K,
                                     int D, int P, int page, int maxp,
                                     int pps, int splits, int stages,
                                     float scale, int dtype,
                                     void* stream) {
  if (B <= 0 || K <= 0 || H % K != 0 || page <= 0 || maxp <= 0 || pps <= 0 ||
      pps > kMaxSplitPages || splits != (maxp + pps - 1) / pps ||
      stages < 1 || stages > kMaxStages ||
      (splits > 1 && (ws == nullptr || counters == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();  // the code returned below belongs to this call
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
#define REPRO_PA_ARGS D, q, k, v, tables, lens, out, ws, counters, B, H, K, \
                      P, page, maxp, pps, splits, stages, scale, s
  if (dtype == 0)
    err = launch_d<float, 8>(REPRO_PA_ARGS);
  else if (dtype == 1 && H / K <= 4)
    err = launch_d<__nv_bfloat16, 4>(REPRO_PA_ARGS);
  else if (dtype == 1)
    err = launch_d<__nv_bfloat16, 8>(REPRO_PA_ARGS);
  else
    err = cudaErrorInvalidValue;
#undef REPRO_PA_ARGS
  return static_cast<int>(err);
}
