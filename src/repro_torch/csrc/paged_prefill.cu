// Paged prefill attention for Hopper (sm_90a), bound through a plain C entry.
//
// Replaces no TPU kernel.  The reference computes the attention of chunked
// and batched paged prefill as plain jnp.einsum (src/repro/serve/
// paged_model.py, no pallas_call): every row gathers its whole block table
// of maxp pages, masks, and runs a dense softmax over all maxp * page
// positions.  On the card that was float32 einsums and about ten float32
// passes over (N, K, G, T, maxp * page) scores, most of them masked out.
// This kernel computes the same attention, under the same mask, from the
// pages themselves.
//
//   q         (N, T, H, d)       T_, contiguous, after RoPE
//   k, v      (P, page, K, d)    T_, contiguous (one layer's pool view)
//   tables    (N, maxp)          int32 page ids; < 0 or >= P: unmapped
//   q_starts  (N,)               int32 absolute position of query 0
//   q_lens    (N,)               int32 real queries of the row
//   o         (N, T, H, d)       T_, contiguous
//
// Key j is visible to query t of row n iff j < q_starts[n] + q_lens[n],
// j <= q_starts[n] + t and tables[n, j / page] is a page of the pool.
// Queries at or past q_lens[n] follow the same rule (the MoE FFN routes
// them, so their outputs must be the plain version's); a query with no
// visible key writes exactly 0: masked scores are -inf and the running max
// starts at -1e30, so their weights are exactly 0 and the sum stays 0.
// Query head h reads KV head h / (H / K).  Any head dim d <= 128 that is a
// multiple of 8 runs on the next built width D (32, 64 or 128) with zero
// columns that are never stored.
//
// What bounds it on an H100: its arithmetic, 4 * d flops for every visible
// (query, key) pair and query head, over the tensor cores' 989 TFLOP/s in
// bf16 (h2o-danube's 512-query chunk at position ~2,000: ~17 GFLOP a row
// and layer, ~17 us); the bytes (q, each visible page once per query head,
// mostly from L2, and o) are far below that line.  Each block walks its own
// row's pages only up to the last key its queries can see, so the keys past
// a row's length, and padding rows, cost nothing.  Two kernels, chosen by
// dtype:
//
// pp_fwd_wgmma_kernel (bf16).  fa_fwd_wgmma_kernel's design
// (flash_attention.cu): one block per (query tile of 128 rows, query head,
// row), the heaviest causal tiles of each (head, row) launched first, of
// 384 threads: two consumer warpgroups of 64 query rows and a producer
// warpgroup that gives most of its registers to them (setmaxnreg).  The
// producer's first thread loads the q tile once by TMA, then for each
// 64-key tile reads the row's page ids from the block table and issues one
// TMA box per run of gcd(page, 64) keys (a page of 16 is one box; a tile
// is four pages) over the pool view's tensor map (d, token in page, KV
// head, slot), into a two-stage ring paced by mbarriers.  An unmapped page,
// or keys past the row's length, are given the slot -1: TMA fills the box
// with zeros without reading memory, and the tile's mask word (one bit a
// key: mapped and before the row's length), written to shared memory
// before the tile's barrier is released, tells the consumers.  Each
// consumer computes S = q K^T with wgmma (float32 accumulator), runs the
// online softmax on the accumulator fragment in registers, masks only the
// tiles that straddle the diagonal, the row's length or an unmapped page,
// rounds P to bf16 as the register A operand of O += P V (V read MN-major)
// and rescales O by alpha.  One block per query head, not per GQA group:
// a group's four heads read the same pages, which the second to fourth
// read from L2 (a row's K and V of one layer at 2,000 keys is ~8 MB), and
// a group-packed block would hold four times the accumulators.  Shared
// memory: 96 KB at D 128, 48 KB at D 64, 24 KB at D 32; one block per SM.
//
// pp_fwd_kernel (float32).  fa_fwd_kernel's design: float32 FMA on the CUDA
// cores, because a float32 input is held to atol 2e-5, which TF32 products
// cannot meet.  One block per (64 query rows, query head, row) stages its q
// tile once, then for each 64-key tile the keys' pool offsets (-1 where
// unmapped or past the row's length), then K and V as float in shared
// memory (zeros where the offset is -1); each thread scores 16 keys of its
// row, the row's four threads reduce max and sum with shuffles, P goes
// through shared memory, and each thread accumulates D / 4 output columns.
#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using namespace repro_fa;

// -inf: a masked score's exponential is exactly 0 even where the row's
// running max is still the initial -1e30.
__device__ __forceinline__ float neg_inf() {
  return -__int_as_float(0x7f800000);
}

// The keys a row's queries may see: [0, q_start + q_len), within its table.
__device__ __forceinline__ int kv_extent(int q_start, int q_len, int cap) {
  return max(0, min(q_start + max(q_len, 0), cap));
}

__device__ __forceinline__ bool mapped(int id, int n_pages) {
  return id >= 0 && id < n_pages;
}

// ------------------------------------------------ float32: FMA, paged rows
// Element offset of key `key` of KV head kh in the pool, or -1 where its
// page is unmapped or the key lies at or past kv_len.
__device__ __forceinline__ long long key_offset(const int* table, int key,
                                                int kv_len, int page,
                                                int n_pages, int K, int kh,
                                                int d) {
  if (key >= kv_len) return -1;
  const int id = table[key / page];
  if (!mapped(id, n_pages)) return -1;
  return ((static_cast<long long>(id) * page + key % page) * K + kh) * d;
}

// Stage the 64 keys whose offsets are in off_s into dst (64 rows of D +
// kPad floats): zeros for an offset of -1 and for columns at or past d.
template <int D>
__device__ __forceinline__ void load_keys(float* dst, const float* pool,
                                          const long long* off_s, int d) {
  constexpr int kV = D / 4;
  for (int i = threadIdx.x; i < kBK * kV; i += kThreads) {
    const int r = i / kV, c = (i % kV) * 4;
    const long long off = off_s[r];
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (off >= 0 && c < d) x = load4(pool + off + c);
    store4(dst + r * (D + kPad) + c, x);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
pp_fwd_kernel(const float* __restrict__ q, const float* __restrict__ kpool,
              const float* __restrict__ vpool, const int* __restrict__ tables,
              const int* __restrict__ q_starts,
              const int* __restrict__ q_lens, float* __restrict__ o, int T,
              int H, int G, int K, int d, int n_pages, int page, int maxp,
              float scale) {
  constexpr int LD = D + kPad;
  constexpr int PLD = kBK + kPad;
  constexpr int kOut = D / 16;             // float4 output chunks per thread
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  float* k_s = q_s + kBQ * LD;
  float* v_s = k_s + kBK * LD;
  float* p_s = v_s + kBK * LD;
  long long* off_s = reinterpret_cast<long long*>(p_s + kBQ * PLD);

  const int t0 = blockIdx.x * kBQ;
  const int h = blockIdx.y, n = blockIdx.z, kh = h / G;
  const int tid = threadIdx.x, r = tid >> 2, sub = tid & 3;
  const int t = t0 + r;
  const int q_start = q_starts[n];
  const int kv_len = kv_extent(q_start, q_lens[n], page * maxp);
  const int* table = tables + static_cast<long long>(n) * maxp;
  const long long q_row = static_cast<long long>(H) * d;
  const long long base = static_cast<long long>(n) * T * q_row + h * d;

  load_tile<float, D>(q_s, q + base, q_row, t0, T, d);

  float m = kNegInf, l = 0.f;
  float acc[4 * kOut];
#pragma unroll
  for (int i = 0; i < 4 * kOut; ++i) acc[i] = 0.f;

  const int k_end = min(kv_len, q_start + t0 + kBQ);
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();                       // last tile's readers are done
    if (tid < kBK)
      off_s[tid] = key_offset(table, k0 + tid, kv_len, page, n_pages, K, kh,
                              d);
    __syncthreads();
    load_keys<D>(k_s, kpool, off_s, d);
    load_keys<D>(v_s, vpool, off_s, d);
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
      const int col = sub + 4 * j;
      s[j] = off_s[col] >= 0 && k0 + col <= q_start + t ? s[j] * scale
                                                        : neg_inf();
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

  if (t < T) {
    const float inv = 1.f / (l == 0.f ? 1.f : l);
    float* op = o + base + t * q_row;
#pragma unroll
    for (int i = 0; i < kOut; ++i)
      if (16 * i + 4 * sub < d)
        store4(op + 16 * i + 4 * sub,
               make_float4(acc[4 * i] * inv, acc[4 * i + 1] * inv,
                           acc[4 * i + 2] * inv, acc[4 * i + 3] * inv));
  }
}

// ------------------------------------------------ bf16: wgmma fed by TMA
using namespace repro_tc;

constexpr int kTcThreads = 3 * 128;  // two consumer warpgroups, a producer one
constexpr int kStages = 2;           // K/V ring depth
constexpr int kTcBQ = 128;           // query rows a block
constexpr int kTcBK = 64;            // keys a ring tile: its mask is one word
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct PfTile {
  static constexpr int kQBytes = kTcBQ * D * 2;
  static constexpr int kKBytes = kTcBK * D * 2;
  static constexpr int kBars = 1 + 2 * kStages;  // q, full[], empty[]
  static constexpr int kSmem = kQBytes + 2 * kStages * kKBytes + 8 * kBars +
                               8 * kStages +      // mask words
                               1024;              // alignment slack
};

template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
pp_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    const int* __restrict__ tables,
                    const int* __restrict__ q_starts,
                    const int* __restrict__ q_lens,
                    __nv_bfloat16* __restrict__ o, int T, int H, int G, int d,
                    int n_pages, int page, int maxp, int box,
                    float scale_log2) {
  using L = Swz<D>;
  using Tl = PfTile<D>;
  constexpr int BQ = kTcBQ, BK = kTcBK, NO = L::kW / 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  const uint32_t q_s = smem_u32(smem);
  const uint32_t kv_s = q_s + Tl::kQBytes;          // stage st: K, then V
  const uint32_t bars = kv_s + 2 * kStages * Tl::kKBytes;
  volatile unsigned long long* ok_s =
      reinterpret_cast<volatile unsigned long long*>(
          smem + Tl::kQBytes + 2 * kStages * Tl::kKBytes + 8 * Tl::kBars);
  const uint32_t q_bar = bars;
  auto full = [&](int st) { return bars + 8 * (1 + st); };
  auto empty = [&](int st) { return bars + 8 * (1 + kStages + st); };
  auto k_tile = [&](int st) { return kv_s + 2 * st * Tl::kKBytes; };
  auto v_tile = [&](int st) { return k_tile(st) + Tl::kKBytes; };

  const int t0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heavy tiles first
  const int h = blockIdx.y, n = blockIdx.z, kh = h / G;
  const int q_start = q_starts[n];
  const int kv_len = kv_extent(q_start, q_lens[n], page * maxp);
  const int k_end = min(kv_len, q_start + t0 + BQ);  // past the last query's
  const int nt = k_end > 0 ? (k_end + BK - 1) / BK : 0;

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
    if (warp == 8 && lane == 0 && nt > 0) {
      const int* table = tables + static_cast<long long>(n) * maxp;
      bar_expect(q_bar, Tl::kQBytes);
      tma_tile<D>(q_s, &qmap, q_bar, BQ, t0, h, n);
      for (int i = 0; i < nt; ++i) {
        const int st = i % kStages;
        const int k0 = i * BK;
        unsigned long long ok = 0;
        for (int b = 0; b * box < BK; ++b) {
          const int key = k0 + b * box, live = min(box, kv_len - key);
          if (live > 0 && mapped(table[key / page], n_pages))
            ok |= (live == 64 ? ~0ull : (1ull << live) - 1) << (b * box);
        }
        bar_wait(empty(st), ((i / kStages) & 1) ^ 1);
        ok_s[st] = ok;                        // released by the arrive below
        bar_expect(full(st), 2 * Tl::kKBytes);
        for (int b = 0; b * box < BK; ++b) {
          const int key = k0 + b * box;
          // an unmapped page or keys past the row's length: the slot -1
          // lies outside the map, and TMA gives zeros without a read
          const int slot = (ok >> (b * box)) & 1ull ? table[key / page] : -1;
#pragma unroll
          for (int hh = 0; hh < L::kHalves; ++hh) {
            const uint32_t at = (hh * BK + b * box) * L::kRowBytes;
            tma_load(k_tile(st) + at, &kmap, full(st), hh * L::kW,
                     key % page, kh, slot);
            tma_load(v_tile(st) + at, &vmap, full(st), hh * L::kW,
                     key % page, kh, slot);
          }
        }
      }
    }
  } else {                  // consumer warpgroups
    regs_claim<232>();

    // consumer warpgroup wg: query rows t0 + 64 wg + [0, 64); this thread's
    // rows r0 and r0 + 8, columns 8 j + c and + 1 of each n8 block
    const int wg = warp >> 2, wrow = t0 + 64 * wg;
    const int r0 = wrow + 16 * (warp & 3) + (lane >> 2), c = 2 * (lane & 3);
    float acc[L::kHalves][NO];
#pragma unroll
    for (int hh = 0; hh < L::kHalves; ++hh)
#pragma unroll
      for (int i = 0; i < NO; ++i) acc[hh][i] = 0.f;
    // running max (log2 units) and this lane's part of the running sum
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    if (nt > 0) bar_wait(q_bar, 0);

    for (int i = 0; i < nt; ++i) {
      const int st = i % kStages;
      const int k0 = i * BK;
      bar_wait(full(st), (i / kStages) & 1);
      const unsigned long long ok = ok_s[st];
      float s[BK / 2];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss(s, desc_k<D>(q_s, BQ, 64 * wg, kk),
                 desc_k<D>(k_tile(st), BK, 0, kk), kk > 0);
      wg_commit();
      wg_wait<0>();
      pin(s);

      // only a tile with a key past the diagonal of this warpgroup's first
      // row, past the row's length or on an unmapped page is masked
      const bool masked = ok != ~0ull || k0 + BK - 1 > q_start + wrow;
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + c + (e & 1);
          float x = s[4 * j + e] * scale_log2;
          if (masked && (((ok >> col) & 1ull) == 0 ||
                         k0 + col > q_start + r0 + 8 * (e >> 1)))
            x = neg_inf();
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
      const float inv = 1.f / (ll == 0.f ? 1.f : ll);
      if (row < T) {
        __nv_bfloat16* op =
            o + (static_cast<long long>(n) * T + row) * H * d + h * d;
#pragma unroll
        for (int hh = 0; hh < L::kHalves; ++hh)
#pragma unroll
          for (int j = 0; j < L::kW / 8; ++j)
            if (hh * L::kW + 8 * j < d)
              *reinterpret_cast<uint32_t*>(op + hh * L::kW + 8 * j + c) =
                pack_bf16(acc[hh][4 * j + 2 * rr] * inv,
                          acc[hh][4 * j + 2 * rr + 1] * inv);
      }
    }
  }
}

int gcd(int a, int b) {
  while (b) {
    const int r = a % b;
    a = b;
    b = r;
  }
  return a;
}

template <int D>
cudaError_t launch_tc(const void* q, const void* k, const void* v,
                      const int* tables, const int* q_starts,
                      const int* q_lens, void* o, int N, int T, int H, int K,
                      int d, int P, int page, int maxp, float scale,
                      cudaStream_t stream) {
  using Tl = PfTile<D>;
  const int box = gcd(page, kTcBK);    // page is a multiple of 8
  // element strides (b, head, s): q (N, T, H, d), a pool (P, page, K, d)
  const long long qst[3] = {static_cast<long long>(T) * H * d, d,
                            static_cast<long long>(H) * d};
  const long long kst[3] = {static_cast<long long>(page) * K * d, d,
                            static_cast<long long>(K) * d};
  CUtensorMap qm, km, vm;
  if (!tile_map<D>(&qm, q, N, H, T, qst, kTcBQ, d) ||
      !tile_map<D>(&km, k, P, K, page, kst, box, d) ||
      !tile_map<D>(&vm, v, P, K, page, kst, box, d))
    return cudaErrorInvalidValue;
  auto kernel = pp_fwd_wgmma_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Tl::kSmem);
  if (err != cudaSuccess) return err;
  dim3 grid((T + kTcBQ - 1) / kTcBQ, H, N);
  kernel<<<grid, kTcThreads, Tl::kSmem, stream>>>(
      qm, km, vm, tables, q_starts, q_lens, static_cast<__nv_bfloat16*>(o),
      T, H, H / K, d, P, page, maxp, box, scale * kLog2e);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_fma(const void* q, const void* k, const void* v,
                       const int* tables, const int* q_starts,
                       const int* q_lens, void* o, int N, int T, int H, int K,
                       int d, int P, int page, int maxp, float scale,
                       cudaStream_t stream) {
  constexpr int smem =
      (3 * kBQ * (D + kPad) + kBQ * (kBK + kPad)) * 4 + kBK * 8;
  auto kernel = pp_fwd_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((T + kBQ - 1) / kBQ, H, N);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), tables, q_starts, q_lens,
      static_cast<float*>(o), T, H, H / K, K, d, P, page, maxp, scale);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, out: see the top of this file; tables, q_starts, q_lens int32.
// d: the head dim, any multiple of 8 up to 128.  P: pages in the pool view.
// dtype: 0 = float32 (pp_fwd_kernel), 1 = bfloat16 (pp_fwd_wgmma_kernel,
// which needs a page size that is a multiple of 8 and 16-byte aligned
// bases for its tensor maps).  Returns the launch's cudaError_t (0 on
// success); the Python wrapper checks shapes, dtypes, devices and alignment
// before the call and raises on a non-zero return.
extern "C" int repro_paged_prefill(const void* q, const void* k,
                                   const void* v, const void* tables,
                                   const void* q_starts, const void* q_lens,
                                   void* out, int N, int T, int H, int K,
                                   int d, int P, int page, int maxp,
                                   float scale, int dtype, void* stream) {
  if (N <= 0 || N > 65535 || T <= 0 || H <= 0 || H > 65535 || K <= 0 ||
      H % K != 0 || P <= 0 || page <= 0 || maxp <= 0 ||
      static_cast<long long>(page) * maxp > (1LL << 30) ||
      (dtype == 1 && page % 8 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();  // the code returned below belongs to this call
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tb = static_cast<const int*>(tables);
  const int* qs = static_cast<const int*>(q_starts);
  const int* ql = static_cast<const int*>(q_lens);
#define REPRO_PP_ARGS q, k, v, tb, qs, ql, out, N, T, H, K, d, P, page, \
                      maxp, scale, s
  const int D = built_width(d);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0 && D == 32) err = launch_fma<32>(REPRO_PP_ARGS);
  if (dtype == 0 && D == 64) err = launch_fma<64>(REPRO_PP_ARGS);
  if (dtype == 0 && D == 128) err = launch_fma<128>(REPRO_PP_ARGS);
  if (dtype == 1 && D == 32) err = launch_tc<32>(REPRO_PP_ARGS);
  if (dtype == 1 && D == 64) err = launch_tc<64>(REPRO_PP_ARGS);
  if (dtype == 1 && D == 128) err = launch_tc<128>(REPRO_PP_ARGS);
#undef REPRO_PP_ARGS
  return static_cast<int>(err);
}
