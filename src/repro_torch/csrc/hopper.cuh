// Hopper (sm_90a) building blocks of the tensor-core flash-attention and
// SSD kernels: mbarriers, TMA tile loads, wgmma shared-memory descriptors and
// the wgmma instructions themselves, written as inline PTX.
//
// Tiles.  A bf16 tile of `rows` x D sits in shared memory as D / kW
// sub-tiles of `rows` x kW, each row of a sub-tile one swizzle span (128
// bytes, kW = 64, for D = 64 and 128; 64 bytes, kW = 32, for D = 32), in
// the swizzled order TMA writes (CU_TENSOR_MAP_SWIZZLE_128B / _64B) and
// wgmma reads (layout type 1 / 2).  Every sub-tile starts on a 1024-byte
// boundary, so the swizzle, which both units take from the address bits,
// agrees.  One tile serves as a K-major operand (rows = the product's M
// or N, d = its K) and as an MN-major one (rows = K, d = N).
//
// Fragments.  A warpgroup's 64 x N float accumulator gives thread t
// (warp w = t / 32 within the warpgroup, lane l) the elements
//   d[4j + e] = (row 16w + l/4 + 8 * (e >= 2), col 8j + 2 * (l % 4) + (e & 1)),
// so a row lives in the four lanes of one quad; a k16 slice of it, rounded
// to bf16 pairs, is exactly the register A fragment of the next wgmma.
//
// The tensor map (host side) is obtained from the driver through
// cudaGetDriverEntryPoint, so the library needs no -lcuda.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_tc {

template <int D>
struct Swz {
  static constexpr int kW = D == 32 ? 32 : 64;      // columns of a sub-tile
  static constexpr int kHalves = D / kW;            // sub-tiles across d
  static constexpr int kRowBytes = kW * 2;          // one swizzle span
  static constexpr int kAtom = 8 * kRowBytes;       // 8 rows: 1024 or 512
  static constexpr int kLayout = D == 32 ? 2 : 1;   // wgmma: 64B or 128B
  static constexpr int kKSteps = kW / 16;           // k16 slices per row
  static constexpr CUtensorMapSwizzle kSwizzle =
      D == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The first 1024-byte boundary at or after p (dynamic shared memory is
// only 16-byte aligned; swizzled tiles need 1024).
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// ------------------------------------------------------------- mbarriers
__device__ __forceinline__ void bar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Arrive and announce `bytes` of copies that will complete on `bar`.
__device__ __forceinline__ void bar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` of `bar` has completed.  A wait
// of more than about ten seconds (2^34 cycles) traps: a broken pipeline
// ends the launch with an error instead of hanging the card.
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  const long long t0 = clock64();
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > (1LL << 34)) __trap();
  } while (!done);
}

// ------------------------------------------------------------------ TMA
// One box of the 4-d map (d, s, head, b) at (c0, c1, c2, c3) into `dst`;
// its bytes complete on `bar`.  Out-of-range rows arrive as zeros.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// Load rows [row0, row0 + rows) of one (b, head) slice, all of d, as D / kW
// boxes into the sub-tiles of `dst`.
template <int D>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int rows, int row0,
                                         int head, int b) {
  using L = Swz<D>;
#pragma unroll
  for (int hh = 0; hh < L::kHalves; ++hh)
    tma_load(dst + hh * rows * L::kRowBytes, map, bar, hh * L::kW, row0,
             head, b);
}

// ---------------------------------------------------------------- wgmma
// Shared-memory matrix descriptor.  Both byte offsets are set to the
// 8-row stride: a product never spans two swizzle atoms along the
// dimension that the other offset would step.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, int layout,
                                              uint32_t atom) {
  const uint64_t off = (atom >> 4) & 0x3FFF;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (off << 16) |
         (off << 32) | (static_cast<uint64_t>(layout) << 62);
}

// K-major operand: rows [row0, row0 + 64 or N) of a tile of `rows` rows,
// k16 slice kk of d.
template <int D>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int rows, int row0,
                                           int kk) {
  using L = Swz<D>;
  return make_desc(tile + (kk / L::kKSteps) * rows * L::kRowBytes +
                       row0 * L::kRowBytes + (kk % L::kKSteps) * 32,
                   L::kLayout, L::kAtom);
}

// MN-major operand: rows [16 kk, 16 kk + 16) of a tile of `rows` rows as
// the product's K, sub-tile `half` of d as its N.
template <int D>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int rows, int half,
                                            int kk) {
  using L = Swz<D>;
  return make_desc(tile + half * rows * L::kRowBytes + kk * 16 * L::kRowBytes,
                   L::kLayout, L::kAtom);
}

// The shared address of element (r, col) of a bf16 tile of `rows` rows laid
// out as Swz<D>, for tiles that threads write themselves: the swizzle TMA
// writes and wgmma reads (within a sub-tile, the 16-byte chunk index XOR
// the row's place in its 8-row atom).
template <int D>
__device__ __forceinline__ uint32_t swz_addr(uint32_t tile, int rows, int r,
                                             int col) {
  using L = Swz<D>;
  const uint32_t o = r * L::kRowBytes + (col % L::kW) * 2;
  return tile + (col / L::kW) * rows * L::kRowBytes +
         (o ^ ((o >> 3) & (L::kRowBytes == 128 ? 0x70u : 0x30u)));
}

// A 16-byte store to shared memory, and the fence that makes such stores
// (the generic proxy) visible to wgmma (the async proxy): between the
// stores and the barrier that precedes the product.
__device__ __forceinline__ void sts128(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Move registers between warpgroups: the producer gives its share up, the
// consumers take it (each count a multiple of 8, at most 256; the pool is
// 65,536 a multiprocessor).
template <int R>
__device__ __forceinline__ void regs_release() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void regs_claim() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N of this warpgroup's committed product groups are
// still running (they complete in order).
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pin registers in program order around the asynchronous products, so the
// compiler neither reads an accumulator before wg_wait nor writes one
// (or an A fragment) after wg_fence.
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void pin(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// 2^x on the multi-function unit, denormals flushed: exp2f's non-ftz
// path costs the forward a seventh of its time at D 64.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The register A fragments of a 64 x N float accumulator, rounded to bf16:
// a[kk] holds its columns [16 kk, 16 kk + 16).
template <int N>
__device__ __forceinline__ void to_a_frags(const float (&d)[N / 2],
                                           uint32_t (&a)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[kk][r] = pack_bf16(d[8 * kk + 2 * r], d[8 * kk + 2 * r + 1]);
}

// A float pair as bf16 hi + lo: hi the nearest bf16 pair, lo that of the
// remainder, so hi + lo keeps about 16 bits of each value's mantissa.
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x - hf.x, y - hf.y);
}

// The register A fragments of a 64 x N float accumulator as bf16 hi + lo.
template <int N>
__device__ __forceinline__ void to_a_frags2(const float (&d)[N / 2],
                                            uint32_t (&hi)[N / 16][4],
                                            uint32_t (&lo)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      split_bf16(d[8 * kk + 2 * r], d[8 * kk + 2 * r + 1], hi[kk][r],
                 lo[kk][r]);
}

// d (64 x 32) = [d +] a (64 x 16) b (16 x 32); a and b from shared memory,
// K-major, or MN-major where TA / TB is 1 (an MN-major a is described as
// desc_mn describes b: 16 rows of K, 64 columns of M).
template <int TA = 0, int TB = 0>
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate), "n"(TA), "n"(TB));
}

// d (64 x 64) = [d +] a (64 x 16) b (16 x 64); as above.
template <int TA = 0, int TB = 0>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate), "n"(TA), "n"(TB));
}

// d (64 x 128) = [d +] a (64 x 16) b (16 x 128); as above.
template <int TA = 0, int TB = 0>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate), "n"(TA), "n"(TB));
}

// d (64 x 32) = [d +] a (64 x 16, bf16 pairs in registers) b (16 x 32); b
// from shared memory, MN-major.
__device__ __forceinline__ void wgmma_rs(float (&d)[16],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate));
}

// d (64 x 64) = [d +] a (64 x 16, bf16 pairs in registers) b (16 x 64); b
// from shared memory, MN-major.
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate));
}

// ------------------------------------------------------------ host side
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// The tensor map of a bf16 (B, heads, S, d) tensor given by its element
// strides st = (b, head, s), d contiguous, read in boxes of `rows` x kW
// into tiles D wide.  d (a multiple of 8, at most D) is the tensor's own
// extent: the columns of a box at or past d arrive as zeros
// (CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE), so a D-wide product over them adds
// nothing.  A dimension of size 1 is never stepped, so its stride is
// replaced by a valid one.  Returns false if the driver refuses the map.
template <int D>
inline bool tile_map(CUtensorMap* map, const void* base, int B, int heads,
                     int S, const long long* st, int rows, int d) {
  using L = Swz<D>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const long long n[3] = {S, heads, B}, el[3] = {st[2], st[1], st[0]};
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                        static_cast<cuuint64_t>(S),
                        static_cast<cuuint64_t>(heads),
                        static_cast<cuuint64_t>(B)};
  cuuint64_t strides[3];
  for (int i = 0; i < 3; ++i)
    strides[i] = static_cast<cuuint64_t>(n[i] > 1 ? el[i] * 2 : d * 2);
  cuuint32_t box[4] = {static_cast<cuuint32_t>(L::kW),
                       static_cast<cuuint32_t>(rows), 1, 1};
  cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, L::kSwizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace repro_tc
