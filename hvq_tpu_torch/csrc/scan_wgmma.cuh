// The tensor-core body of the bin scans on Hopper (sm_90a), shared by K1
// (packed_scan_v3.cu) and K3/K2/K4 (lane_scan.cu): the mbarrier, TMA,
// cp.async and wgmma wrappers, the 128B-swizzle operand layout, the bf16
// splits, the tensor-map encode and one kernel template.
//
// What the body computes, for bin depths R ≤ 8 (kMaxWgmmaR), with the mask
//   ok = oid < sn ∧ (¬ac ∨ C == v) ∧ (¬at ∨ l ≤ T ≤ r):
// K1, K3 and K2 (the packed key, PackedKey):
//   d   = (‖d‖² − 2·q·d) + ‖q‖²  (one fma and one add, the TPU kernels' order)
//   key = max(bits(d), 0) & ~0x7F | s,  +inf (0x7F800000) unless ok
// and each bin keeps its R smallest keys; s, the payload, is the slice. The
// integer max maps −0.0 and below to +0.0, whose key would sort first.
// K4 (BinKey, pallas_scan.py:110-156): score = ‖d‖² − 2·q·d in one fma, no
// ‖q‖² and no clamp, +inf unless ok; each bin keeps its R smallest (score,
// lane) pairs, ties to the lowest lane, and reports (score, oid of the row).
// What varies, as template arguments:
//
// * the layout L: where slice s of a CTA's bins lies (the slice's TMA
//   coordinates and the attribute addresses) and how a kept key decodes.
//   Axis1 (K1): bin b of a tile is rows tile·Dt + s·bins + b, so a slice of
//   NB bins is NB contiguous rows, one 2-D box. Lane (K3, K2, K4): global
//   bin g is the 128 contiguous rows g·128 + s, so a slice is row g·128 + s
//   of NB consecutive bins, 64 KB apart: one box of a 3-D tensor map over
//   the plane, (128 lanes, 128 slices, nbins);
// * the bf16 passes of q·d on the tensor cores, the TPU kernels' own
//   arithmetic, all chained into one fp32 accumulator: 1 on a bf16 plane
//   (K1); 3 on an fp32 plane, qhi·Vhi + qhi·Vlo + qlo·Vhi (K1's fp32 plane,
//   and K2's body, pallas_scan.py:775-786); 6, the bf16×6 emulation of fp32
//   that Mosaic runs for HIGHEST (K3, and K4, which asks for HIGHEST at
//   pallas_scan.py:124-128), smallest terms first:
//   ql·Vh + qm·Vm + qh·Vl + qm·Vh + qh·Vm + qh·Vh. An fp32 value splits as
//   hi = bf16_rn(x), mid = bf16_rn(x − hi), lo = bf16_rn(x − hi − mid)
//   (hi and lo = bf16_rn(x − hi) for three passes); every remainder is exact;
// * the key policy Key: what a bin's list holds, how a (value, slice) pair
//   becomes an entry, the empty entry, the insert and how an entry is
//   emitted. PackedKey (the default: K1, K3, K2 and the anatomy) is the
//   packed 32-bit key above; BinKey (K4) an (fp32 score, lane) pair, two
//   registers an entry, inserted by a strict < (below);
// * NB bins a CTA, kWG consumer warpgroups of 64 queries (the wgmma M) that
//   share each slice (on an fp32 plane its split as well), and kStages
//   slices in flight;
// * for the K1 anatomy probe only (k1_anatomy.cu, experiments/v3_anatomy.py):
//   kPasses = 0, an int8 plane and int8 queries in one s8 pass into an int32
//   accumulator, q·d = int32 × kAlphaI8 in fp32; and kStop, where the
//   epilogue stops (Stage below). K1, K3, K2 and K4 instantiate kStop = kFull.
//
// Structure. One producer warp keeps a ring of slices in flight: the plane's
// slice by TMA, C, T, ‖d‖² and oid by cp.async, both completing on the
// slice's mbarrier (cp.async.mbarrier.arrive.noinc; 1-D TMA boxes for the
// attributes raced with two CTAs an SM). On an fp32 plane the consumers
// split each slice in shared memory into swizzled bf16 parts; the query
// block is split once. Then m64nNBk16 wgmma chains into the accumulator
// fragment in registers, and the epilogue on it: the fragment's (query,
// bin) mapping is the same for every slice, so each thread keeps the running
// top-R of its own fragment elements in registers across all 128 slices,
// updated branch-free by a min/max pass (a masked key is +inf and passes
// through, as does any key not below the list's R-th). A warpgroup whose
// queries all carry no predicate (ac = at = 0; rows past B count as such)
// runs the epilogue's predicate-free body, chosen once by a vote of the
// warpgroup: no C, T, compare or select, the row's liveness folded into its
// ‖d‖² (+inf for a dead column, so its entry never goes below an empty
// slot and the output is bit for bit the predicated body's). Keys are distinct
// through the payload, so the running top-R equals the TPU kernels' R min
// rounds bit for bit. K4's pairs are not distinct: a slice's lane is s and
// the slices arrive in increasing s, so a strict < puts a score equal to a
// kept one after it, and the running top-R again equals R argmin rounds
// (first occurrence). The launch order puts the query blocks of one slice
// range next to each other, so a slice is read from HBM once and from L2
// after.
//
// What bounds it on this card: 2·B·n·100 FLOP a pass (the vectors have 100
// lanes) at the main-path batch B = 1024 is ~800 FLOP per byte of the bf16
// plane, so the tensor cores, not HBM, set the bound (K4's six passes over
// the fp32 plane: 6·2·B·n·100 FLOP, operations again). Every (query, row)
// pair also costs CUDA-core instructions (distance, clamp, mask, key, the
// top-R insert); measured on K1, that epilogue and not the product sets the
// time (PERF.md). K4's design answer is K3's: the same six-pass chain and
// ring, its unpacked pair costing one more register an entry and a select
// more a level of the insert.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kSlices = 128;        // rows per bin = payload range
constexpr int kDim = 128;           // padded vector width
constexpr int kInfKey = 0x7F800000;
constexpr int kKeyMask = ~0x7F;
constexpr int kMaxWgmmaR = 8;       // largest R on the tensor-core body
constexpr int kM = 64;              // queries per warpgroup (wgmma M)
constexpr int kWGThreads = 128;     // one consumer warpgroup
// The int8 plane's dequantization scale, fp32((6/127)²) as
// experiments/v3_anatomy.py:39 forms it (ALPHA_I8 in ops/probe_kernels.py).
constexpr float kAlphaI8 = 0x1.248da4p-9f;

// Where the epilogue stops (experiments/v3_anatomy.py:69-142). Before kPack
// a bin keeps only the running min of one value: mm the product q·d, mmb
// its bf16 rounding, dist max((‖d‖² − 2·q·d) + ‖q‖², 0), mask the same with
// the predicate and sample mask (+inf where masked). kPack forms the packed
// keys and keeps the top R with no mask; kFull is the shipped function.
enum Stage { kMm = 0, kMmb = 1, kDist = 2, kMask = 3, kPack = 4, kFull = 5 };

// One scan call. A tile is db_tile = bins·128 rows; the scan covers tiles
// [t0, t0 + ntw); nbins: the 128-row bins of the whole plane; nbb, nqb: the
// launch's bin and query blocks; QB: a CUDA-core CTA's query block.
struct Args {
  const void* V;
  const float* C;
  const float* T;
  const float* dn;
  const int* oid;
  const float* q;
  const float* qn;
  const int* ac;
  const float* v;
  const int* at;
  const float* l;
  const float* r;
  float* out_d;
  int* out_p;
  int sn, B, db_tile, bins, R, t0, ntw, nbins, nbb, nqb, QB;
  // when not null, each warpgroup that holds queries and runs the
  // predicate-free epilogue adds 1 here
  int* open_wg;
};

// Shared-memory plan of one CTA, in bytes from a 1024-aligned base. Every
// operand that wgmma reads (query parts, bf16 slice parts) starts
// 1024-aligned: the 128B swizzle repeats every 8 rows of 128 bytes.
template <int kPasses, int NB, int kWG, int kStages_>
struct Plan {
  static_assert(kPasses == 0 || kPasses == 1 || kPasses == 3 || kPasses == 6,
                "0 (s8), 1, 3 or 6 passes");
  static constexpr int kStages = kStages_;                   // slices in flight
  static constexpr bool kI8 = kPasses == 0;                  // int8 plane
  static constexpr bool kBf16 = kPasses == 1;                // bf16 plane
  static constexpr bool kDirect = kPasses <= 1;              // wgmma reads the slice as stored
  static constexpr int kElem = kI8 ? 1 : kBf16 ? 2 : 4;      // plane bytes an element
  static constexpr int kParts = kPasses <= 1 ? 1 : kPasses == 3 ? 2 : 3;
  static constexpr int kQ = kM * kDim * (kI8 ? 1 : 2);       // one query block (part)
  static constexpr int kV = NB * kDim * 2;                   // one bf16 slice part
  static constexpr int kPlane = NB * kDim * kElem;           // one slice as stored
  static constexpr int kAttr = 4 * NB * 4;                   // C, T, dn, oid
  static constexpr int kStage = ((kPlane + kAttr + 1023) / 1024) * 1024;
  static constexpr int q = 0;                                // [kParts][kWG] blocks
  static constexpr int split = q + kParts * kWG * kQ;        // [kParts] slice parts
  static constexpr int ring = split + (kDirect ? 0 : kParts * kV);
  static constexpr int bars = ring + kStages * kStage;
  static constexpr int bytes = bars + 2 * kStages * 8;
  static constexpr int smem = bytes + 1024;                  // alignment slack
  static constexpr uint32_t tx = kPlane;                     // TMA bytes a slice
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void tma_2d(uint32_t dst, const CUtensorMap* map,
                                       int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_3d(uint32_t dst, const CUtensorMap* map,
                                       int c0, int c1, int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
         "r"(bar)
      : "memory");
}

// 4-byte asynchronous copy global → shared; cp_async_arrive makes the
// barrier see one arrival once every copy this thread issued has landed.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" :: "r"(dst), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" :: "r"(bar)
               : "memory");
}

// Barrier of one consumer warpgroup (ids 1, 2, ...; id 0 is __syncthreads).
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, %1;" :: "r"(1 + wg), "n"(kWGThreads) : "memory");
}

// wg_sync that also returns whether p holds on every thread of the
// warpgroup (the same answer on each).
__device__ __forceinline__ bool wg_all(int wg, bool p) {
  uint32_t all;
  asm volatile(
      "{\n.reg .pred p, q;\nsetp.ne.u32 p, %1, 0;\n"
      "bar.red.and.pred q, %2, %3, p;\nselp.u32 %0, 1, 0, q;\n}\n"
      : "=r"(all) : "r"((uint32_t)p), "r"(1 + wg), "n"(kWGThreads) : "memory");
  return all != 0;
}

// Barrier of all kWG consumer warpgroups (id kWG + 1, after theirs).
template <int kWG>
__device__ __forceinline__ void consumers_sync(int wg) {
  if constexpr (kWG == 1)
    wg_sync(wg);
  else
    asm volatile("bar.sync %0, %1;" :: "n"(kWG + 1), "n"(kWG * kWGThreads) : "memory");
}

// Generic-proxy shared-memory writes become visible to wgmma (async proxy).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Byte offset of element (row, k) of a K-major bf16 operand of `rows` rows
// × 128 k in the 128B-swizzled layout: two 64-k column blocks of rows ×
// 128 B; inside a block the 16-byte chunk index is XORed with row % 8,
// what TMA's CU_TENSOR_MAP_SWIZZLE_128B writes.
__device__ __forceinline__ int swz(int rows, int row, int k) {
  return (k >> 6) * rows * 128 + row * 128 + ((((k & 63) >> 3) ^ (row & 7)) << 4)
         + (k & 7) * 2;
}

// wgmma shared-memory descriptor of a K-major operand in the 128B swizzle:
// start >> 4, leading offset 1 (unused for this layout), stride 1024 B
// between 8-row groups, layout type 1 = 128B swizzle.
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16)
         | ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N / 2]) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void fence_acc(int (&d)[N / 2]) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

#define K1_D16(c) c(d[0]), c(d[1]), c(d[2]), c(d[3]), c(d[4]), c(d[5]), \
    c(d[6]), c(d[7]), c(d[8]), c(d[9]), c(d[10]), c(d[11]), c(d[12]),   \
    c(d[13]), c(d[14]), c(d[15])
#define K1_D32(c) K1_D16(c), c(d[16]), c(d[17]), c(d[18]), c(d[19]),    \
    c(d[20]), c(d[21]), c(d[22]), c(d[23]), c(d[24]), c(d[25]), c(d[26]), \
    c(d[27]), c(d[28]), c(d[29]), c(d[30]), c(d[31])
#define K1_N64                                                            \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                            \
  "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "                 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "    \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, " \
  "%29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
#define K1_N32                                                            \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"                            \
  "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "                 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "    \
  "%15}, %16, %17, p, 1, 1, 0, 0;\n}\n"

// D = A·Bᵀ (kInit: scale-d 0) or D += A·Bᵀ, m64nNk16, bf16 operands,
// fp32 accumulators. Both forms name D read-write, so the accumulators keep
// their registers across a chain of asynchronous products.
template <int N, bool kInit>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], uint64_t da, uint64_t db) {
  if constexpr (N == 64) {
    asm volatile(K1_N64 : K1_D32("+f") : "l"(da), "l"(db), "r"(kInit ? 0 : 1));
  } else {
    static_assert(N == 32, "m64n32 or m64n64");
    asm volatile(K1_N32 : K1_D16("+f") : "l"(da), "l"(db), "r"(kInit ? 0 : 1));
  }
}

// The k-steps of one 128-lane product: A (64 × 128) and B (NB × 128), both
// K-major and swizzled; step k moves 32 bytes inside a 64-k block.
template <int NB, bool kFirst>
__device__ __forceinline__ void product(float (&d)[NB / 2], uint32_t a, uint32_t b) {
#pragma unroll
  for (int k = 0; k < kDim / 16; ++k) {
    const uint64_t da = desc(a + (k >> 2) * kM * 128 + (k & 3) * 32);
    const uint64_t db = desc(b + (k >> 2) * NB * 128 + (k & 3) * 32);
    if (kFirst && k == 0)
      wgmma<NB, true>(d, da, db);
    else
      wgmma<NB, false>(d, da, db);
  }
}

#define K1_N64_S8                                                         \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                            \
  "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "                     \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "    \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, " \
  "%29, %30, %31}, %32, %33, p;\n}\n"

// D = A·Bᵀ (kInit) or D += A·Bᵀ, m64n64k32, s8 operands, s32 accumulators.
// s8 wgmma has no transpose: both operands are K-major.
template <bool kInit>
__device__ __forceinline__ void wgmma_s8(int (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(K1_N64_S8 : K1_D32("+r") : "l"(da), "l"(db), "r"(kInit ? 0 : 1));
}

// One 128-lane s8 product: A (64 × 128 B) and B (NB × 128 B), K-major, one
// 128B-swizzled row each; step k moves 32 bytes (32 k) along the row.
template <int NB>
__device__ __forceinline__ void product_s8(int (&d)[NB / 2], uint32_t a, uint32_t b) {
  static_assert(NB == 64, "the int8 plane runs m64n64k32");
#pragma unroll
  for (int k = 0; k < kDim / 32; ++k) {
    if (k == 0)
      wgmma_s8<true>(d, desc(a), desc(b));
    else
      wgmma_s8<false>(d, desc(a + k * 32), desc(b + k * 32));
  }
}

// Byte offset of chunk c (16 bytes, k = 16c..16c+15) of row `row` of a
// K-major int8 operand in the 128B swizzle: one 128-byte row a row.
__device__ __forceinline__ int swz8(int row, int c) {
  return row * 128 + ((c ^ (row & 7)) << 4);
}

// q·d from the accumulator: as it is on an fp32 accumulator; int32 × kAlphaI8
// (exact conversion: |q·d| ≤ 128·127² < 2²⁴, then one fp32 rounding) on s32.
__device__ __forceinline__ float qd_of(float acc) { return acc; }
__device__ __forceinline__ float qd_of(int acc) {
  return __fmul_rn(__int2float_rn(acc), kAlphaI8);
}

// The kParts-way bf16 split of 8 values: part 0 = bf16_rn(x), each next part
// the bf16 rounding of what the parts before it leave (an exact fp32
// remainder); 16 bytes a part, element i at the lower address of its pair.
template <int kParts>
__device__ __forceinline__ void split8(const float (&x)[8], uint4 (&part)[kParts]) {
  uint32_t w[kParts][4];
#pragma unroll
  for (int p = 0; p < 4; ++p) {
#pragma unroll
    for (int j = 0; j < kParts; ++j) w[j][p] = 0;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float rest = x[2 * p + e];
#pragma unroll
      for (int j = 0; j < kParts; ++j) {
        const __nv_bfloat16 b = __float2bfloat16_rn(rest);
        w[j][p] |= (uint32_t)__bfloat16_as_ushort(b) << (16 * e);
        rest = rest - __bfloat162float(b);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kParts; ++j) part[j] = make_uint4(w[j][0], w[j][1], w[j][2], w[j][3]);
}

typedef CUresult (*EncodeTiled)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library needs no link against libcuda.
EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// Axis1 (K1): a CTA owns a query block and bins [b0, b0 + NB) of window tile
// `tile`; slice s is the NB contiguous rows tile_row + s·bins + b0 + c.
struct Axis1 {
  int qblk, tile, b0, nb;
  long long tile_row;

  __device__ Axis1(const Args& a, int NB) {
    qblk = blockIdx.x % a.nqb;            // query blocks of a slice adjacent
    const int rest = blockIdx.x / a.nqb;
    tile = rest / a.nbb;                  // window-local tile
    b0 = (rest % a.nbb) * NB;
    nb = min(NB, a.bins - b0);
    tile_row = (long long)(a.t0 + tile) * a.db_tile;
  }
  static constexpr int kColStride = 1;    // rows from one column to the next
  // The plane row of column 0 of slice s.
  __device__ long long row(const Args& a, int s) const {
    return tile_row + (long long)s * a.bins + b0;
  }
  // Slice s by TMA: one 128-lane fp32 box, or on the bf16 plane two 64-lane
  // boxes in the 128B swizzle, which wgmma reads as they land.
  template <bool kBf16>
  __device__ void load(uint32_t dst, const CUtensorMap* map, const Args& a, int s,
                       int NB, uint32_t bar) const {
    const int r = (int)row(a, s);
    tma_2d(dst, map, 0, r, bar);
    if (kBf16) tma_2d(dst + NB * 128, map, 64, r, bar);
  }
  // Column c's entry 0 in an output row: tile·R·bins + b0 + c (entry j is
  // j·bins further).
  __device__ long long col(const Args& a, int c) const {
    return (long long)tile * a.R * a.bins + b0 + c;
  }
  // A kept key of column c at output offset o: its distance and its row.
  __device__ void emit(const Args& a, long long o, int c, int key) const {
    a.out_d[o] = __int_as_float(key & kKeyMask);
    a.out_p[o] = (int)(tile_row + (long long)(key & 0x7F) * a.bins + b0 + c);
  }
  static int bin_blocks(const Args& a, int NB) { return (a.bins + NB - 1) / NB; }
  static long long blocks(const Args& a) { return (long long)a.nqb * a.nbb * a.ntw; }
  // The plane (nbins·128, 128) of `elem`-byte elements: bf16 as two 64-lane
  // boxes and int8 as one 128-lane box in the 128B swizzle (wgmma's B
  // layout); fp32 as one unswizzled 128-lane box.
  static CUresult encode(EncodeTiled enc, CUtensorMap* map, const Args& a, int NB,
                         int elem) {
    const cuuint64_t dim[2] = {(cuuint64_t)kDim, (cuuint64_t)a.nbins * kSlices};
    const cuuint64_t stride[1] = {(cuuint64_t)kDim * elem};
    const cuuint32_t box[2] = {(cuuint32_t)(elem == 2 ? 64 : kDim), (cuuint32_t)NB};
    const cuuint32_t es[2] = {1, 1};
    return enc(map, elem == 4   ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                    : elem == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                : CU_TENSOR_MAP_DATA_TYPE_UINT8,
               2, const_cast<void*>(a.V), dim, stride, box, es,
               CU_TENSOR_MAP_INTERLEAVE_NONE,
               elem == 4 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  }
};

// Axis1Keys (the K1 anatomy): Axis1, but the output is one int32 array of
// the kept keys as they are (out_p), not decoded.
struct Axis1Keys : Axis1 {
  __device__ Axis1Keys(const Args& a, int NB) : Axis1(a, NB) {}
  __device__ void emit(const Args& a, long long o, int, int key) const { a.out_p[o] = key; }
};

// Lane (K3, K2): global bin g = tile·bins + b is the 128 contiguous rows
// g·128 + s whatever the tile, so a CTA owns a query block and NB
// consecutive global bins g0 + c, which may span tiles; slice s is row
// g·128 + s of each.
struct Lane {
  int qblk, g0, nb;

  __device__ Lane(const Args& a, int NB) {
    qblk = blockIdx.x % a.nqb;            // query blocks of a slice adjacent
    g0 = (blockIdx.x / a.nqb) * NB;
    nb = min(NB, a.nbins - g0);
  }
  static constexpr int kColStride = kSlices;
  __device__ long long row(const Args&, int s) const {
    return (long long)g0 * kSlices + s;
  }
  // Slice s by TMA: one box {128 lanes, 1 slice, NB bins} of the 3-D map at
  // (0, s, g0); bins past nbins come back zero-filled (dead: their oid is
  // INT_MAX, the kernel's sentinel).
  template <bool kBf16>
  __device__ void load(uint32_t dst, const CUtensorMap* map, const Args&, int s, int,
                       uint32_t bar) const {
    static_assert(!kBf16, "the lane kernels read the fp32 plane");
    tma_3d(dst, map, 0, s, g0, bar);
  }
  // Column c's entry 0 in an output row: tile·R·bins + b for global bin
  // g = g0 + c = tile·bins + b. The tile is taken per column: a CTA's bins
  // may span tiles.
  __device__ long long col(const Args& a, int c) const {
    const int g = g0 + c, tile = g / a.bins;
    return (long long)tile * a.R * a.bins + (g - tile * a.bins);
  }
  // A kept key of column c at output offset o: its distance and its row
  // g·128 + lane.
  __device__ void emit(const Args& a, long long o, int c, int key) const {
    a.out_d[o] = __int_as_float(key & kKeyMask);
    a.out_p[o] = (int)((long long)(g0 + c) * kSlices + (key & 0x7F));
  }
  // K4's kept (score, lane) of column c at output offset o: the score, −0.0
  // written as +0.0, and the oid of its row g·128 + lane.
  __device__ void emit_oid(const Args& a, long long o, int c, float v, int lane) const {
    a.out_d[o] = __fadd_rn(v, 0.f);
    a.out_p[o] = a.oid[(long long)(g0 + c) * kSlices + lane];
  }
  static int bin_blocks(const Args& a, int NB) { return (a.nbins + NB - 1) / NB; }
  static long long blocks(const Args& a) { return (long long)a.nqb * a.nbb; }
  // The fp32 plane as (128 lanes, 128 slices, nbins): strides 512 B and
  // 64 KB, box {128, 1, NB}, unswizzled (split in the kernel).
  static CUresult encode(EncodeTiled enc, CUtensorMap* map, const Args& a, int NB,
                         int) {
    const cuuint64_t dim[3] = {(cuuint64_t)kDim, (cuuint64_t)kSlices,
                               (cuuint64_t)a.nbins};
    const cuuint64_t stride[2] = {(cuuint64_t)kDim * 4, (cuuint64_t)kSlices * kDim * 4};
    const cuuint32_t box[3] = {(cuuint32_t)kDim, 1, (cuuint32_t)NB};
    const cuuint32_t es[3] = {1, 1, 1};
    return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(a.V), dim,
               stride, box, es, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  }
};

// Key policies: a bin list's entry T, the empty entry (also a masked
// slot's), value (the distance or score from q·d, ‖d‖² and ‖q‖²), entry
// (the list entry of a live value and its slice), insert (one step down a
// sorted list: the smaller of the slot and the carried entry stays, the
// larger is carried on) and emit (a kept entry through the layout).
// Force-inlined, and the mask's select stays in the kernel, so PackedKey's
// instantiations compile to the SASS they had before the policy existed.

// K1, K3, K2: the packed 32-bit key (the header's first formula).
struct PackedKey {
  using T = int;
  static __device__ __forceinline__ T empty() { return kInfKey; }
  // (‖d‖² − 2·q·d) + ‖q‖² in the TPU kernel's order (2·q·d is exact, so one
  // fma rounds as the subtraction does)
  static __device__ __forceinline__ float value(float qd, float dn, float qn) {
    return __fadd_rn(__fmaf_rn(-2.f, qd, dn), qn);
  }
  // the integer max maps −0.0 and below to +0.0, whose key would
  // otherwise sort first
  static __device__ __forceinline__ T entry(float d, int s) {
    return (max(__float_as_int(d), 0) & kKeyMask) | s;
  }
  // keys are distinct through the payload: a min/max pair, branch-free
  static __device__ __forceinline__ void insert(T& slot, T& k) {
    const int lo = min(slot, k);
    k = max(slot, k);
    slot = lo;
  }
  template <class L>
  static __device__ __forceinline__ void emit(const L& lay, const Args& a, long long o,
                                              int c, T key) {
    lay.emit(a, o, c, key);
  }
};

// K4's entry: the unpacked score and the lane (slice) it came from.
struct ScoreLane {
  float v;
  int lane;
};

// K4 (pallas_scan.py:110-156): score = ‖d‖² − 2·q·d in one rounding
// (fmaf(−2, q·d, ‖d‖²); 2·q·d is exact, so it equals the TPU kernel's
// dn − 2·qd), no ‖q‖² and no clamp, so scores may be negative; +inf where
// masked. The empty entry is (+inf, lane 0), what argmin over an all-+inf
// bin gives, so a bin with fewer than R live rows pads with it; a masked
// score never enters. The insert is a strict <: the slices arrive in
// increasing s, so a score equal to a kept one goes after it and ties go to
// the lowest lane, argmin's first occurrence. Float < ties −0.0 with +0.0,
// as argmin does; the emitted score is written +0.0 for −0.0 (Lane::emit_oid).
struct BinKey {
  using T = ScoreLane;
  static __device__ __forceinline__ T empty() { return {__int_as_float(kInfKey), 0}; }
  static __device__ __forceinline__ float value(float qd, float dn, float) {
    return __fmaf_rn(-2.f, qd, dn);
  }
  static __device__ __forceinline__ T entry(float v, int s) { return {v, s}; }
  static __device__ __forceinline__ void insert(T& slot, T& k) {
    const bool lt = k.v < slot.v;
    const T lo = lt ? k : slot;
    k = lt ? slot : k;
    slot = lo;
  }
  template <class L>
  static __device__ __forceinline__ void emit(const L& lay, const Args& a, long long o,
                                              int c, T e) {
    lay.emit_oid(a, o, c, e.v, e.lane);
  }
};

// kWG consumer warpgroups (64 queries each) share the ring, so a slice is
// read once for 64·kWG queries; RR is the list length held in registers
// (R rounded up to 1, 2, 3, 4, 6, 8; 1 for a stage before kPack).
template <class L, int kPasses, int NB, int kWG, int RR, int kStages, int kStop = kFull,
          class Key = PackedKey>
__global__ void __launch_bounds__(kWG * kWGThreads + 32, kWG == 1 ? 2 : 1)
scan_wgmma(__grid_constant__ const CUtensorMap plane, Args a) {
  using P = Plan<kPasses, NB, kWG, kStages>;
  constexpr bool kBf16 = P::kBf16, kDirect = P::kDirect;
  static_assert(kStop == kFull || std::is_same<L, Axis1Keys>::value,
                "the anatomy stages write raw values (Axis1Keys)");
  static_assert(kStop == kFull || std::is_same<Key, PackedKey>::value,
                "the anatomy stages keep packed keys");
  constexpr int kConsumers = kWG * kWGThreads;
  // Round the dynamic base up to 1024 by offsetting the shared array itself,
  // so every access below stays a shared-memory access (LDS, not LD).
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(sm);
  const uint32_t full = base + P::bars, empty = full + 8 * kStages;

  const int tid = threadIdx.x;
  const L lay(a, NB);

  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full + 8 * i, 33);
      mbar_init(empty + 8 * i, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // Columns past nb are never copied into the ring: their oid stays
  // INT_MAX (≥ every sn), so a column is live exactly when its oid < sn.
  // (Testing c < nb in the epilogue too cost the bf16 R ≥ 3 bodies spills.)
  if (lay.nb < NB)
    for (int i = tid; i < kStages * NB; i += blockDim.x) {
      int* soid = reinterpret_cast<int*>(sm + P::ring + (i / NB) * P::kStage + P::kPlane);
      if (i % NB >= lay.nb) soid[3 * NB + i % NB] = 0x7FFFFFFF;
    }
  __syncthreads();

  if (tid >= kConsumers) {
    // Producer warp: lane 0 brings each slice's plane rows by TMA; every
    // lane copies a share of its C, T, ‖d‖² and oid with cp.async, whose
    // completion arrives on the same barrier. A slice is full after the
    // plane's bytes and 33 arrivals; the warp never waits on a load.
    const int lane = tid - kConsumers;
    for (int s = 0; s < kSlices; ++s) {
      const int st = s % kStages;
      mbar_wait(empty + 8 * st, ((s / kStages) & 1) ^ 1);
      const uint32_t bar = full + 8 * st;
      const uint32_t dst = base + P::ring + st * P::kStage;
      const long long row = lay.row(a, s);
      for (int c = lane; c < lay.nb; c += 32) {
        const long long rc = row + (long long)c * L::kColStride;
        cp_async4(dst + P::kPlane + 4 * c, a.C + rc);
        cp_async4(dst + P::kPlane + 4 * (NB + c), a.T + rc);
        cp_async4(dst + P::kPlane + 4 * (2 * NB + c), a.dn + rc);
        cp_async4(dst + P::kPlane + 4 * (3 * NB + c), a.oid + rc);
      }
      cp_async_arrive(bar);
      if (lane == 0) {
        mbar_expect_tx(bar, P::tx);
        lay.template load<kBf16>(dst, &plane, a, s, NB, bar);
      }
    }
    return;
  }

  const int wg = tid / kWGThreads, t = tid % kWGThreads;
  const int q0 = (lay.qblk * kWG + wg) * kM;
  const int nq = min(kM, a.B - q0);
  // A warpgroup past B only keeps the ring turning; on an fp32 plane with
  // kWG > 1 it still takes its share of each slice's split (its queries are
  // zero and every key it forms is masked).
  if (nq <= 0 && (kDirect || kWG == 1)) {
    for (int s = 0; s < kSlices; ++s) {
      mbar_wait(full + 8 * (s % kStages), (s / kStages) & 1);
      mbar_arrive(empty + 8 * (s % kStages));
    }
    return;
  }

  // This thread's fragment: rows 16·warp + lane/4 + 8g, columns
  // 8j + 2·(lane % 4) + h, accumulator element 4j + 2g + h. Each row's
  // predicate as closed bounds on C and T: [v, v] for C == v, [l, r] for
  // the T range, (−inf, inf) when inactive, an empty C range for rows past
  // B. (A NaN attribute never passes; data has none.)
  constexpr int kE = NB / 2;              // fragment elements a thread
  const int warp = t / 32, lane = t % 32;
  const float kInf = __int_as_float(0x7F800000);
  float qn[2], clo[2], chi[2], tlo[2], thi[2];
  bool open = true;                       // no row of this thread's carries a predicate
#pragma unroll
  for (int g = 0; g < 2; ++g) {
    const int m = 16 * warp + lane / 4 + 8 * g;
    const bool live = m < nq;
    // a row past B (an idle warpgroup's too) reads a valid query's fields;
    // not q0 + m itself, which the compiler would then keep live for the
    // output rows across the slice loop
    const int gq = min(q0, a.B - 1) + (live ? m : 0);
    const bool ac = a.ac[gq] != 0, at = a.at[gq] != 0;
    open = open && !(live && (ac || at));
    qn[g] = a.qn[gq];
    clo[g] = !live ? kInf : ac ? a.v[gq] : -kInf;
    chi[g] = ac ? a.v[gq] : kInf;
    tlo[g] = at ? a.l[gq] : -kInf;
    thi[g] = at ? a.r[gq] : kInf;
  }

  // Stage this warpgroup's query block (rows past B are zero) as its bf16
  // parts in the swizzled A layout (int8 queries: as they are, 128 B a row).
  constexpr int kQPart = kWG * P::kQ;     // from one part to the next
  const int qoff = wg * P::kQ;
  if constexpr (P::kI8) {
    const int8_t* q8 = reinterpret_cast<const int8_t*>(a.q);
    for (int i = t; i < kM * 8; i += kWGThreads) {
      const int m = i / 8, c = i % 8;
      const uint4 x =
          m < nq ? *reinterpret_cast<const uint4*>(q8 + (long long)(q0 + m) * kDim + 16 * c)
                 : make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(sm + P::q + qoff + swz8(m, c)) = x;
    }
  } else
  for (int i = t; i < kM * (kDim / 8); i += kWGThreads) {
    const int m = i / (kDim / 8), k = (i % (kDim / 8)) * 8;
    float x[8];
    if (m < nq) {
      const float4* src = reinterpret_cast<const float4*>(
          a.q + (long long)(q0 + m) * kDim + k);
      const float4 u = src[0], w = src[1];
      x[0] = u.x; x[1] = u.y; x[2] = u.z; x[3] = u.w;
      x[4] = w.x; x[5] = w.y; x[6] = w.z; x[7] = w.w;
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) x[e] = 0.f;
    }
    uint4 part[P::kParts];
    split8<P::kParts>(x, part);
    const int off = swz(kM, m, k);
#pragma unroll
    for (int j = 0; j < P::kParts; ++j)
      *reinterpret_cast<uint4*>(sm + P::q + j * kQPart + qoff + off) = part[j];
  }
  fence_async_smem();
  // The warpgroup's barrier and its vote, once: the epilogue's
  // predicate-free body when none of its live queries carries a predicate
  // (the anatomy's earlier stages keep the predicated one, so the probe
  // still times the mask).
  open = wg_all(wg, kStop == kFull && open);
  if (open && nq > 0 && t == 0 && a.open_wg != nullptr) atomicAdd(a.open_wg, 1);

  typename Key::T top[kE][RR];
#pragma unroll
  for (int e = 0; e < kE; ++e)
#pragma unroll
    for (int r = 0; r < RR; ++r) top[e][r] = Key::empty();

  typename std::conditional<P::kI8, int, float>::type acc[kE];
#pragma unroll
  for (int e = 0; e < kE; ++e) acc[e] = 0;
  // query part j at qa + j·kQPart; slice part j at va + j·kV
  const uint32_t qa = base + P::q + qoff, va = base + P::split;
  for (int s = 0; s < kSlices; ++s) {
    const int st = s % kStages;
    unsigned char* stage = sm + P::ring + st * P::kStage;
    if (!kDirect) consumers_sync<kWG>(wg);   // the last products are done with the parts
    mbar_wait(full + 8 * st, (s / kStages) & 1);
    if (!kDirect) {
      // Split the fp32 slice (row-major, 512 B a row) into the swizzled
      // bf16 parts, all consumers sharing the work.
      for (int i = tid; i < NB * (kDim / 8); i += kConsumers) {
        const int m = i / (kDim / 8), k = (i % (kDim / 8)) * 8;
        const float4* src = reinterpret_cast<const float4*>(stage + m * 512 + k * 4);
        const float4 u = src[0], w = src[1];
        const float x[8] = {u.x, u.y, u.z, u.w, w.x, w.y, w.z, w.w};
        uint4 part[P::kParts];
        split8<P::kParts>(x, part);
        const int off = swz(NB, m, k);
#pragma unroll
        for (int j = 0; j < P::kParts; ++j)
          *reinterpret_cast<uint4*>(sm + P::split + j * P::kV + off) = part[j];
      }
      fence_async_smem();
      consumers_sync<kWG>(wg);
    }
    fence_acc<NB>(acc);
    wgmma_fence();
    if constexpr (kPasses == 1) {
      product<NB, true>(acc, qa, base + P::ring + st * P::kStage);
    } else if constexpr (kPasses == 0) {
      product_s8<NB>(acc, qa, base + P::ring + st * P::kStage);
    } else if constexpr (kPasses == 3) {        // qhi·Vhi + qhi·Vlo + qlo·Vhi
      product<NB, true>(acc, qa, va);
      product<NB, false>(acc, qa, va + P::kV);
      product<NB, false>(acc, qa + kQPart, va);
    } else {      // ql·Vh + qm·Vm + qh·Vl + qm·Vh + qh·Vm + qh·Vh
      product<NB, true>(acc, qa + 2 * kQPart, va);
      product<NB, false>(acc, qa + kQPart, va + P::kV);
      product<NB, false>(acc, qa, va + 2 * P::kV);
      product<NB, false>(acc, qa + kQPart, va);
      product<NB, false>(acc, qa, va + P::kV);
      product<NB, false>(acc, qa, va);
    }
    wgmma_commit();
    wgmma_wait();
    fence_acc<NB>(acc);

    // Branch-free over the fragment (a warp-wide branch would be taken
    // almost always): each element's entry goes down its list (Key); a
    // masked entry is +inf, which the insert passes through, as it does
    // any entry not below the list's R-th.
    const float* sC = reinterpret_cast<const float*>(stage + P::kPlane);
    const float* sT = sC + NB;
    const float* sdn = sT + NB;
    const int* soid = reinterpret_cast<const int*>(sdn + NB);
    if constexpr (kStop == kFull) {
      // The vote's body, uniform across the warpgroup and the same every
      // slice. (The whole slice loop instantiated once a body made the
      // predicated one 2 % slower: more spills at 168 registers, PERF.md.)
      if (open) {
        // No predicate: a dead column (oid ≥ sn, past nb too) takes ‖d‖² =
        // +inf, so its distance is +inf and its entry (0x7F800000 | s, or
        // K4's (+inf, s)) never goes below an empty slot: each list ends as
        // the predicated body leaves it (a live row's distance is finite, as
        // the data is). C and T are not read.
#pragma unroll
        for (int j = 0; j < NB / 8; ++j) {
          const int c0 = 8 * j + 2 * (lane & 3);      // this thread's column pair
          const float2 dn2 = *reinterpret_cast<const float2*>(sdn + c0);
          const int2 oid2 = *reinterpret_cast<const int2*>(soid + c0);
          const float dn[2] = {oid2.x < a.sn ? dn2.x : kInf, oid2.y < a.sn ? dn2.y : kInf};
#pragma unroll
          for (int e = 4 * j; e < 4 * j + 4; ++e) {
            typename Key::T k =
                Key::entry(Key::value(qd_of(acc[e]), dn[e & 1], qn[(e >> 1) & 1]), s);
#pragma unroll
            for (int r = 0; r < RR; ++r) Key::insert(top[e][r], k);   // carry the larger down
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < NB / 8; ++j) {
          const int c0 = 8 * j + 2 * (lane & 3);      // this thread's column pair
          const float2 C2 = *reinterpret_cast<const float2*>(sC + c0);
          const float2 T2 = *reinterpret_cast<const float2*>(sT + c0);
          const float2 dn2 = *reinterpret_cast<const float2*>(sdn + c0);
          const int2 oid2 = *reinterpret_cast<const int2*>(soid + c0);
          const bool live[2] = {oid2.x < a.sn, oid2.y < a.sn};
#pragma unroll
          for (int e = 4 * j; e < 4 * j + 4; ++e) {
            const int h = e & 1, g = (e >> 1) & 1;
            const float Cb = h ? C2.y : C2.x, Tb = h ? T2.y : T2.x;
            const float d = Key::value(qd_of(acc[e]), h ? dn2.y : dn2.x, qn[g]);
            const bool ok = live[h] && Cb >= clo[g] && Cb <= chi[g] && Tb >= tlo[g] &&
                            Tb <= thi[g];
            typename Key::T k = ok ? Key::entry(d, s) : Key::empty();
#pragma unroll
            for (int r = 0; r < RR; ++r) Key::insert(top[e][r], k);   // carry the larger down
          }
        }
      }
    } else {
      // The anatomy's earlier stages (Stage): the same values up to where
      // the stage stops, each kept as the running min of its bits (every
      // value is ≥ +0.0 from dist on, so the int order is the float order)
      // or, for kPack, the keys' top R. Columns past nb are never emitted.
#pragma unroll
      for (int j = 0; j < NB / 8; ++j) {
        const int c0 = 8 * j + 2 * (lane & 3);
        const float2 C2 = *reinterpret_cast<const float2*>(sC + c0);
        const float2 T2 = *reinterpret_cast<const float2*>(sT + c0);
        const float2 dn2 = *reinterpret_cast<const float2*>(sdn + c0);
        const int2 oid2 = *reinterpret_cast<const int2*>(soid + c0);
#pragma unroll
        for (int e = 4 * j; e < 4 * j + 4; ++e) {
          const int h = e & 1, g = (e >> 1) & 1;
          const float x = qd_of(acc[e]);
          if constexpr (kStop == kMm || kStop == kMmb) {
            const float y = kStop == kMmb ? __bfloat162float(__float2bfloat16_rn(x)) : x;
            top[e][0] = __float_as_int(fminf(__int_as_float(top[e][0]), y));
          } else {
            const float d = __fadd_rn(__fmaf_rn(-2.f, x, h ? dn2.y : dn2.x), qn[g]);
            const int bits = max(__float_as_int(d), 0);
            if constexpr (kStop == kDist) {
              top[e][0] = min(top[e][0], bits);
            } else if constexpr (kStop == kMask) {
              const float Cb = h ? C2.y : C2.x, Tb = h ? T2.y : T2.x;
              const bool ok = (h ? oid2.y : oid2.x) < a.sn && Cb >= clo[g] &&
                              Cb <= chi[g] && Tb >= tlo[g] && Tb <= thi[g];
              top[e][0] = min(top[e][0], ok ? bits : kInfKey);
            } else {                          // kPack
              int k = (bits & kKeyMask) | s;
#pragma unroll
              for (int r = 0; r < RR; ++r) {
                const int lo = min(top[e][r], k);
                k = max(top[e][r], k);
                top[e][r] = lo;
              }
            }
          }
        }
      }
    }
    mbar_arrive(empty + 8 * st);
  }

  // Entry r of column c for query q0 + m: out[q0 + m, col(c) + r·bins].
  // (q0 + m < B is m < nq, without keeping nq live across the slice loop.)
  const long long W = (long long)a.ntw * a.R * a.bins;   // an output row
#pragma unroll
  for (int e = 0; e < kE; ++e) {
    const int c = 8 * (e / 4) + 2 * (lane & 3) + (e & 1);
    const int m = 16 * warp + lane / 4 + 8 * ((e >> 1) & 1);
    if (q0 + m >= a.B || c >= lay.nb) continue;
    const long long o = (long long)(q0 + m) * W + lay.col(a, c);
    if constexpr (kStop >= kPack) {
#pragma unroll
      for (int r = 0; r < RR; ++r) {
        if (r >= a.R) break;
        Key::emit(lay, a, o + (long long)r * a.bins, c, top[e][r]);
      }
    } else {      // the min's bits in entry 0, zeros in entries 1..R−1
      lay.emit(a, o, c, top[e][0]);
      for (int r = 1; r < a.R; ++r) lay.emit(a, o + (long long)r * a.bins, c, 0);
    }
  }
}

// Encodes the plane's tensor map and launches one instantiation. Returns a
// cudaError_t, or −CUresult (< 0) when the map cannot be encoded.
template <class L, int kPasses, int NB, int kWG, int RR, int kStages, int kStop = kFull,
          class Key = PackedKey>
int launch_wgmma(Args a, cudaStream_t stream) {
  using P = Plan<kPasses, NB, kWG, kStages>;
  EncodeTiled enc = encode_fn();
  if (enc == nullptr) return cudaErrorSymbolNotFound;
  CUtensorMap plane;
  const CUresult res = L::encode(enc, &plane, a, NB, P::kElem);
  if (res != CUDA_SUCCESS) return -(int)res;
  a.nqb = (a.B + kWG * kM - 1) / (kWG * kM);
  a.nbb = L::bin_blocks(a, NB);
  const long long blocks = L::blocks(a);
  if (blocks > 0x7FFFFFFFLL) return cudaErrorInvalidConfiguration;
  auto kernel = scan_wgmma<L, kPasses, NB, kWG, RR, kStages, kStop, Key>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::smem);
  if (e != cudaSuccess) return e;
  kernel<<<(unsigned)blocks, kWG * kWGThreads + 32, P::smem, stream>>>(plane, a);
  return cudaGetLastError();
}

// The tensor-core body at bin depth R ≤ 8: NB4 bins a CTA for R ≤ 4, 32
// above, with the top-R held at 1, 2, 3, 4, 6 or 8 entries.
template <class L, int kPasses, int NB4, int kWG, int kStages, class Key = PackedKey>
int launch_wgmma_r(const Args& a, cudaStream_t stream) {
  static_assert(kMaxWgmmaR == 8, "one case per register list length");
  switch (a.R) {
    case 1: return launch_wgmma<L, kPasses, NB4, kWG, 1, kStages, kFull, Key>(a, stream);
    case 2: return launch_wgmma<L, kPasses, NB4, kWG, 2, kStages, kFull, Key>(a, stream);
    case 3: return launch_wgmma<L, kPasses, NB4, kWG, 3, kStages, kFull, Key>(a, stream);
    case 4: return launch_wgmma<L, kPasses, NB4, kWG, 4, kStages, kFull, Key>(a, stream);
    case 5:
    case 6: return launch_wgmma<L, kPasses, 32, kWG, 6, kStages, kFull, Key>(a, stream);
    default: return launch_wgmma<L, kPasses, 32, kWG, 8, kStages, kFull, Key>(a, stream);
  }
}

}  // namespace
