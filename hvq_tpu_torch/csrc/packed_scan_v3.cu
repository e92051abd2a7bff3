// Packed bin scan K1 for Hopper (sm_90a).
//
// Replaces hvq_tpu/ops/pallas_scan.py::fused_packed_scan_v3 (kernel body
// _make_packed_kernel_v3). Plain PyTorch version beside it:
// hvq_tpu_torch/ops/scan.py::packed_scan_plain; Python wrapper and launch
// counters: hvq_tpu_torch/ops/kernels.py::packed_scan_v3.
//
// What it computes (the axis1 layout; bins = db_tile / 128):
//   dist = max((‖d‖² − 2·q·d) + ‖q‖², 0), +inf unless
//          oid < sn ∧ (¬ac ∨ C == v) ∧ (¬at ∨ l ≤ T ≤ r)
//   key  = bitcast(dist) & ~0x7F | s
// for row tile·Dt + s·bins + b, s ∈ [0, 128). Bin b of a tile keeps its
// R smallest keys in ascending order; a bin with fewer than R unmasked rows
// pads with the key of +inf at payload 0 (0x7F800000), exactly what the
// TPU kernel's R min rounds emit. Output is already decoded:
//   dist[q, tile·R·bins + j·bins + b] = key & ~0x7F   (as fp32)
//   pos [q, same column]              = (t0+tile)·Dt + (key & 0x7F)·bins + b
//
// Arithmetic: the TPU kernel's own. q·d is a bf16 product with fp32
// accumulation on the tensor cores (wgmma): one pass qhi·d on the bf16
// plane, the 3-pass split qhi·dhi + qhi·dlo + qlo·dhi on the fp32 plane,
// chained into one accumulator (hi = bf16_rn(x), lo = bf16_rn(x − hi), as
// pallas_scan.py:975-984 and :1067-1069).
//
// What bounds it on this card. The product needs 2·B·n·100 FLOP a pass
// (the vectors have 100 lanes; the rows are stored zero-padded to 128 and
// the kernel multiplies all 128): at the main-path batch (B = 1024) 800
// FLOP per byte of the bf16 plane, so on the 989 TFLOP/s tensor cores the
// product, not HBM, is the bound (2.07 ms at D = 10⁷). Past the product every (query, row) pair
// costs CUDA-core instructions (distance, clamp, mask, key, min/max
// insert); measured, that epilogue and not the product sets the time.
//
// Two bodies, chosen by R (dispatch on shape, not a fallback):
//
// * wgmma (R ≤ 8). A warpgroup owns 64 queries (the wgmma M) × NB bins of
//   one tile and streams the tile's 128 slices; slice s of the bin range
//   is NB contiguous rows at tile_row + s·bins + b0, one TMA box. One
//   producer warp keeps a ring of slices in flight: the plane rows by TMA,
//   C, T, ‖d‖² and oid by cp.async, both completing on the slice's
//   mbarrier. The consumer warpgroup(s) run m64nNBk16 wgmma from the
//   128B-swizzled query block and slice, then the epilogue on the
//   accumulator fragment in registers. The fragment's (query, bin) mapping
//   is the same for every slice, so each thread keeps the running top-R of
//   its own fragment elements in registers across all 128 slices, updated
//   branch-free by a min/max pass (a masked key is +inf and passes
//   through). NB = 64 for R ≤ 4 on the bf16 plane, 32 otherwise (lists
//   held at 6 or 8 for R ≤ 8), so the ladder's 2R = 6 also stays in
//   registers. On the bf16 plane two warpgroups (128 queries) share each
//   slice; on the fp32 plane two CTAs share an SM.
// * simt (R > 8: small databases and deep reruns only). The CUDA-core body
//   of the first port: IEEE fp32 FMAs over the 128 lanes in order (the
//   worst-order fp32 sum the certificate's slack already covers), top-R
//   lists in shared memory with the R-th key cached in a register.
//
// Keys are distinct through the payload, so the running top-R equals the
// R min rounds bit for bit. Launch order puts the query blocks of one
// (tile, bin range) next to each other, so a slice is read from HBM once
// and from L2 after.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

namespace {

constexpr int kSlices = 128;        // rows per bin = payload range
constexpr int kDim = 128;           // padded vector width
constexpr int kInfKey = 0x7F800000;
constexpr int kKeyMask = ~0x7F;
constexpr int kMaxWgmmaR = 8;       // largest R on the wgmma body

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
  int sn, B, db_tile, bins, R, t0, ntw, nbb, nqb, QB;
};

// ---------------------------------------------------------------- wgmma body

constexpr int kM = 64;              // queries per warpgroup (wgmma M)
constexpr int kWGThreads = 128;     // one consumer warpgroup

// Shared-memory plan of one CTA of kWG consumer warpgroups, in bytes from a
// 1024-aligned base. Every operand that wgmma reads (queries, bf16 slices)
// starts 1024-aligned: the 128B swizzle repeats every 8 rows of 128 bytes.
template <bool kBf16, int NB, int kWG>
struct Plan {
  static constexpr int kStages = 3;                        // slices in flight
  static constexpr int kQ = kM * kDim * 2;                 // one bf16 query block
  static constexpr int kQlo = kBf16 ? 0 : kQ;
  static constexpr int kSplit = kBf16 ? 0 : 2 * NB * kDim * 2;  // Vhi, Vlo
  static constexpr int kPlane = NB * kDim * (kBf16 ? 2 : 4);    // one slice
  static constexpr int kAttr = 4 * NB * 4;                 // C, T, dn, oid
  static constexpr int kStage = ((kPlane + kAttr + 1023) / 1024) * 1024;
  static constexpr int qhi = 0;                            // [kWG] blocks
  static constexpr int qlo = qhi + kWG * kQ;
  static constexpr int split = qlo + kWG * kQlo;
  static constexpr int ring = split + kSplit;
  static constexpr int bars = ring + kStages * kStage;
  static constexpr int bytes = bars + 2 * kStages * 8;
  static constexpr int smem = bytes + 1024;                // alignment slack
  static constexpr uint32_t tx = kPlane;                   // TMA bytes a slice
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

// The 8 k-steps of one 128-lane product: A (64 × 128) and B (NB × 128),
// both K-major and swizzled; step k moves 32 bytes inside a 64-k block.
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

// hi = bf16_rn(x), lo = bf16_rn(x − hi) of 8 values, packed as 16 bytes
// each (element i at the lower address of its pair).
__device__ __forceinline__ void split8(const float (&x)[8], uint4& hi, uint4& lo) {
  uint32_t h[4], l[4];
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    uint32_t hw = 0, lw = 0;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const __nv_bfloat16 bh = __float2bfloat16_rn(x[2 * p + e]);
      const __nv_bfloat16 bl = __float2bfloat16_rn(x[2 * p + e] - __bfloat162float(bh));
      hw |= (uint32_t)__bfloat16_as_ushort(bh) << (16 * e);
      lw |= (uint32_t)__bfloat16_as_ushort(bl) << (16 * e);
    }
    h[p] = hw; l[p] = lw;
  }
  hi = make_uint4(h[0], h[1], h[2], h[3]);
  lo = make_uint4(l[0], l[1], l[2], l[3]);
}

// kWG consumer warpgroups (64 queries each) share the ring, so a slice is
// read once for 64·kWG queries; RR is the list length held in registers
// (R rounded up to 1, 2, 3, 4, 6, 8).
template <bool kBf16, int NB, int kWG, int RR>
__global__ void __launch_bounds__(kWG * kWGThreads + 32, kWG == 1 ? 2 : 1)
k1_wgmma(__grid_constant__ const CUtensorMap plane, Args a) {
  using P = Plan<kBf16, NB, kWG>;
  static_assert(kBf16 || kWG == 1, "the fp32 split buffers serve one warpgroup");
  constexpr int kConsumers = kWG * kWGThreads;
  // Round the dynamic base up to 1024 by offsetting the shared array itself,
  // so every access below stays a shared-memory access (LDS, not LD).
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(sm);
  constexpr int kStages = P::kStages;
  const uint32_t full = base + P::bars, empty = full + 8 * kStages;

  const int tid = threadIdx.x;
  const int qblk = blockIdx.x % a.nqb;    // query blocks of a slice adjacent
  const int rest = blockIdx.x / a.nqb;
  const int bblk = rest % a.nbb;
  const int tile = rest / a.nbb;          // window-local tile
  const int b0 = bblk * NB;
  const int nb = min(NB, a.bins - b0);
  const long long tile_row = (long long)(a.t0 + tile) * a.db_tile;

  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full + 8 * i, 33);
      mbar_init(empty + 8 * i, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
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
      const long long row = tile_row + (long long)s * a.bins + b0;
      const uint32_t dst = base + P::ring + st * P::kStage;
      for (int c = lane; c < nb; c += 32) {
        cp_async4(dst + P::kPlane + 4 * c, a.C + row + c);
        cp_async4(dst + P::kPlane + 4 * (NB + c), a.T + row + c);
        cp_async4(dst + P::kPlane + 4 * (2 * NB + c), a.dn + row + c);
        cp_async4(dst + P::kPlane + 4 * (3 * NB + c), a.oid + row + c);
      }
      cp_async_arrive(bar);
      if (lane == 0) {
        mbar_expect_tx(bar, P::tx);
        tma_2d(dst, &plane, 0, (int)row, bar);
        if (kBf16) tma_2d(dst + NB * 128, &plane, 64, (int)row, bar);
      }
    }
    return;
  }

  const int wg = tid / kWGThreads, t = tid % kWGThreads;
  const int q0 = (qblk * kWG + wg) * kM;
  const int nq = min(kM, a.B - q0);
  if (nq <= 0) {            // a warpgroup past B only keeps the ring turning
    for (int s = 0; s < kSlices; ++s) {
      mbar_wait(full + 8 * (s % kStages), (s / kStages) & 1);
      mbar_arrive(empty + 8 * (s % kStages));
    }
    return;
  }

  // Stage this warpgroup's query block (rows past B are zero) as bf16 hi
  // (and lo on the fp32 plane) in the swizzled A layout.
  const int qoff = wg * P::kQ;
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
    uint4 hi, lo;
    split8(x, hi, lo);
    const int off = swz(kM, m, k);
    *reinterpret_cast<uint4*>(sm + P::qhi + qoff + off) = hi;
    if (!kBf16) *reinterpret_cast<uint4*>(sm + P::qlo + qoff + off) = lo;
  }
  fence_async_smem();
  wg_sync(wg);

  // This thread's fragment: rows 16·warp + lane/4 + 8g, columns
  // 8j + 2·(lane % 4) + h, accumulator element 4j + 2g + h. Each row's
  // predicate as closed bounds on C and T: [v, v] for C == v, [l, r] for
  // the T range, (−inf, inf) when inactive, an empty C range for rows past
  // B. (A NaN attribute never passes; data has none.)
  constexpr int kE = NB / 2;              // fragment elements a thread
  const int warp = t / 32, lane = t % 32;
  const float kInf = __int_as_float(0x7F800000);
  float qn[2], clo[2], chi[2], tlo[2], thi[2];
#pragma unroll
  for (int g = 0; g < 2; ++g) {
    const int m = 16 * warp + lane / 4 + 8 * g;
    const bool live = m < nq;
    const int gq = q0 + (live ? m : 0);
    const bool ac = a.ac[gq] != 0, at = a.at[gq] != 0;
    qn[g] = a.qn[gq];
    clo[g] = !live ? kInf : ac ? a.v[gq] : -kInf;
    chi[g] = ac ? a.v[gq] : kInf;
    tlo[g] = at ? a.l[gq] : -kInf;
    thi[g] = at ? a.r[gq] : kInf;
  }
  int top[kE][RR];
#pragma unroll
  for (int e = 0; e < kE; ++e)
#pragma unroll
    for (int r = 0; r < RR; ++r) top[e][r] = kInfKey;

  float acc[kE];
#pragma unroll
  for (int e = 0; e < kE; ++e) acc[e] = 0.f;
  const uint32_t qhi = base + P::qhi + qoff, qlo = base + P::qlo + qoff;
  const uint32_t vhi = base + P::split, vlo = vhi + NB * kDim * 2;
  for (int s = 0; s < kSlices; ++s) {
    const int st = s % kStages;
    unsigned char* stage = sm + P::ring + st * P::kStage;
    if (!kBf16) wg_sync(wg);   // the last product is done with Vhi/Vlo
    mbar_wait(full + 8 * st, (s / kStages) & 1);
    if (!kBf16) {
      // Split the fp32 slice (row-major, 512 B a row) into the swizzled
      // bf16 hi and lo operands.
      for (int i = t; i < NB * (kDim / 8); i += kWGThreads) {
        const int m = i / (kDim / 8), k = (i % (kDim / 8)) * 8;
        const float4* src = reinterpret_cast<const float4*>(stage + m * 512 + k * 4);
        const float4 u = src[0], w = src[1];
        const float x[8] = {u.x, u.y, u.z, u.w, w.x, w.y, w.z, w.w};
        uint4 hi, lo;
        split8(x, hi, lo);
        const int off = swz(NB, m, k);
        *reinterpret_cast<uint4*>(sm + P::split + off) = hi;
        *reinterpret_cast<uint4*>(sm + P::split + NB * kDim * 2 + off) = lo;
      }
      fence_async_smem();
      wg_sync(wg);
    }
    fence_acc<NB>(acc);
    wgmma_fence();
    if (kBf16) {
      product<NB, true>(acc, qhi, base + P::ring + st * P::kStage);
    } else {
      product<NB, true>(acc, qhi, vhi);     // qhi·Vhi
      product<NB, false>(acc, qhi, vlo);    // + qhi·Vlo
      product<NB, false>(acc, qlo, vhi);    // + qlo·Vhi
    }
    wgmma_commit();
    wgmma_wait();
    fence_acc<NB>(acc);

    // Branch-free over the fragment (a warp-wide branch would be taken
    // almost always): (‖d‖² − 2·q·d) + ‖q‖² in the TPU kernel's order
    // (2·q·d is exact, so one fma rounds as the subtraction does); the
    // integer max maps −0.0 and below to +0.0, whose key would otherwise
    // sort first; a masked key becomes +inf, which the min/max insert
    // passes through, as it does any key not below the list's R-th.
    const float* sC = reinterpret_cast<const float*>(stage + P::kPlane);
    const float* sT = sC + NB;
    const float* sdn = sT + NB;
    const int* soid = reinterpret_cast<const int*>(sdn + NB);
#pragma unroll
    for (int j = 0; j < NB / 8; ++j) {
      const int c0 = 8 * j + 2 * (lane & 3);      // this thread's column pair
      const float2 C2 = *reinterpret_cast<const float2*>(sC + c0);
      const float2 T2 = *reinterpret_cast<const float2*>(sT + c0);
      const float2 dn2 = *reinterpret_cast<const float2*>(sdn + c0);
      const int2 oid2 = *reinterpret_cast<const int2*>(soid + c0);
      const bool live[2] = {c0 < nb && oid2.x < a.sn, c0 + 1 < nb && oid2.y < a.sn};
#pragma unroll
      for (int e = 4 * j; e < 4 * j + 4; ++e) {
        const int h = e & 1, g = (e >> 1) & 1;
        const float Cb = h ? C2.y : C2.x, Tb = h ? T2.y : T2.x;
        const float d = __fadd_rn(__fmaf_rn(-2.f, acc[e], h ? dn2.y : dn2.x), qn[g]);
        const bool ok = live[h] && Cb >= clo[g] && Cb <= chi[g] && Tb >= tlo[g] &&
                        Tb <= thi[g];
        int k = ok ? (max(__float_as_int(d), 0) & kKeyMask) | s : kInfKey;
#pragma unroll
        for (int r = 0; r < RR; ++r) {     // carry the larger of each pair down
          const int lo = min(top[e][r], k);
          k = max(top[e][r], k);
          top[e][r] = lo;
        }
      }
    }
    mbar_arrive(empty + 8 * st);
  }

  const long long W = (long long)a.ntw * a.R * a.bins;
  const long long col0 = (long long)tile * a.R * a.bins + b0;
#pragma unroll
  for (int e = 0; e < kE; ++e) {
    const int c = 8 * (e / 4) + 2 * (lane & 3) + (e & 1);
    const int m = 16 * warp + lane / 4 + 8 * ((e >> 1) & 1);
    if (m >= nq || c >= nb) continue;
#pragma unroll
    for (int r = 0; r < RR; ++r) {
      if (r >= a.R) break;
      const int key = top[e][r];
      const long long o = (long long)(q0 + m) * W + col0 + (long long)r * a.bins + c;
      a.out_d[o] = __int_as_float(key & kKeyMask);
      a.out_p[o] = (int)(tile_row + (long long)(key & 0x7F) * a.bins + b0 + c);
    }
  }
}

// ----------------------------------------------------------------- simt body
constexpr int kNB = 64;             // bins per CTA
constexpr int kNBP = kNB + 4;       // padded smem row of the staged slice
constexpr int kTQ = 4;              // queries per thread
constexpr int kTB = 4;              // bins per thread
constexpr int kMaxQB = 64;
// Dynamic shared memory a CTA aims to stay under, so two CTAs share an SM.
constexpr size_t kSmemTarget = 100 * 1024;
static_assert(kTQ % 4 == 0 && kTB % 4 == 0, "register tiles load float4s");
static_assert(kNB % kTB == 0 && kNB % 8 == 0, "bin range splits evenly");

// Shared memory of a simt CTA: queries, one staged slice, its attributes
// and the top-R lists.
size_t simt_smem(int QB, int R) {
  return sizeof(float) * ((size_t)kDim * QB + (size_t)kDim * kNBP + 4 * kNB)
         + sizeof(int) * (size_t)QB * kNB * R;
}

__device__ __forceinline__ void load4(const float* V, long long off, float* x) {
  float4 t = *reinterpret_cast<const float4*>(V + off);
  x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* V, long long off,
                                      float* x) {
  uint2 t = *reinterpret_cast<const uint2*>(V + off);
  __nv_bfloat162 a = *reinterpret_cast<__nv_bfloat162*>(&t.x);
  __nv_bfloat162 b = *reinterpret_cast<__nv_bfloat162*>(&t.y);
  float2 fa = __bfloat1622float2(a), fb = __bfloat1622float2(b);
  x[0] = fa.x; x[1] = fa.y; x[2] = fb.x; x[3] = fb.y;
}

template <typename VT>
__global__ void __launch_bounds__(256, 2)
k1_simt(Args a) {
  extern __shared__ float smem[];
  const int QB = a.QB;
  float* qs = smem;                       // [kDim][QB]   transposed queries
  float* vs = qs + kDim * QB;             // [kDim][kNBP] transposed slice
  float* sC = vs + kDim * kNBP;           // [kNB] slice attributes
  float* sT = sC + kNB;
  float* sdn = sT + kNB;
  int* soid = reinterpret_cast<int*>(sdn + kNB);
  int* lists = soid + kNB;                // [QB][kNB][R] sorted keys

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int tb = tid % (kNB / kTB);
  const int tq = tid / (kNB / kTB);
  const int qblk = blockIdx.x % a.nqb;    // query blocks of a slice adjacent
  const int rest = blockIdx.x / a.nqb;
  const int bblk = rest % a.nbb;
  const int tile = rest / a.nbb;          // window-local tile
  const int q0 = qblk * QB;
  const int b0 = bblk * kNB;
  const int nq = min(QB, a.B - q0);
  const int nb = min(kNB, a.bins - b0);
  const int R = a.R;
  constexpr bool kBf16 = sizeof(VT) == 2;

  for (int i = tid; i < QB * kDim; i += nthreads) {
    const int qq = i / kDim, k = i % kDim;
    float x = 0.f;
    if (qq < nq) {
      x = a.q[(long long)(q0 + qq) * kDim + k];
      if (kBf16) x = __bfloat162float(__float2bfloat16_rn(x));
    }
    qs[k * QB + qq] = x;
  }
  for (int i = tid; i < QB * kNB * R; i += nthreads) lists[i] = kInfKey;

  float qn[kTQ], qv[kTQ], ql[kTQ], qr[kTQ];
  bool qok[kTQ], qac[kTQ], qat[kTQ];
#pragma unroll
  for (int i = 0; i < kTQ; ++i) {
    const int qq = tq * kTQ + i;
    qok[i] = qq < nq;
    const int g = q0 + (qok[i] ? qq : 0);
    qn[i] = a.qn[g]; qv[i] = a.v[g]; ql[i] = a.l[g]; qr[i] = a.r[g];
    qac[i] = a.ac[g] != 0; qat[i] = a.at[g] != 0;
  }
  int worst[kTQ][kTB];                    // the R-th key of each list
#pragma unroll
  for (int i = 0; i < kTQ; ++i)
#pragma unroll
    for (int j = 0; j < kTB; ++j) worst[i][j] = kInfKey;

  const VT* V = reinterpret_cast<const VT*>(a.V);
  const long long tile_row = (long long)(a.t0 + tile) * a.db_tile;
  for (int s = 0; s < kSlices; ++s) {
    __syncthreads();   // last slice's readers are done with vs / attributes
    const long long rbase = tile_row + (long long)s * a.bins + b0;
    // Stage rows [rbase, rbase + nb) transposed. A warp reads 8 rows × 4
    // chunks of 4 lanes: full 32-byte sectors, and the padded smem row
    // keeps the transposing stores at most 2-way bank-conflicted.
    for (int i = tid; i < kNB * (kDim / 4); i += nthreads) {
      const int grp = i / 32, lane = i % 32;
      const int b = (grp % (kNB / 8)) * 8 + lane % 8;
      const int c = (grp / (kNB / 8)) * 4 + lane / 8;
      float x[4] = {0.f, 0.f, 0.f, 0.f};
      if (b < nb) load4(V, (rbase + b) * kDim + 4 * c, x);
#pragma unroll
      for (int e = 0; e < 4; ++e) vs[(4 * c + e) * kNBP + b] = x[e];
    }
    for (int b = tid; b < kNB; b += nthreads) {
      const bool live = b < nb;
      sC[b] = live ? a.C[rbase + b] : 0.f;
      sT[b] = live ? a.T[rbase + b] : 0.f;
      sdn[b] = live ? a.dn[rbase + b] : 0.f;
      soid[b] = live ? a.oid[rbase + b] : 0;
    }
    __syncthreads();

    float acc[kTQ][kTB];
#pragma unroll
    for (int i = 0; i < kTQ; ++i)
#pragma unroll
      for (int j = 0; j < kTB; ++j) acc[i][j] = 0.f;
#pragma unroll 8
    for (int k = 0; k < kDim; ++k) {
      float qx[kTQ], vx[kTB];
#pragma unroll
      for (int i = 0; i < kTQ; i += 4)
        load4(qs, k * QB + tq * kTQ + i, qx + i);
#pragma unroll
      for (int j = 0; j < kTB; j += 4)
        load4(vs, k * kNBP + tb * kTB + j, vx + j);
#pragma unroll
      for (int i = 0; i < kTQ; ++i)
#pragma unroll
        for (int j = 0; j < kTB; ++j) acc[i][j] = fmaf(qx[i], vx[j], acc[i][j]);
    }

#pragma unroll
    for (int j = 0; j < kTB; ++j) {
      const int b = tb * kTB + j;
      if (b >= nb) continue;
      const bool in_sample = soid[b] < a.sn;
      const float Cb = sC[b], Tb = sT[b], dnb = sdn[b];
#pragma unroll
      for (int i = 0; i < kTQ; ++i) {
        const bool ok = qok[i] && in_sample && (!qac[i] || Cb == qv[i]) &&
                        (!qat[i] || (Tb >= ql[i] && Tb <= qr[i]));
        if (!ok) continue;
        float d = __fadd_rn(__fsub_rn(dnb, __fmul_rn(2.f, acc[i][j])), qn[i]);
        d = d > 0.f ? d : 0.f;
        const int key = (__float_as_int(d) & kKeyMask) | s;
        if (key >= worst[i][j]) continue;
        int* L = lists + ((tq * kTQ + i) * kNB + b) * R;
        int p = R - 1;
        while (p > 0 && L[p - 1] > key) {
          L[p] = L[p - 1];
          --p;
        }
        L[p] = key;
        worst[i][j] = L[R - 1];
      }
    }
  }
  const long long W = (long long)a.ntw * R * a.bins;
  const long long col0 = (long long)tile * R * a.bins + b0;
  __syncthreads();
  for (int i = tid; i < QB * R * kNB; i += nthreads) {
    const int b = i % kNB;
    const int j = (i / kNB) % R;
    const int qq = i / (kNB * R);
    if (qq >= nq || b >= nb) continue;
    const int key = lists[(qq * kNB + b) * R + j];
    const long long o = (long long)(q0 + qq) * W + col0 + (long long)j * a.bins + b;
    a.out_d[o] = __int_as_float(key & kKeyMask);
    a.out_p[o] = (int)(tile_row + (long long)(key & 0x7F) * a.bins + b0 + b);
  }
}

template <typename VT>
cudaError_t launch_simt(Args a, cudaStream_t stream) {
  int QB = kMaxQB;
  while (QB > kTQ && simt_smem(QB, a.R) > kSmemTarget) QB /= 2;
  a.QB = QB;
  a.nqb = (a.B + QB - 1) / QB;
  a.nbb = (a.bins + kNB - 1) / kNB;
  const size_t smem = simt_smem(QB, a.R);
  const long long blocks = (long long)a.nqb * a.nbb * a.ntw;
  if (blocks > 0x7FFFFFFFLL) return cudaErrorInvalidConfiguration;
  cudaError_t e = cudaFuncSetAttribute(
      k1_simt<VT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const int threads = (QB / kTQ) * (kNB / kTB);
  k1_simt<VT><<<(unsigned)blocks, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

// ------------------------------------------------------------ host: wgmma

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

// Returns a cudaError_t, or −CUresult (< 0) when the plane's tensor map
// cannot be encoded.
template <bool kBf16, int NB, int kWG, int RR>
int launch_wgmma(Args a, long long n_pad, cudaStream_t stream) {
  using P = Plan<kBf16, NB, kWG>;
  EncodeTiled enc = encode_fn();
  if (enc == nullptr) return cudaErrorSymbolNotFound;
  // The plane: bf16 as two 64-lane boxes in the 128B swizzle (wgmma's B
  // layout); fp32 as one unswizzled 128-lane box, split in the kernel.
  CUtensorMap plane;
  const cuuint64_t dim[2] = {(cuuint64_t)kDim, (cuuint64_t)n_pad};
  const cuuint64_t stride[1] = {(cuuint64_t)kDim * (kBf16 ? 2 : 4)};
  const cuuint32_t box[2] = {(cuuint32_t)(kBf16 ? 64 : kDim), (cuuint32_t)NB};
  const cuuint32_t es[2] = {1, 1};
  const CUresult res = enc(
      &plane, kBf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
      2, const_cast<void*>(a.V), dim, stride, box, es, CU_TENSOR_MAP_INTERLEAVE_NONE,
      kBf16 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return -(int)res;
  a.nqb = (a.B + kWG * kM - 1) / (kWG * kM);
  a.nbb = (a.bins + NB - 1) / NB;
  const long long blocks = (long long)a.nqb * a.nbb * a.ntw;
  if (blocks > 0x7FFFFFFFLL) return cudaErrorInvalidConfiguration;
  auto kernel = k1_wgmma<kBf16, NB, kWG, RR>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::smem);
  if (e != cudaSuccess) return e;
  kernel<<<(unsigned)blocks, kWG * kWGThreads + 32, P::smem, stream>>>(plane, a);
  return cudaGetLastError();
}

template <bool kBf16>
int launch(const Args& a, long long n_pad, cudaStream_t stream) {
  static_assert(kMaxWgmmaR == 8, "one case per register list length");
  // bf16 plane: two warpgroups (128 queries) share a slice, 64 bins for
  // R ≤ 4; fp32 plane: one warpgroup and 32 bins (its split buffers fit two
  // CTAs an SM). Measured fastest of the shapes tried (PERF.md).
  constexpr int kNB4 = kBf16 ? 64 : 32, kWG = kBf16 ? 2 : 1;
  switch (a.R) {
    case 1: return launch_wgmma<kBf16, kNB4, kWG, 1>(a, n_pad, stream);
    case 2: return launch_wgmma<kBf16, kNB4, kWG, 2>(a, n_pad, stream);
    case 3: return launch_wgmma<kBf16, kNB4, kWG, 3>(a, n_pad, stream);
    case 4: return launch_wgmma<kBf16, kNB4, kWG, 4>(a, n_pad, stream);
    case 5:
    case 6: return launch_wgmma<kBf16, 32, kWG, 6>(a, n_pad, stream);
    case 7:
    case 8: return launch_wgmma<kBf16, 32, kWG, 8>(a, n_pad, stream);
    default:
      return launch_simt<typename std::conditional<kBf16, __nv_bfloat16, float>::type>(
          a, stream);
  }
}

}  // namespace

// Which body a scan at bin depth R runs: 0 = wgmma, 1 = simt.
extern "C" int hvq_packed_scan_v3_body(int R) { return R <= kMaxWgmmaR ? 0 : 1; }

// Plain C entry point for ctypes. Pointers are device pointers; the scan
// plane V is (n_pad, 128) fp32 (v_bf16 == 0) or bf16 (v_bf16 != 0); C, T,
// dn are (n_pad,) fp32, oid (n_pad,) int32; q (B, 128) fp32 (V and q
// 16-byte aligned), qn (B,) fp32 query norms, ac/at (B,) int32 flags, v/l/r (B,) fp32.
// The scan covers tiles [t0, t0 + ntw) of n_pad / db_tile. out_d / out_p
// are (B, ntw·bin_top·db_tile/128). Returns 0 on success, the cudaError_t
// of a failed launch, or −CUresult if the plane's tensor map cannot be
// encoded.
extern "C" int hvq_packed_scan_v3(
    const void* V, int v_bf16, const float* C, const float* T,
    const float* dn, const int* oid, const float* q, const float* qn,
    const int* ac, const float* v, const int* at, const float* l,
    const float* r, int sn, int B, int n_pad, int db_tile, int bin_top,
    int t0, int ntw, float* out_d, int* out_p, void* stream) {
  if (B < 1 || db_tile < kSlices || db_tile % kSlices || bin_top < 1 ||
      bin_top > kSlices || t0 < 0 || ntw < 1 || n_pad % db_tile ||
      (long long)(t0 + ntw) * db_tile > n_pad)
    return (int)cudaErrorInvalidValue;
  for (const void* p : {V, (const void*)q})   // TMA rows, float4 query loads
    if (reinterpret_cast<uintptr_t>(p) % 16) return (int)cudaErrorMisalignedAddress;
  Args a{V, C, T, dn, oid, q, qn, ac, v, at, l, r, out_d, out_p,
         sn, B, db_tile, db_tile / kSlices, bin_top, t0, ntw, 0, 0, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return v_bf16 ? launch<true>(a, n_pad, s) : launch<false>(a, n_pad, s);
}
