// Lane-layout bin scans K3, K2 and K4 for Hopper (sm_90a).
//
// Replaces, in hvq_tpu/ops/pallas_scan.py:
//   K3 fused_packed_scan     (kernel body _make_packed_kernel),
//   K2 fused_packed_scan_v2  (kernel body _make_packed_kernel_v2),
//   K4 fused_bin_scan        (kernel body _make_kernel).
// Plain PyTorch versions beside them: hvq_tpu_torch/ops/scan.py
// ::packed_scan_plain (layout="lane") and ::bin_scan_plain; Python
// wrappers and launch counters: hvq_tpu_torch/ops/kernels.py
// ::packed_scan, ::packed_scan_v2, ::bin_scan.
//
// What they compute. In the lane layout bin b of a tile is the 128
// CONTIGUOUS rows tile·Dt + b·128 + s, s ∈ [0, 128), and the lane s is the
// payload. With the mask
//   ok = oid < sn ∧ (¬ac ∨ C == v) ∧ (¬at ∨ l ≤ T ≤ r)
// K3 and K2 form K1's packed key (packed_scan_v3.cu),
//   dist = max((‖d‖² − 2·q·d) + ‖q‖², 0),  key = bitcast(dist) & ~0x7F | s,
// with q·d in the TPU kernels' own arithmetic: K3 asks for Precision.HIGH,
// which Mosaic runs as HIGHEST, the 6-pass bf16 emulation of fp32
// (pallas_scan.py:568-573, :769-772); K2 is the 3-pass bf16 split
// qhi·Vhi + qhi·Vlo + qlo·Vhi (:775-786). A bin keeps its R smallest keys
// ascending, padded with 0x7F800000 (+inf, payload 0), and the output is
// decoded:
//   dist[q, tile·R·bins + j·bins + b] = key & ~0x7F   (as fp32)
//   pos [q, same column]              = tile·Dt + b·128 + (key & 0x7F)
// K4 is unpacked: score = ‖d‖² − 2·q·d, with no ‖q‖² and no clamp (scores
// may be negative), +inf where masked, q·d at Precision.HIGHEST
// (pallas_scan.py:124-128), which Mosaic runs as the 6-pass bf16 emulation
// of fp32, as K3's. A bin keeps its R smallest (score, lane) pairs, ties to
// the lowest lane (argmin's first occurrence), padded with (+inf, lane 0) as
// argmin over an all-+inf bin gives, and reports (score, oid[row]); −0.0 is
// written as +0.0.
//
// What bounds them on this card: at the main-path batch (B = 1024) the
// product, not HBM: six bf16 passes for K3 and K4, three for K2, on the
// tensor cores (2·B·n·100 FLOP a pass).
//
// Two bodies, chosen by R (dispatch on shape, not a fallback):
//
// * wgmma (R ≤ 8: the lane paths' R = 4, the lane rung 1 at 2R = 8, K4's
//   own R = 2): scan_wgmma.cuh's body, K1's, in the Lane layout. A CTA owns
//   (128 queries in two warpgroups × 32 consecutive global bins g0 …),
//   which may span tiles; slice s is row g·128 + s of each bin, one box of
//   a 3-D tensor map over the plane, (128 lanes, 128 slices, nbins), loaded
//   at (0, s, g0); C, T, ‖d‖² and oid come by cp.async on the slice's
//   mbarrier. Both warpgroups split the fp32 slice in shared memory into 3
//   (K3, K4) or 2 (K2) swizzled bf16 parts, each its query block once; K3
//   and K4 chain their six products smallest first,
//   ql·Vh + qm·Vm + qh·Vl + qm·Vh + qh·Vm + qh·Vh, K2 its three, into one
//   fp32 accumulator; the epilogue and the register top-R are K1's, K4's
//   with its own key policy (BinKey: an (fp32 score, lane) pair an entry,
//   a strict < insert; K4 differs from K3 only there).
// * simt (R > 8): the CUDA-core structure of the first port. A CTA owns
//   (query block of QB, 64 consecutive global bins) and streams the 128
//   slices, each staged transposed in shared memory; each thread holds a
//   4×4 register tile of (query, bin) dot products in IEEE fp32 FMAs (K2:
//   three accumulators of the bf16 split, hi/lo packed in one staged word)
//   and a running top-R per (query, bin) in shared memory (K4: a 32-bit
//   ordered score and an 8-bit lane, 5 bytes an entry), the launcher
//   halving QB until the lists fit; keys are distinct through the lane, or
//   for K4 ordered by (score, lane) with the lanes arriving in increasing
//   order, so the running top-R equals R min (argmin) rounds bit for bit,
//   padding included.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "scan_wgmma.cuh"

namespace {

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

// The three kernels; the values are the C entry point's `mode`.
constexpr int kK3 = 0;   // packed keys, fp32 FMA
constexpr int kK2 = 1;   // packed keys, 3-pass bf16 split
constexpr int kK4 = 2;   // unpacked (score, lane), reports oid

template <int MODE> struct KeyOf { using T = int; };
template <> struct KeyOf<kK4> { using T = unsigned long long; };
// K4's empty entry: +inf (ordered 0xFF800000) at lane 0.
constexpr unsigned long long kInfPair = 0xFF800000ull << 32;
template <int MODE> __device__ __forceinline__ typename KeyOf<MODE>::T inf_key() {
  if constexpr (MODE == kK4) return kInfPair; else return kInfKey;
}

struct LaneArgs {
  const float* V;
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
  int* out_i;
  // bins: per tile; nbins: in all; nbb: 64-bin blocks; nqb: query blocks
  int sn, B, bins, nbins, R, nt, nbb, nqb, QB;
};

int entry_bytes(int mode) { return mode == kK4 ? 5 : 4; }

// Shared memory of a CTA: queries, one staged slice, its attributes and the
// top-R lists.
size_t smem_bytes(int mode, int QB, int R) {
  return sizeof(float) * ((size_t)kDim * QB + (size_t)kDim * kNBP + 4 * kNB)
         + (size_t)entry_bytes(mode) * QB * kNB * R;
}

__device__ __forceinline__ void load4(const float* V, long long off, float* x) {
  float4 t = *reinterpret_cast<const float4*>(V + off);
  x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
}

// K2's staged word: the bf16 hi half of x in the top 16 bits, the bf16
// rounding of the residual x − hi in the low 16 (the TPU kernel's split).
__device__ __forceinline__ float split_word(float x) {
  const __nv_bfloat16 hi = __float2bfloat16_rn(x);
  const __nv_bfloat16 lo = __float2bfloat16_rn(__fsub_rn(x, __bfloat162float(hi)));
  return __uint_as_float(((unsigned)__bfloat16_as_ushort(hi) << 16) |
                         __bfloat16_as_ushort(lo));
}
__device__ __forceinline__ float hi_of(float w) {
  return __uint_as_float(__float_as_uint(w) & 0xFFFF0000u);
}
__device__ __forceinline__ float lo_of(float w) {
  return __uint_as_float(__float_as_uint(w) << 16);
}

// Order-preserving uint32 image of a float; −0.0 first becomes +0.0, since
// argmin ties the two.
__device__ __forceinline__ unsigned ordered(float x) {
  const unsigned u = __float_as_uint(__fadd_rn(x, 0.f));
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float unordered(unsigned o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7FFFFFFFu) : ~o);
}

// Top-R lists in shared memory.
struct IntLists {           // packed keys
  int* key;
  __device__ int get(int i) const { return key[i]; }
  __device__ void set(int i, int k) const { key[i] = k; }
};
struct PairLists {          // K4: ordered score and lane, 5 bytes an entry
  unsigned* ord;
  unsigned char* lane;
  __device__ unsigned long long get(int i) const {
    return ((unsigned long long)ord[i] << 32) | lane[i];
  }
  __device__ void set(int i, unsigned long long k) const {
    ord[i] = (unsigned)(k >> 32);
    lane[i] = (unsigned char)(k & 0x7F);
  }
};

// Write entry j (round j) of global bin g for output row q.
template <int MODE>
__device__ __forceinline__ void emit(const LaneArgs& a, int q, int g, int j,
                                     typename KeyOf<MODE>::T key) {
  const int tile = g / a.bins;
  const long long o = (long long)q * a.nt * a.R * a.bins +
                      ((long long)tile * a.R + j) * a.bins + (g - tile * a.bins);
  const long long row0 = (long long)g * kSlices;
  if constexpr (MODE == kK4) {
    const int lane = (int)(key & 0x7F);
    a.out_d[o] = unordered((unsigned)(key >> 32));
    a.out_i[o] = a.oid[row0 + lane];
  } else {
    a.out_d[o] = __int_as_float(key & kKeyMask);
    a.out_i[o] = (int)(row0 + (key & 0x7F));
  }
}

// Any R, the top-R lists in shared memory. Register budget for two CTAs
// per SM; K2's three accumulators get one.
template <int MODE>
__global__ void __launch_bounds__(256, MODE == kK2 ? 1 : 2)
lane_scan_kernel(LaneArgs a) {
  using Key = typename KeyOf<MODE>::T;
  using Lists = typename std::conditional<MODE == kK4, PairLists, IntLists>::type;
  extern __shared__ float smem[];
  const int QB = a.QB;
  float* qs = smem;                       // [kDim][QB]   transposed queries
  float* vs = qs + kDim * QB;             // [kDim][kNBP] transposed slice
  float* sC = vs + kDim * kNBP;           // [kNB] slice attributes
  float* sT = sC + kNB;
  float* sdn = sT + kNB;
  int* soid = reinterpret_cast<int*>(sdn + kNB);
  Lists lists;                            // [QB][kNB][R] sorted
  if constexpr (MODE == kK4) {
    lists.ord = reinterpret_cast<unsigned*>(soid + kNB);
    lists.lane = reinterpret_cast<unsigned char*>(lists.ord + QB * kNB * a.R);
  } else {
    lists.key = soid + kNB;
  }

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int tb = tid % (kNB / kTB);
  const int tq = tid / (kNB / kTB);
  const int qblk = blockIdx.x % a.nqb;    // query blocks of a slice adjacent
  const int q0 = qblk * QB;
  const int g0 = (blockIdx.x / a.nqb) * kNB;
  const int nq = min(QB, a.B - q0);
  const int nb = min(kNB, a.nbins - g0);
  const int R = a.R;

  for (int i = tid; i < QB * kDim; i += nthreads) {
    const int qq = i / kDim, k = i % kDim;
    const float x = qq < nq ? a.q[(long long)(q0 + qq) * kDim + k] : 0.f;
    qs[k * QB + qq] = MODE == kK2 ? split_word(x) : x;
  }
  for (int i = tid; i < QB * kNB * R; i += nthreads) lists.set(i, inf_key<MODE>());

  float qn[kTQ], qv[kTQ], ql[kTQ], qr[kTQ];
  bool qok[kTQ], qac[kTQ], qat[kTQ];
#pragma unroll
  for (int i = 0; i < kTQ; ++i) {
    const int qq = tq * kTQ + i;
    qok[i] = qq < nq;
    const int g = q0 + (qok[i] ? qq : 0);
    qn[i] = MODE == kK4 ? 0.f : a.qn[g];
    qv[i] = a.v[g]; ql[i] = a.l[g]; qr[i] = a.r[g];
    qac[i] = a.ac[g] != 0; qat[i] = a.at[g] != 0;
  }
  // each list's R-th key, cached
  Key cut[kTQ][kTB];
#pragma unroll
  for (int i = 0; i < kTQ; ++i)
#pragma unroll
    for (int j = 0; j < kTB; ++j) cut[i][j] = inf_key<MODE>();

  const long long bin_row = (long long)g0 * kSlices;   // bin g0, lane 0
  for (int s = 0; s < kSlices; ++s) {
    __syncthreads();   // last slice's readers are done with vs / attributes
    // Stage rows bin_row + b·128 + s, b < nb, transposed. A warp reads 8
    // rows × 4 chunks of 4 lanes: full 32-byte sectors, and the padded smem
    // row keeps the transposing stores at most 2-way bank-conflicted.
    for (int i = tid; i < kNB * (kDim / 4); i += nthreads) {
      const int grp = i / 32, lane = i % 32;
      const int b = (grp % (kNB / 8)) * 8 + lane % 8;
      const int c = (grp / (kNB / 8)) * 4 + lane / 8;
      float x[4] = {0.f, 0.f, 0.f, 0.f};
      if (b < nb) load4(a.V, (bin_row + (long long)b * kSlices + s) * kDim + 4 * c, x);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        vs[(4 * c + e) * kNBP + b] = MODE == kK2 ? split_word(x[e]) : x[e];
    }
    for (int b = tid; b < kNB; b += nthreads) {
      const bool live = b < nb;
      const long long row = bin_row + (long long)b * kSlices + s;
      sC[b] = live ? a.C[row] : 0.f;
      sT[b] = live ? a.T[row] : 0.f;
      sdn[b] = live ? a.dn[row] : 0.f;
      soid[b] = live ? a.oid[row] : 0;
    }
    __syncthreads();

    // acc: K3/K4 the fp32 dot, K2 pass hi·hi; acc2/acc3: K2 hi·lo, lo·hi
    float acc[kTQ][kTB], acc2[kTQ][kTB], acc3[kTQ][kTB];
#pragma unroll
    for (int i = 0; i < kTQ; ++i)
#pragma unroll
      for (int j = 0; j < kTB; ++j) acc[i][j] = acc2[i][j] = acc3[i][j] = 0.f;
#pragma unroll 8
    for (int k = 0; k < kDim; ++k) {
      float qx[kTQ], vx[kTB];
#pragma unroll
      for (int i = 0; i < kTQ; i += 4) load4(qs, k * QB + tq * kTQ + i, qx + i);
#pragma unroll
      for (int j = 0; j < kTB; j += 4) load4(vs, k * kNBP + tb * kTB + j, vx + j);
      if constexpr (MODE == kK2) {
        float qh[kTQ], qlo[kTQ], vh[kTB], vl[kTB];
#pragma unroll
        for (int i = 0; i < kTQ; ++i) { qh[i] = hi_of(qx[i]); qlo[i] = lo_of(qx[i]); }
#pragma unroll
        for (int j = 0; j < kTB; ++j) { vh[j] = hi_of(vx[j]); vl[j] = lo_of(vx[j]); }
#pragma unroll
        for (int i = 0; i < kTQ; ++i)
#pragma unroll
          for (int j = 0; j < kTB; ++j) {
            acc[i][j] = fmaf(qh[i], vh[j], acc[i][j]);
            acc2[i][j] = fmaf(qh[i], vl[j], acc2[i][j]);
            acc3[i][j] = fmaf(qlo[i], vh[j], acc3[i][j]);
          }
      } else {
#pragma unroll
        for (int i = 0; i < kTQ; ++i)
#pragma unroll
          for (int j = 0; j < kTB; ++j) acc[i][j] = fmaf(qx[i], vx[j], acc[i][j]);
      }
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
        Key key;
        if constexpr (MODE == kK4) {
          // ‖d‖² − 2·q·d; a +inf or NaN score never enters (argmin pads)
          const float sc = __fsub_rn(dnb, __fmul_rn(2.f, acc[i][j]));
          key = ((unsigned long long)ordered(sc) << 32) | (unsigned)s;
        } else {
          const float qd = MODE == kK2
              ? __fadd_rn(__fadd_rn(acc[i][j], acc2[i][j]), acc3[i][j])
              : acc[i][j];
          // (‖d‖² − 2·q·d) + ‖q‖², the TPU kernel's order; `> 0 ? : 0`
          // maps −0.0 to +0.0, whose key would otherwise sort first
          float d = __fadd_rn(__fsub_rn(dnb, __fmul_rn(2.f, qd)), qn[i]);
          d = d > 0.f ? d : 0.f;
          key = (__float_as_int(d) & kKeyMask) | s;
        }
        if (!(key < cut[i][j])) continue;
        const int L = ((tq * kTQ + i) * kNB + b) * R;
        int p = R - 1;
        while (p > 0 && lists.get(L + p - 1) > key) {
          lists.set(L + p, lists.get(L + p - 1));
          --p;
        }
        lists.set(L + p, key);
        cut[i][j] = lists.get(L + R - 1);
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < QB * R * kNB; i += nthreads) {
    const int b = i % kNB;
    const int j = (i / kNB) % R;
    const int qq = i / (kNB * R);
    if (qq >= nq || b >= nb) continue;
    emit<MODE>(a, q0 + qq, g0 + b, j, lists.get((qq * kNB + b) * R + j));
  }
}

// The simt body (R > 8): QB halved until the lists fit kSmemTarget.
template <int MODE>
cudaError_t launch(const LaneArgs& a0, cudaStream_t stream) {
  LaneArgs a = a0;
  int QB = kMaxQB;
  while (QB > kTQ && smem_bytes(MODE, QB, a.R) > kSmemTarget) QB /= 2;
  a.QB = QB;
  a.nqb = (a.B + QB - 1) / QB;
  a.nbb = (a.nbins + kNB - 1) / kNB;
  const size_t smem = smem_bytes(MODE, QB, a.R);
  const long long blocks = (long long)a.nqb * a.nbb;
  if (blocks > 0x7FFFFFFFLL) return cudaErrorInvalidConfiguration;
  cudaError_t e = cudaFuncSetAttribute(
      lane_scan_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const int threads = (QB / kTQ) * (kNB / kTB);
  lane_scan_kernel<MODE><<<(unsigned)blocks, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

// ------------------------------------------------------------ wgmma body

// Two consumer warpgroups share each slice and its split, 32 bins a CTA at
// every R, three slices in flight: measured fastest of the shapes tried
// for K3 and K2 (PERF.md); K4 runs K3's shape with its own key policy.
template <int kPasses, class Key = PackedKey>
int launch_lane_wgmma(const Args& a, cudaStream_t stream) {
  constexpr int kNB4 = 32, kWG = 2, kStages = 3;
  return launch_wgmma_r<Lane, kPasses, kNB4, kWG, kStages, Key>(a, stream);
}

}  // namespace

// Which body a scan of `mode` at bin depth R runs: 0 = wgmma, 1 = simt
// (the same for every mode).
extern "C" int hvq_lane_scan_body(int, int R) { return R <= kMaxWgmmaR ? 0 : 1; }

// Plain C entry point for ctypes. mode 0 = K3, 1 = K2, 2 = K4. Pointers are
// device pointers: V (n_pad, 128) fp32; C, T, dn (n_pad,) fp32, oid
// (n_pad,) int32; q (B, 128) fp32, qn (B,) fp32 query norms (unused by K4),
// ac/at (B,) int32 flags, v/l/r (B,) fp32. out_d / out_i are
// (B, nt·bin_top·db_tile/128), nt = n_pad / db_tile: K3/K2 write dist and
// row positions, K4 scores and oid. V and q are 16-byte aligned (TMA rows,
// float4 query loads). Returns 0 on success, the cudaError_t of a failed
// launch, or −CUresult if the plane's tensor map cannot be encoded.
extern "C" int hvq_lane_scan(
    int mode, const float* V, const float* C, const float* T,
    const float* dn, const int* oid, const float* q, const float* qn,
    const int* ac, const float* v, const int* at, const float* l,
    const float* r, int sn, int B, int n_pad, int db_tile, int bin_top,
    float* out_d, int* out_i, void* stream) {
  if (B < 1 || db_tile < kSlices || db_tile % kSlices || bin_top < 1 ||
      bin_top > kSlices || n_pad < db_tile || n_pad % db_tile || mode < 0 ||
      mode > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hvq_lane_scan_body(mode, bin_top) == 0) {
    if (reinterpret_cast<uintptr_t>(V) % 16 || reinterpret_cast<uintptr_t>(q) % 16)
      return (int)cudaErrorMisalignedAddress;
    // the whole plane as one window: tiles [0, nt)
    const Args w{V, C, T, dn, oid, q, qn, ac, v, at, l, r, out_d, out_i,
                 sn, B, db_tile, db_tile / kSlices, bin_top, 0, n_pad / db_tile,
                 n_pad / kSlices, 0, 0, 0};
    switch (mode) {
      case kK3: return launch_lane_wgmma<6>(w, s);
      case kK2: return launch_lane_wgmma<3>(w, s);
      default: return launch_lane_wgmma<6, BinKey>(w, s);
    }
  }
  LaneArgs a{V, C, T, dn, oid, q, qn, ac, v, at, l, r, out_d, out_i,
             sn, B, db_tile / kSlices, n_pad / kSlices, bin_top, n_pad / db_tile,
             0, 0, 0};
  switch (mode) {
    case kK3: return (int)launch<kK3>(a, s);
    case kK2: return (int)launch<kK2>(a, s);
    default: return (int)launch<kK4>(a, s);
  }
}
