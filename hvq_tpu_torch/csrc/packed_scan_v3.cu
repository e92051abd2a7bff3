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
// What bounds it on this card: the product needs 2·B·n·100 FLOP a pass, so
// on the tensor cores the product, not HBM, is the bound (2.07 ms at
// D = 10⁷ on the bf16 plane); measured, the CUDA-core epilogue past the
// product sets the time (scan_wgmma.cuh, PERF.md).
//
// Two bodies, chosen by R (dispatch on shape, not a fallback):
//
// * wgmma (R ≤ 8): scan_wgmma.cuh's body in the Axis1 layout. A warpgroup
//   owns 64 queries × NB bins of one tile; slice s of the bin range is NB
//   contiguous rows at tile_row + s·bins + b0, one TMA box. NB = 64 for
//   R ≤ 4 on the bf16 plane, 32 otherwise, so the ladder's 2R = 6 also
//   stays in registers. On the bf16 plane two warpgroups (128 queries)
//   share each slice; on the fp32 plane one warpgroup splits it, and two
//   CTAs share an SM.
// * simt (R > 8: small databases and deep reruns only). The CUDA-core body
//   of the first port: IEEE fp32 FMAs over the 128 lanes in order (the
//   worst-order fp32 sum the certificate's slack already covers), top-R
//   lists in shared memory with the R-th key cached in a register.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>
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

// ------------------------------------------------------------------ host

// The tensor-core body's bins a CTA for R ≤ 4 (32 above, launch_wgmma_r).
constexpr int wgmma_bins4(bool bf16) { return bf16 ? 64 : 32; }

template <bool kBf16>
int launch(const Args& a, cudaStream_t stream) {
  // bf16 plane: two warpgroups (128 queries) share a slice, 64 bins for
  // R ≤ 4; fp32 plane: one warpgroup and 32 bins (its split buffers fit two
  // CTAs an SM). Measured fastest of the shapes tried (PERF.md).
  constexpr int kPasses = kBf16 ? 1 : 3, kNB4 = wgmma_bins4(kBf16), kWG = kBf16 ? 2 : 1;
  if (a.R <= kMaxWgmmaR)
    return launch_wgmma_r<Axis1, kPasses, kNB4, kWG, 3>(a, stream);
  return launch_simt<typename std::conditional<kBf16, __nv_bfloat16, float>::type>(
      a, stream);
}

}  // namespace

// Which body a scan at bin depth R runs: 0 = wgmma, 1 = simt.
extern "C" int hvq_packed_scan_v3_body(int R) { return R <= kMaxWgmmaR ? 0 : 1; }

// The consumer warpgroups that hold queries in a scan of B queries over ntw
// tiles at bin depth R on the tensor-core body, ⌈B/64⌉ for each bin block
// of each tile (0 on the CUDA-core body): what open_wg counts against.
extern "C" int hvq_packed_scan_v3_warpgroups(int v_bf16, int B, int db_tile, int ntw,
                                             int R) {
  if (R > kMaxWgmmaR) return 0;
  const int NB = R <= 4 ? wgmma_bins4(v_bf16 != 0) : 32, bins = db_tile / kSlices;
  return (B + kM - 1) / kM * ((bins + NB - 1) / NB) * ntw;
}

// Plain C entry point for ctypes. Pointers are device pointers; the scan
// plane V is (n_pad, 128) fp32 (v_bf16 == 0) or bf16 (v_bf16 != 0); C, T,
// dn are (n_pad,) fp32, oid (n_pad,) int32; q (B, 128) fp32 (V and q
// 16-byte aligned), qn (B,) fp32 query norms, ac/at (B,) int32 flags, v/l/r (B,) fp32.
// The scan covers tiles [t0, t0 + ntw) of n_pad / db_tile. out_d / out_p
// are (B, ntw·bin_top·db_tile/128). open_wg, when not null, is one int32
// on the device to which each warpgroup of the tensor-core body that runs
// the predicate-free epilogue adds 1. Returns 0 on success, the
// cudaError_t of a failed launch, or −CUresult if the plane's tensor map
// cannot be encoded.
extern "C" int hvq_packed_scan_v3_counted(
    const void* V, int v_bf16, const float* C, const float* T,
    const float* dn, const int* oid, const float* q, const float* qn,
    const int* ac, const float* v, const int* at, const float* l,
    const float* r, int sn, int B, int n_pad, int db_tile, int bin_top,
    int t0, int ntw, float* out_d, int* out_p, int* open_wg, void* stream) {
  if (B < 1 || db_tile < kSlices || db_tile % kSlices || bin_top < 1 ||
      bin_top > kSlices || t0 < 0 || ntw < 1 || n_pad % db_tile ||
      (long long)(t0 + ntw) * db_tile > n_pad)
    return (int)cudaErrorInvalidValue;
  for (const void* p : {V, (const void*)q})   // TMA rows, float4 query loads
    if (reinterpret_cast<uintptr_t>(p) % 16) return (int)cudaErrorMisalignedAddress;
  Args a{V, C, T, dn, oid, q, qn, ac, v, at, l, r, out_d, out_p,
         sn, B, db_tile, db_tile / kSlices, bin_top, t0, ntw, n_pad / kSlices,
         0, 0, 0, open_wg};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return v_bf16 ? launch<true>(a, s) : launch<false>(a, s);
}

// The same with no count: the untraced launch, and the entry that libraries
// built from older sources share (tools/k1_ablate --reference loads one).
extern "C" int hvq_packed_scan_v3(
    const void* V, int v_bf16, const float* C, const float* T,
    const float* dn, const int* oid, const float* q, const float* qn,
    const int* ac, const float* v, const int* at, const float* l,
    const float* r, int sn, int B, int n_pad, int db_tile, int bin_top,
    int t0, int ntw, float* out_d, int* out_p, void* stream) {
  return hvq_packed_scan_v3_counted(V, v_bf16, C, T, dn, oid, q, qn, ac, v, at, l, r, sn,
                                    B, n_pad, db_tile, bin_top, t0, ntw, out_d, out_p,
                                    nullptr, stream);
}
