// Packed bin scan K1 for Hopper (sm_90a).
//
// Replaces hvq_tpu/ops/pallas_scan.py::fused_packed_scan_v3 (kernel body
// _make_packed_kernel_v3). Plain PyTorch version beside it:
// hvq_tpu_torch/ops/scan.py::packed_scan_plain; Python wrapper and launch
// counter: hvq_tpu_torch/ops/kernels.py::packed_scan_v3.
//
// What it computes (the axis1 layout; bins = db_tile / 128):
//   dist = max(‖q‖² + ‖d‖² − 2·q·d, 0), +inf unless
//          oid < sn ∧ (¬ac ∨ C == v) ∧ (¬at ∨ l ≤ T ≤ r)
//   key  = bitcast(dist) & ~0x7F | s
// for row tile·Dt + s·bins + b, s ∈ [0, 128). Bin b of a tile keeps its
// R smallest keys in ascending order; a bin with fewer than R unmasked rows
// pads with the key of +inf at payload 0 (0x7F800000), exactly what the
// TPU kernel's R min rounds emit. Output is already decoded:
//   dist[q, tile·R·bins + j·bins + b] = key & ~0x7F   (as fp32)
//   pos [q, same column]              = (t0+tile)·Dt + (key & 0x7F)·bins + b
//
// What bounds it on this card. The work is 2·B·n·128 FLOP per scan; at the
// main-path batch (B = 1024) that is ~2000 FLOP per database byte, far
// above the ~20 FLOP/B where fp32 CUDA cores stop waiting on HBM, so bytes
// are not the limit (the bf16 plane, half the bytes, runs no faster).
// Measured on the H100, time follows the warps resident per SM: each slice
// pays two barriers and a global load that nothing overlaps, so K1 is
// latency-bound, and shared memory per CTA sets how many CTAs hide it.
//
// Design. A CTA owns (query block of QB, tile, 64-bin range) and streams
// the 128 slices of its bin range: slice s is 64 CONTIGUOUS rows, staged
// transposed in shared memory; the query block is staged once. Each thread
// holds a 4×4 register tile of (query, bin) dot products, accumulated as
// IEEE fp32 FMAs over the 128 lanes in order (more accurate than the TPU's
// 3-pass bf16 split, inside the certificate's worst-order fp32 bound); on
// the bf16 plane the query is rounded to bf16 first, and bf16·bf16
// products are exact in fp32. Each (query, bin) keeps its top-R sorted.
// For R ≤ kMaxRegR (the main path runs R = 3) the list lives in
// registers, a key that enters is placed by a branch-free
// min/max pass, and the CTA needs no list memory, so QB = 64 and two
// CTAs (16 warps) fit an SM. Larger R (small databases, deep reruns) keeps
// the lists in shared memory with the R-th key cached in a register, and
// the launcher halves QB until they fit. Either way a key costs one
// compare unless it enters the list. Keys are distinct through the
// payload, so the running top-R equals the R min rounds bit for bit. The
// launch order puts the query blocks of one (tile, bin range) next to each
// other, so a slice is read from HBM once and from L2 after. Tensor cores
// (wgmma) and TMA/cp.async staging are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSlices = 128;        // rows per bin = payload range
constexpr int kDim = 128;           // padded vector width
constexpr int kNB = 64;             // bins per CTA
constexpr int kNBP = kNB + 4;       // padded smem row of the staged slice
constexpr int kTQ = 4;              // queries per thread
constexpr int kTB = 4;              // bins per thread
constexpr int kInfKey = 0x7F800000;
constexpr int kKeyMask = ~0x7F;
constexpr int kMaxQB = 64;
constexpr int kMaxRegR = 4;         // largest R kept in registers
// Dynamic shared memory a CTA aims to stay under, so two CTAs share an SM.
constexpr size_t kSmemTarget = 100 * 1024;
static_assert(kTQ % 4 == 0 && kTB % 4 == 0, "register tiles load float4s");
static_assert(kNB % kTB == 0 && kNB % 8 == 0, "bin range splits evenly");

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

// Shared memory of a CTA: queries, one staged slice, its attributes, and
// (only when R is not held in registers) the top-R lists.
size_t smem_bytes(int QB, int R, bool lists) {
  return sizeof(float) * ((size_t)kDim * QB + (size_t)kDim * kNBP + 4 * kNB)
         + (lists ? sizeof(int) * (size_t)QB * kNB * R : 0);
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

// RR > 0: R == RR, top-R in registers; RR == 0: any R, lists in smem.
template <typename VT, int RR>
__global__ void __launch_bounds__(256, 2)
packed_scan_v3_kernel(Args a) {
  extern __shared__ float smem[];
  const int QB = a.QB;
  float* qs = smem;                       // [kDim][QB]   transposed queries
  float* vs = qs + kDim * QB;             // [kDim][kNBP] transposed slice
  float* sC = vs + kDim * kNBP;           // [kNB] slice attributes
  float* sT = sC + kNB;
  float* sdn = sT + kNB;
  int* soid = reinterpret_cast<int*>(sdn + kNB);
  int* lists = soid + kNB;                // RR == 0: [QB][kNB][R] sorted keys

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
  if (RR == 0)
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
  // RR > 0: the sorted top-R itself; RR == 0: [0] caches the R-th key
  constexpr int kRegR = RR > 0 ? RR : 1;
  int top[kTQ][kTB][kRegR];
#pragma unroll
  for (int i = 0; i < kTQ; ++i)
#pragma unroll
    for (int j = 0; j < kTB; ++j)
#pragma unroll
      for (int r = 0; r < kRegR; ++r) top[i][j][r] = kInfKey;

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
        // (‖d‖² − 2·q·d) + ‖q‖², the TPU kernel's order; `> 0 ? : 0`
        // maps −0.0 to +0.0, whose key would otherwise sort first
        float d = __fadd_rn(__fsub_rn(dnb, __fmul_rn(2.f, acc[i][j])), qn[i]);
        d = d > 0.f ? d : 0.f;
        const int key = (__float_as_int(d) & kKeyMask) | s;
        if (key >= top[i][j][kRegR - 1]) continue;
        if constexpr (RR > 0) {
          int k = key;   // carry the larger of each pair down the list
#pragma unroll
          for (int r = 0; r < RR; ++r) {
            const int lo = min(top[i][j][r], k);
            k = max(top[i][j][r], k);
            top[i][j][r] = lo;
          }
        } else {
          int* L = lists + ((tq * kTQ + i) * kNB + b) * R;
          int p = R - 1;
          while (p > 0 && L[p - 1] > key) {
            L[p] = L[p - 1];
            --p;
          }
          L[p] = key;
          top[i][j][0] = L[R - 1];
        }
      }
    }
  }
  const long long W = (long long)a.ntw * R * a.bins;
  const long long col0 = (long long)tile * R * a.bins + b0;
  if constexpr (RR > 0) {
#pragma unroll
    for (int i = 0; i < kTQ; ++i) {
      const int qq = tq * kTQ + i;
#pragma unroll
      for (int j = 0; j < kTB; ++j) {
        const int b = tb * kTB + j;
        if (qq >= nq || b >= nb) continue;
#pragma unroll
        for (int r = 0; r < RR; ++r) {
          const int key = top[i][j][r];
          const long long o = (long long)(q0 + qq) * W + col0 + (long long)r * a.bins + b;
          a.out_d[o] = __int_as_float(key & kKeyMask);
          a.out_p[o] = (int)(tile_row + (long long)(key & 0x7F) * a.bins + b0 + b);
        }
      }
    }
    return;
  }
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

template <typename VT, int RR>
cudaError_t launch_r(const Args& a0, cudaStream_t stream) {
  Args a = a0;
  int QB = kMaxQB;
  while (RR == 0 && QB > kTQ && smem_bytes(QB, a.R, true) > kSmemTarget) QB /= 2;
  a.QB = QB;
  a.nqb = (a.B + QB - 1) / QB;
  a.nbb = (a.bins + kNB - 1) / kNB;
  const size_t smem = smem_bytes(QB, a.R, RR == 0);
  const long long blocks = (long long)a.nqb * a.nbb * a.ntw;
  if (blocks > 0x7FFFFFFFLL) return cudaErrorInvalidConfiguration;
  cudaError_t e = cudaFuncSetAttribute(
      packed_scan_v3_kernel<VT, RR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const int threads = (QB / kTQ) * (kNB / kTB);
  packed_scan_v3_kernel<VT, RR><<<(unsigned)blocks, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename VT>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  static_assert(kMaxRegR == 4, "one case per register-resident R");
  switch (a.R) {
    case 1: return launch_r<VT, 1>(a, stream);
    case 2: return launch_r<VT, 2>(a, stream);
    case 3: return launch_r<VT, 3>(a, stream);
    case 4: return launch_r<VT, 4>(a, stream);
    default: return launch_r<VT, 0>(a, stream);
  }
}

}  // namespace

// Plain C entry point for ctypes. Pointers are device pointers; the scan
// plane V is (n_pad, 128) fp32 (v_bf16 == 0) or bf16 (v_bf16 != 0); C, T,
// dn are (n_pad,) fp32, oid (n_pad,) int32; q (B, 128) fp32, qn (B,) fp32
// query norms, ac/at (B,) int32 flags, v/l/r (B,) fp32. The scan covers
// tiles [t0, t0 + ntw). out_d / out_p are (B, ntw·bin_top·db_tile/128).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int hvq_packed_scan_v3(
    const void* V, int v_bf16, const float* C, const float* T,
    const float* dn, const int* oid, const float* q, const float* qn,
    const int* ac, const float* v, const int* at, const float* l,
    const float* r, int sn, int B, int db_tile, int bin_top, int t0, int ntw,
    float* out_d, int* out_p, void* stream) {
  if (B < 1 || db_tile < kSlices || db_tile % kSlices || bin_top < 1 ||
      bin_top > kSlices || t0 < 0 || ntw < 1)
    return (int)cudaErrorInvalidValue;
  Args a{V, C, T, dn, oid, q, qn, ac, v, at, l, r, out_d, out_p,
         sn, B, db_tile, db_tile / kSlices, bin_top, t0, ntw, 0, 0, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(v_bf16 ? launch<__nv_bfloat16>(a, s) : launch<float>(a, s));
}
