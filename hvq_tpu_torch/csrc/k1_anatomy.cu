// K1 cut into stages, for Hopper (sm_90a): the card's counterpart of the
// TPU probe experiments/v3_anatomy.py (make_kernel._kernel, pallas_call at
// :189). Plain PyTorch version beside it and Python wrapper with its launch
// counts: hvq_tpu_torch/ops/probe_kernels.py::k1_anatomy(_plain).
//
// What it computes: K1 (packed_scan_v3.cu) on the axis1 layout, stopped at
// a stage (scan_wgmma.cuh's Stage), on one scan plane. The output is one
// int32 array (B, nt·R·bins), column tile·R·bins + j·bins + b as K1's:
//   mm, mmb, dist, mask  the per-bin min's fp32 bits in entry 0, zeros in
//                        entries 1..R−1;
//   pack, full           the R smallest keys, as they are (not decoded):
//                        (max(bits(d), 0) & ~0x7F) | slice, 0x7F800000 where
//                        fewer than R rows are left (pack: no mask).
// The script's chunked stage mmc{CH} (R = 1, bf16 plane) is mm over tiles
// of CH rows (each chunk's bins are its own 128-way interleave): the
// wrapper runs this kernel's mm at db_tile = CH; it is not another code path.
//
// Planes, one per object: nvcc compiles this file once for each, with
// -DHVQ_ANATOMY_PLANE = 3 (fp32 plane, the 3-pass bf16 split, K1's fp32
// shape: 32 bins, one warpgroup), 1 (bf16 plane, one pass, K1's bf16 shape:
// 64 bins, two warpgroups) or 0 (int8 plane and int8 queries, one s8 wgmma
// pass into int32, q·d = int32 × (6/127)², the bf16 shape), exporting
// hvq_k1_anatomy_fp32, _bf16 or _int8.
//
// What bounds it on this card: the product, as K1 (2·B·n·128 operations a
// pass over the script's 128 lanes of data, at the bf16 or the int8 peak);
// the stages measure how much of K1's time past that bound each piece of
// the epilogue takes. The stages before pack keep one running min per
// fragment element instead of a top-R list, so they also free registers
// (ptxas reports each instantiation).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

#include "scan_wgmma.cuh"

#ifndef HVQ_ANATOMY_PLANE
#error "compile with -DHVQ_ANATOMY_PLANE=3 (fp32), 1 (bf16) or 0 (int8)"
#endif

#if HVQ_ANATOMY_PLANE == 3
#define HVQ_ANATOMY_ENTRY hvq_k1_anatomy_fp32
#elif HVQ_ANATOMY_PLANE == 1
#define HVQ_ANATOMY_ENTRY hvq_k1_anatomy_bf16
#elif HVQ_ANATOMY_PLANE == 0
#define HVQ_ANATOMY_ENTRY hvq_k1_anatomy_int8
#else
#error "HVQ_ANATOMY_PLANE must be 3, 1 or 0"
#endif

namespace {

constexpr int kPasses = HVQ_ANATOMY_PLANE;
// K1's shapes (packed_scan_v3.cu): the fp32 plane splits each slice, so one
// warpgroup and 32 bins; the directly read planes two warpgroups, 64 bins.
constexpr int kNB = kPasses == 3 ? 32 : 64, kWG = kPasses == 3 ? 1 : 2;
constexpr int kMaxR = 4;                 // the anatomy's R: 1 to 4

// The stages before pack keep one running min (a list of 1); pack and full
// a top-R list of R, as K1 holds it at R ≤ 4.
template <int kStop>
int launch_stage(const Args& a, cudaStream_t s) {
  if constexpr (kStop < kPack) {
    return launch_wgmma<Axis1Keys, kPasses, kNB, kWG, 1, 3, kStop>(a, s);
  } else {
    switch (a.R) {
      case 1: return launch_wgmma<Axis1Keys, kPasses, kNB, kWG, 1, 3, kStop>(a, s);
      case 2: return launch_wgmma<Axis1Keys, kPasses, kNB, kWG, 2, 3, kStop>(a, s);
      case 3: return launch_wgmma<Axis1Keys, kPasses, kNB, kWG, 3, 3, kStop>(a, s);
      default: return launch_wgmma<Axis1Keys, kPasses, kNB, kWG, 4, 3, kStop>(a, s);
    }
  }
}

}  // namespace

// Plain C entry point for ctypes. stage: Stage (0 mm, 1 mmb, 2 dist, 3 mask,
// 4 pack, 5 full). Pointers are device pointers: V (n_pad, 128) of the
// plane's type (fp32, bf16 or int8); C, T, dn (n_pad,) fp32 (dn from the
// fp32 rows on every plane), oid (n_pad,) int32; q (B, 128) fp32, or int8
// on the int8 plane; qn (B,) fp32 norms of the fp32 queries; ac/at (B,)
// int32 flags, v/l/r (B,) fp32. out (B, nt·R·db_tile/128) int32. V and q
// 16-byte aligned. Returns 0, a cudaError_t, or −CUresult if the plane's
// tensor map cannot be encoded.
extern "C" int HVQ_ANATOMY_ENTRY(
    int stage, const void* V, const float* C, const float* T, const float* dn,
    const int* oid, const void* q, const float* qn, const int* ac, const float* v,
    const int* at, const float* l, const float* r, int sn, int B, int n_pad,
    int db_tile, int R, int* out, void* stream) {
  if (B < 1 || db_tile < kSlices || db_tile % kSlices || n_pad < db_tile ||
      n_pad % db_tile || R < 1 || R > kMaxR || stage < kMm || stage > kFull)
    return (int)cudaErrorInvalidValue;
  for (const void* p : {V, q})
    if (reinterpret_cast<uintptr_t>(p) % 16) return (int)cudaErrorMisalignedAddress;
  const Args a{V, C, T, dn, oid, reinterpret_cast<const float*>(q), qn, ac, v, at, l, r,
               nullptr, out, sn, B, db_tile, db_tile / kSlices, R, 0, n_pad / db_tile,
               n_pad / kSlices, 0, 0, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (stage) {
    case kMm: return launch_stage<kMm>(a, s);
    case kMmb: return launch_stage<kMmb>(a, s);
    case kDist: return launch_stage<kDist>(a, s);
    case kMask: return launch_stage<kMask>(a, s);
    case kPack: return launch_stage<kPack>(a, s);
    default: return launch_stage<kFull>(a, s);
  }
}
