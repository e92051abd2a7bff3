// Two TPU probe kernels for Hopper (sm_90a). Plain PyTorch versions beside
// them and Python wrappers with their launch counts:
// hvq_tpu_torch/ops/probe_kernels.py.
//
// * trivial: o = 2·x. Replaces experiments/pallas_probe.py::_trivial
//   (pallas_call at :32), the check that a hand kernel builds and runs.
//   Bound by bytes (one read, one write): one 16-byte load and store a
//   thread, a scalar tail. At the script's (256, 128) the launch and its
//   host path, not the bytes, set the time (ops/kernels.py::run is thin for
//   that reason).
//
// * probe_mm: replaces experiments/int8_probe.py::make_mosaic.kern
//   (pallas_call at :83). For each tile t of d (nt, 128, Dt) and each query
//   row b of q (B, 128):
//     out[t, b, j] = min over i < 128 of (q · d[t])[b, 128·j + i]
//   (the min over each 128 contiguous columns), as bf16 → fp32, int8 →
//   int32, or int8 → int32 → fp32. The product runs on the tensor cores
//   (wgmma), since the probe measures their rate: m64n64k16 bf16 or
//   m64n64k32 s8, fp32 or int32 accumulators, two per 128-column bin.
//
//   d[t] is K × Dt, so the B operand (columns n, depth k) is stored
//   MN-major. bf16 wgmma reads that as it is (the descriptor's transpose
//   bit): each bin's 128 × 128 block arrives by TMA as two {64 n, 128 k}
//   boxes in the 128B swizzle. s8 wgmma has no transpose and reads only
//   K-major operands, so on the int8 path the block arrives unswizzled and
//   the consumers transpose it in shared memory (16 k × 4 n byte blocks,
//   __byte_perm) into the 128B-swizzled K-major layout before the product.
//   That transpose is a cost the TPU kernel does not pay; `product = 0`
//   runs everything but the product, to time it.
//
//   Structure: one producer warp keeps a ring of three bins in flight by
//   TMA on mbarriers; four consumer warpgroups (256 queries, the probe's B)
//   share each bin, so d is read from HBM once; each warpgroup reduces its
//   64 × 128 fragment to the row minima with register mins and two quad
//   shuffles. The CTAs walk the nt·Dt/128 bins with a grid stride, as many
//   CTAs as fit the card at once.
//
//   What bounds it on this card: at the probe's shape (B 256, 61 tiles of
//   16384 columns) the bytes of d (256 MB bf16, 128 MB int8) at 3.35 TB/s
//   against 2·B·128·Dt·nt operations at 989 (bf16) or 1979 (int8) TOP/s:
//   0.0788 and 0.0406 ms, both set by the bytes.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "scan_wgmma.cuh"

namespace {

// ------------------------------------------------------------------ trivial

// One 16-byte load and store a thread (a warp moves 512 contiguous bytes),
// the last n % 4 values one a thread; x and o 16-byte aligned.
__global__ void trivial_kernel(const float* x, float* o, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int n4 = n / 4;
  if (i < n4) {
    float4 v = reinterpret_cast<const float4*>(x)[i];
    v.x *= 2.0f; v.y *= 2.0f; v.z *= 2.0f; v.w *= 2.0f;
    reinterpret_cast<float4*>(o)[i] = v;
  } else if (i < n4 + n % 4) {
    const int j = 4 * n4 + (i - n4);
    o[j] = x[j] * 2.0f;
  }
}

// The same one value a thread, for x or o not 16-byte aligned (a view at
// an offset).
__global__ void trivial_scalar(const float* x, float* o, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) o[i] = x[i] * 2.0f;
}

// ----------------------------------------------------------------- probe_mm

constexpr int kProbeWG = 4;              // consumer warpgroups: 256 queries a CTA
constexpr int kProbeStages = 3;          // bins in flight
constexpr int kBin = 128;                // columns a bin
constexpr int kConsumersP = kProbeWG * kWGThreads;

// Output kinds: bf16 → fp32; int8 → int32; int8 → int32 → fp32.
enum Out { kBf16F32 = 0, kI8I32 = 1, kI8F32 = 2 };

template <bool kI8>
struct ProbePlan {
  static constexpr int kQ = kM * kDim * (kI8 ? 1 : 2);       // one warpgroup's queries
  static constexpr int kChunk = kDim * kBin * (kI8 ? 1 : 2); // one bin of d (128 k × 128 n)
  static constexpr int q = 0;
  static constexpr int tposed = q + kProbeWG * kQ;            // int8: the K-major copy
  static constexpr int ring = tposed + (kI8 ? kChunk : 0);
  static constexpr int bars = ring + kProbeStages * kChunk;
  static constexpr int smem = bars + 2 * kProbeStages * 8 + 1024;
};

// Barrier of the four consumer warpgroups (id 1; 0 is __syncthreads).
__device__ __forceinline__ void probe_consumers_sync() {
  asm volatile("bar.sync 1, %0;" :: "n"(kConsumersP) : "memory");
}

#define PROBE_N64_BF16_TB                                                 \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                            \
  "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "                 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "    \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, " \
  "%29, %30, %31}, %32, %33, p, 1, 1, 0, 1;\n}\n"

// D (+)= A·B, m64n64k16 bf16, A K-major, B MN-major (transpose bit set):
// the descriptor's 128B swizzle atoms are 8 k-rows of 64 n (128 B), the
// stride between the two 8-row groups of k 1024 B; N = 64 is one atom.
template <bool kInit>
__device__ __forceinline__ void wgmma_bf16_tb(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(PROBE_N64_BF16_TB : K1_D32("+f") : "l"(da), "l"(db), "r"(kInit ? 0 : 1));
}

__device__ __forceinline__ int vmin(int a, int b) { return min(a, b); }
__device__ __forceinline__ float vmin(float a, float b) { return fminf(a, b); }

// 4 words of 4 bytes (rows 0..3) → 4 words, word i = byte i of each row.
__device__ __forceinline__ void transpose4(const uint32_t* w, uint32_t (&o)[4]) {
  const uint32_t t0 = __byte_perm(w[0], w[1], 0x5140), t1 = __byte_perm(w[2], w[3], 0x5140);
  const uint32_t t2 = __byte_perm(w[0], w[1], 0x7362), t3 = __byte_perm(w[2], w[3], 0x7362);
  o[0] = __byte_perm(t0, t1, 0x5410);
  o[1] = __byte_perm(t0, t1, 0x7632);
  o[2] = __byte_perm(t2, t3, 0x5410);
  o[3] = __byte_perm(t2, t3, 0x7632);
}

template <int kOut, bool kProduct>
__global__ void __launch_bounds__(kConsumersP + 32, 1)
probe_mm(__grid_constant__ const CUtensorMap dmap, const void* qp, void* out, int B,
         int Dt, int nt) {
  constexpr bool kI8 = kOut != kBf16F32;
  using P = ProbePlan<kI8>;
  using Acc = typename std::conditional<kI8, int, float>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(sm);
  const uint32_t full = base + P::bars, empty = full + 8 * kProbeStages;
  const int tid = threadIdx.x;
  const int bpt = Dt / kBin, nbins = nt * bpt;

  if (tid == 0) {
    for (int i = 0; i < kProbeStages; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, kConsumersP);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumersP) {
    // Producer: lane 0 brings each bin's 128 × 128 block of d by TMA.
    if (tid != kConsumersP) return;
    int i = 0;
    for (int g = blockIdx.x; g < nbins; g += gridDim.x, ++i) {
      const int st = i % kProbeStages;
      mbar_wait(empty + 8 * st, ((i / kProbeStages) & 1) ^ 1);
      const uint32_t bar = full + 8 * st, dst = base + P::ring + st * P::kChunk;
      const int row = (g / bpt) * kDim, n0 = (g % bpt) * kBin;
      mbar_expect_tx(bar, P::kChunk);
      tma_2d(dst, &dmap, n0, row, bar);
      if (!kI8) tma_2d(dst + kDim * 128, &dmap, n0 + 64, row, bar);
    }
    return;
  }

  const int wg = tid / kWGThreads, t = tid % kWGThreads, warp = t / 32, lane = t % 32;
  const int q0 = blockIdx.y * (kProbeWG * kM) + wg * kM;
  const int nq = min(kM, B - q0);         // ≤ 0: zero queries, nothing written
  // Stage the warpgroup's queries (rows past B zero) in the 128B-swizzled
  // K-major A layout: bf16 as two 64-k blocks, int8 as one 128-byte row.
  const uint32_t qa = base + P::q + wg * P::kQ;
  for (int i = t; i < kM * 8 * (kI8 ? 1 : 2); i += kWGThreads) {
    const int per_row = kI8 ? 8 : 16, m = i / per_row, c = i % per_row;
    const unsigned char* src = static_cast<const unsigned char*>(qp)
                               + ((long long)(q0 + m) * kDim) * (kI8 ? 1 : 2) + 16 * c;
    const uint4 x = m < nq ? *reinterpret_cast<const uint4*>(src) : make_uint4(0, 0, 0, 0);
    const int off = kI8 ? swz8(m, c) : swz(kM, m, 8 * c);
    *reinterpret_cast<uint4*>(sm + P::q + wg * P::kQ + off) = x;
  }
  fence_async_smem();
  probe_consumers_sync();

  int i = 0;
  for (int g = blockIdx.x; g < nbins; g += gridDim.x, ++i) {
    const int st = i % kProbeStages;
    const uint32_t chunk = base + P::ring + st * P::kChunk;
    uint32_t bops = chunk;                   // B operand of the product
    if constexpr (kI8) {
      // Transpose the (128 k × 128 n) block into K-major rows n of 128 k,
      // 128B-swizzled: threads 0..255, one 16 k × 4 n block each (the
      // others wait); the last products must be done with the copy first.
      probe_consumers_sync();
      mbar_wait(full + 8 * st, (i / kProbeStages) & 1);
      if (tid < 256) {
        const int kc = tid / 32, nb = tid % 32;
        const unsigned char* S = sm + P::ring + st * P::kChunk;
        uint32_t w[16];
#pragma unroll
        for (int j = 0; j < 16; ++j)
          w[j] = *reinterpret_cast<const uint32_t*>(S + (16 * kc + j) * kBin + 4 * nb);
        uint32_t o[4][4];
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          uint32_t col[4];
          transpose4(w + 4 * p, col);
#pragma unroll
          for (int c = 0; c < 4; ++c) o[c][p] = col[c];
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int n = 4 * nb + c;
          *reinterpret_cast<uint4*>(sm + P::tposed + swz8(n, kc)) =
              make_uint4(o[c][0], o[c][1], o[c][2], o[c][3]);
        }
      }
      mbar_arrive(empty + 8 * st);           // the staged block is consumed
      fence_async_smem();
      probe_consumers_sync();
      bops = base + P::tposed;
    } else {
      mbar_wait(full + 8 * st, (i / kProbeStages) & 1);
    }

    Acc acc[2][32];                          // columns 0..63 and 64..127
    if constexpr (kProduct) {
      fence_acc<64>(acc[0]);
      fence_acc<64>(acc[1]);
      wgmma_fence();
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if constexpr (kI8) {
          product_s8<64>(acc[h], qa, bops + h * 64 * 128);
        } else {
#pragma unroll
          for (int k = 0; k < kDim / 16; ++k) {
            const uint64_t da = desc(qa + (k >> 2) * kM * 128 + (k & 3) * 32);
            const uint64_t db = desc(bops + h * kDim * 128 + k * 16 * 128);
            if (k == 0)
              wgmma_bf16_tb<true>(acc[h], da, db);
            else
              wgmma_bf16_tb<false>(acc[h], da, db);
          }
        }
      }
      wgmma_commit();
      wgmma_wait();
      fence_acc<64>(acc[0]);
      fence_acc<64>(acc[1]);
    } else {
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[0][e] = acc[1][e] = 0;
    }
    if constexpr (!kI8) mbar_arrive(empty + 8 * st);

    // Row minima: element 4j + 2r + h of a half is row 16·warp + lane/4 +
    // 8r, column 8j + 2·(lane % 4) + h; the quad's four lanes hold a row.
    const int tile = g / bpt, bin = g % bpt;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      Acc m = acc[0][2 * r];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int e = 0; e < 32; ++e)
          if (((e >> 1) & 1) == r) m = vmin(m, acc[hf][e]);
      m = vmin(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = vmin(m, __shfl_xor_sync(0xffffffffu, m, 2));
      const int row = 16 * warp + lane / 4 + 8 * r;
      if ((lane & 3) == 0 && row < nq) {
        const long long o = ((long long)tile * B + q0 + row) * bpt + bin;
        if constexpr (kOut == kI8F32)        // int32 → fp32 exactly (|q·d| < 2²⁴)
          static_cast<float*>(out)[o] = __int2float_rn(m);
        else
          static_cast<Acc*>(out)[o] = m;
      }
    }
  }
}

template <int kOut, bool kProduct>
int launch_probe_mm(const void* q, const void* d, void* out, int B, int Dt, int nt,
                    cudaStream_t stream) {
  constexpr bool kI8 = kOut != kBf16F32;
  using P = ProbePlan<kI8>;
  EncodeTiled enc = encode_fn();
  if (enc == nullptr) return cudaErrorSymbolNotFound;
  // d as 2-D (nt·128 rows of Dt columns); a box is {64 n, 128 k} bf16 in
  // the 128B swizzle, or {128 n, 128 k} int8 unswizzled (transposed later).
  CUtensorMap map;
  const cuuint64_t dim[2] = {(cuuint64_t)Dt, (cuuint64_t)nt * kDim};
  const cuuint64_t stride[1] = {(cuuint64_t)Dt * (kI8 ? 1 : 2)};
  const cuuint32_t box[2] = {(cuuint32_t)(kI8 ? kBin : 64), (cuuint32_t)kDim};
  const cuuint32_t es[2] = {1, 1};
  const CUresult res = enc(
      &map, kI8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
      const_cast<void*>(d), dim, stride, box, es, CU_TENSOR_MAP_INTERLEAVE_NONE,
      kI8 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return -(int)res;
  auto kernel = probe_mm<kOut, kProduct>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       P::smem);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kConsumersP + 32,
                                                         P::smem)) != cudaSuccess)
    return e;
  const int nqb = (B + kProbeWG * kM - 1) / (kProbeWG * kM);
  const int nbins = nt * (Dt / kBin);
  const int ctas = max(1, min(nbins, max(1, per_sm) * sms / nqb));
  kernel<<<dim3(ctas, nqb), kConsumersP + 32, P::smem, stream>>>(map, q, out, B, Dt, nt);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry points for ctypes; pointers are device pointers.

// o = 2·x over n fp32 values. Returns 0 or a cudaError_t.
extern "C" int hvq_probe_trivial(const float* x, float* o, int n, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  const int threads = 128;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(o)) % 16 == 0) {
    const int work = n / 4 + n % 4;             // float4s, then the tail
    trivial_kernel<<<(work + threads - 1) / threads, threads, 0, s>>>(x, o, n);
  } else {
    trivial_scalar<<<(n + threads - 1) / threads, threads, 0, s>>>(x, o, n);
  }
  return (int)cudaGetLastError();
}

// out (nt, B, Dt/128) = per-bin minima of q (B, 128) · d (nt, 128, Dt).
// kind: 0 bf16 q and d → fp32 out; 1 int8 → int32; 2 int8 → int32 → fp32.
// product = 0 (int8 kinds only) skips the product and writes the minima of
// zeros, to time the loads and the transpose alone. q and d 16-byte
// aligned, Dt a multiple of 128. Returns 0, a cudaError_t, or −CUresult if
// d's tensor map cannot be encoded.
extern "C" int hvq_probe_mm(int kind, int product, const void* q, const void* d, void* out,
                            int B, int Dt, int nt, void* stream) {
  if (B < 1 || nt < 1 || Dt < kBin || Dt % kBin || kind < 0 || kind > 2 ||
      (!product && kind == kBf16F32))
    return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(q) % 16 || reinterpret_cast<uintptr_t>(d) % 16)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case kBf16F32: return launch_probe_mm<kBf16F32, true>(q, d, out, B, Dt, nt, s);
    case kI8I32:
      return product ? launch_probe_mm<kI8I32, true>(q, d, out, B, Dt, nt, s)
                     : launch_probe_mm<kI8I32, false>(q, d, out, B, Dt, nt, s);
    default: return launch_probe_mm<kI8F32, true>(q, d, out, B, Dt, nt, s);
  }
}
