// Level-2 select for Hopper (sm_90a): every level-2 bin of a packed scan's
// candidate stream reduced to its best `rounds` packed keys.
//
// Replaces no TPU kernel. The JAX package leaves this reduce to XLA as
// jnp code (hvq_tpu/ops/topk.py:88, binned_stream_topk); this is its
// kernel on the card. Plain PyTorch version beside it:
// hvq_tpu_torch/ops/topk.py::level2_select_plain; Python wrapper and launch
// counters: hvq_tpu_torch/ops/kernels.py::level2_select.
//
// What it computes. The (B, W) fp32 stream is cut into bins2 = ⌈W/128⌉
// bins of 128 members; member j of bin b is column j·ls + b·bs (the axis1
// layout: ls = bins2, bs = 1, strided groups; the lane layout: ls = 1,
// bs = 128, contiguous bins), and a column ≥ W reads as +inf. Its packed key
// is (bits & ~0x7F) | j, compared as a signed int32. With S the bin's keys
// ascending, round r emits S[0] for r = 0 and min(S[r], 0x7F800000) after:
// what the plain version's `rounds` min rounds emit, since each round masks
// the lane it took to 0x7F800000 (+inf at payload 0), so once a bin's finite
// keys are used every later round emits that key, at lane 0. Outputs, in
// the plain version's round-major order:
//   d2 [q, r·bins2 + b] = key & ~0x7F   (as fp32)
//   col[q, r·bins2 + b] = (key & 0x7F)·ls + b·bs
//   worst2[q]           = min over b of d2[q, (rounds − 1)·bins2 + b]
// worst2 is an unsigned atomicMin of the bits over a memset to 0xFF..: the
// bits order as the floats do because every score is ≥ 0.
//
// What bounds it on this card: one read of the stream, B·W·4 bytes at
// 3.35 TB/s (0.287 ms at B = 1024, W = 234,624), beside rounds·bins2 keys
// written twice over (an eighth of that at rounds 8).
//
// Design: one thread owns one bin of one query; neighbouring threads take
// neighbouring bins, so in the axis1 layout each of a thread's 128 loads is
// one coalesced 128-byte row of the warp. Two bodies, chosen by rounds
// (dispatch on shape, not a fallback):
//
// * registers (rounds ≤ 16, templated on a cap of 8 or 16): the bin's best
//   CAP keys stay sorted in registers. Members arrive CAP at a time, the
//   next batch's loads in flight while this one is placed: a bitonic sort of
//   the batch, then min(best[i], batch[CAP−1−i]) and a bitonic merge keep
//   the CAP smallest of both, sorted. Integer min/max only, no branch: the
//   read of the stream, not the placing, is meant to set the time.
// * shared (16 < rounds ≤ 128): the bin's 128 keys in shared memory, one
//   column per thread, and `rounds` passes of selection, each the least key
//   above the last one emitted (a bin's keys are distinct: the lane is in
//   the key).

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kBin = 128;                 // members of a level-2 bin
constexpr int kInfKey = 0x7F800000;       // +inf at payload 0
constexpr int kKeyMask = ~0x7F;
constexpr int kMaxRegRounds = 16;
constexpr int kRegThreads = 128;
constexpr int kSharedThreads = 64;

struct Args {
  const float* s;                         // (B, W) stream
  float* d2;                              // (B, rounds·bins2)
  int* col;                               // (B, rounds·bins2)
  unsigned* worst2;                       // (B,) fp32 bits
  int W, bins2, rounds, ls, bs, nblk;     // nblk: blocks a query row
};

// The packed key of member j of a bin whose first column is c0: +inf past
// `lim` (W, or 0 for a thread past the last bin).
__device__ __forceinline__ int member_key(const float* row, int c0, int j,
                                          int ls, int lim) {
  const int c = c0 + j * ls;
  const int bits = c < lim ? __float_as_int(__ldg(row + c)) : kInfKey;
  return (bits & kKeyMask) | j;
}

__device__ __forceinline__ void exchange(int& lo, int& hi) {
  const int a = min(lo, hi);
  hi = max(lo, hi);
  lo = a;
}

// Ascending bitonic sort of N keys in registers (every index compile-time).
template <int N>
__device__ __forceinline__ void sort_keys(int (&x)[N]) {
#pragma unroll
  for (int k = 2; k <= N; k *= 2)
#pragma unroll
    for (int j = k / 2; j > 0; j /= 2)
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const int l = i ^ j;
        if (l > i) {
          if ((i & k) == 0) exchange(x[i], x[l]);
          else exchange(x[l], x[i]);
        }
      }
}

// best := the N smallest of best ∪ batch, ascending; both come in ascending.
template <int N>
__device__ __forceinline__ void merge_keys(int (&best)[N], const int (&batch)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) best[i] = min(best[i], batch[N - 1 - i]);
#pragma unroll
  for (int j = N / 2; j > 0; j /= 2)
#pragma unroll
    for (int i = 0; i < N; ++i)
      if ((i & j) == 0) exchange(best[i], best[i + j]);
}

template <int N>
__device__ __forceinline__ void load_keys(int (&x)[N], const float* row, int c0,
                                          int j0, int ls, int lim) {
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = member_key(row, c0, j0 + i, ls, lim);
}

// Round r's key of a bin from its ascending keys: S[0], then clamped to +inf
// at payload 0. Writes d2 and col; returns d2's bits.
__device__ __forceinline__ unsigned emit(const Args& a, long long o, int r,
                                         int key, int b) {
  if (r > 0) key = min(key, kInfKey);
  const int d = key & kKeyMask;
  const long long at = o + (long long)r * a.bins2;
  a.d2[at] = __int_as_float(d);
  a.col[at] = (key & 0x7F) * a.ls + b * a.bs;
  return (unsigned)d;
}

// The least over a query row's bins of the last round's bits: a warp's
// minimum, then one atomic a warp. Every lane of the warp takes part.
__device__ __forceinline__ void fold_worst(const Args& a, int q, unsigned w) {
  w = __reduce_min_sync(0xFFFFFFFFu, w);
  if ((threadIdx.x & 31) == 0) atomicMin(a.worst2 + q, w);
}

template <int CAP>
__global__ void __launch_bounds__(kRegThreads)
level2_registers(Args a) {
  static_assert(kBin % CAP == 0 && (CAP & (CAP - 1)) == 0, "batches tile a bin");
  const int q = blockIdx.x / a.nblk;
  const int b = (blockIdx.x % a.nblk) * kRegThreads + threadIdx.x;
  if (b - (int)(threadIdx.x & 31) >= a.bins2) return;   // the whole warp is past
  const bool live = b < a.bins2;
  const float* row = a.s + (long long)q * a.W;
  const int c0 = live ? b * a.bs : 0;
  const int lim = live ? a.W : 0;

  int best[CAP], batch[CAP], next[CAP];
  load_keys(best, row, c0, 0, a.ls, lim);
  load_keys(next, row, c0, CAP, a.ls, lim);
  sort_keys(best);
#pragma unroll 1
  for (int j0 = CAP; j0 < kBin; j0 += CAP) {
#pragma unroll
    for (int i = 0; i < CAP; ++i) batch[i] = next[i];
    if (j0 + CAP < kBin) load_keys(next, row, c0, j0 + CAP, a.ls, lim);
    sort_keys(batch);
    merge_keys(best, batch);
  }

  unsigned w = 0xFFFFFFFFu;
  if (live) {
    const long long o = (long long)q * a.rounds * a.bins2 + b;
#pragma unroll
    for (int r = 0; r < CAP; ++r)
      if (r < a.rounds) {
        const unsigned d = emit(a, o, r, best[r], b);
        if (r == a.rounds - 1) w = d;
      }
  }
  fold_worst(a, q, w);
}

__global__ void __launch_bounds__(kSharedThreads)
level2_shared(Args a) {
  __shared__ int keys[kBin * kSharedThreads];   // [member][thread]
  const int q = blockIdx.x / a.nblk;
  const int b = (blockIdx.x % a.nblk) * kSharedThreads + threadIdx.x;
  if (b - (int)(threadIdx.x & 31) >= a.bins2) return;
  const bool live = b < a.bins2;
  const float* row = a.s + (long long)q * a.W;
  const int c0 = live ? b * a.bs : 0;
  const int lim = live ? a.W : 0;
  int* mine = keys + threadIdx.x;
  for (int j = 0; j < kBin; ++j)
    mine[j * kSharedThreads] = member_key(row, c0, j, a.ls, lim);

  unsigned w = 0xFFFFFFFFu;
  if (live) {
    const long long o = (long long)q * a.rounds * a.bins2 + b;
    int last = INT_MIN;
    for (int r = 0; r < a.rounds; ++r) {
      int m = INT_MAX;
      for (int j = 0; j < kBin; ++j) {
        const int k = mine[j * kSharedThreads];
        if (r == 0 || k > last) m = min(m, k);
      }
      last = m;
      w = emit(a, o, r, m, b);
    }
  }
  fold_worst(a, q, w);
}

}  // namespace

// 0: the register body (rounds ≤ 16), 1: the shared-memory body.
extern "C" int hvq_level2_select_body(int rounds) {
  return rounds <= kMaxRegRounds ? 0 : 1;
}

// Plain C entry point for ctypes. s is the (B, W) fp32 stream on the
// device, contiguous; (ls, bs) the member and bin strides in columns, one
// of (⌈W/128⌉, 1) (axis1) and (1, 128) (lane); d2 and col are
// (B, rounds·⌈W/128⌉), worst2 (B,). Returns 0 on success or the
// cudaError_t of a failed memset or launch.
extern "C" int hvq_level2_select(const float* s, int B, int W, int rounds,
                                 int ls, int bs, float* d2, int* col,
                                 float* worst2, void* stream) {
  if (B < 1 || W < 1 || rounds < 1 || rounds > kBin) return (int)cudaErrorInvalidValue;
  const int bins2 = (int)(((long long)W + kBin - 1) / kBin);
  if ((long long)bins2 * kBin > INT_MAX) return (int)cudaErrorInvalidValue;   // int columns
  if (!((ls == bins2 && bs == 1) || (ls == 1 && bs == kBin)))
    return (int)cudaErrorInvalidValue;
  const int threads = rounds <= kMaxRegRounds ? kRegThreads : kSharedThreads;
  const int nblk = (bins2 + threads - 1) / threads;
  if ((long long)B * nblk > INT_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(worst2, 0xFF, sizeof(float) * (size_t)B, st);
  if (e != cudaSuccess) return (int)e;
  Args a{s, d2, col, reinterpret_cast<unsigned*>(worst2), W, bins2, rounds,
         ls, bs, nblk};
  const dim3 grid((unsigned)(B * nblk));
  if (rounds <= 8) level2_registers<8><<<grid, kRegThreads, 0, st>>>(a);
  else if (rounds <= kMaxRegRounds) level2_registers<16><<<grid, kRegThreads, 0, st>>>(a);
  else level2_shared<<<grid, kSharedThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}
