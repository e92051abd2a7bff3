// hvq_native — the host runtime of the PyTorch port, in C++.
//
// The port's own copy of the JAX package's hvq_native.cpp (the same C
// ABI, the same bytes out of the generators): the host-side roles the
// reference implements natively.
//   * binary dataset IO (reference include/io.h) — mmap-based with
//     sequential-access madvise and a parallel copy-out, instead of one
//     ifstream.read per record (io.h:125-133);
//   * synthetic data/query generation (reference src/write_data.c,
//     src/write_query.c) — multi-threaded xoshiro256** fills;
//   * hardware perf counters (reference include/perfevent.hpp) — a
//     perf_event_open wrapper with the same counter set (cycles, kernel
//     cycles, instructions, L1-d misses, LLC misses, branch misses,
//     task-clock) exposed through a start/stop/read C ABI.
//
// hvq_tpu_torch/native/__init__.py compiles this file with g++ at first
// use into hvq_tpu_torch/_build/ (keyed by a hash of the source and the
// flags) and binds it through ctypes.

#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstring>
#include <random>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#if defined(__linux__)
#include <linux/perf_event.h>
#include <sys/ioctl.h>
#include <sys/syscall.h>
#endif

extern "C" {

// ---------------------------------------------------------------------------
// mmap'd record-file reading
// ---------------------------------------------------------------------------

// Read a count-prefixed float32 record file (uint32 N + N*record_dim floats)
// into caller-allocated memory. Returns N on success, -1 on error.
// Parallel copy-out across `threads` workers; the mapping is advised
// MADV_SEQUENTIAL so the kernel prefetches ahead of the copy streams.
long long hvq_read_records(const char* path, long long record_dim,
                           float* out, long long out_capacity_records,
                           int threads) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -1;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size < 4) {
    close(fd);
    return -1;
  }
  void* base = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  close(fd);
  if (base == MAP_FAILED) return -1;
  madvise(base, st.st_size, MADV_SEQUENTIAL);

  uint32_t n;
  std::memcpy(&n, base, 4);
  const long long total = (long long)n * record_dim;
  if ((long long)st.st_size - 4 < total * 4 || out_capacity_records < n) {
    munmap(base, st.st_size);
    return -1;
  }
  const float* src = reinterpret_cast<const float*>(
      static_cast<const char*>(base) + 4);

  int t = threads > 0 ? threads : (int)std::thread::hardware_concurrency();
  if (t < 1) t = 1;
  std::vector<std::thread> workers;
  const long long chunk = (total + t - 1) / t;
  for (int w = 0; w < t; ++w) {
    const long long s = w * chunk;
    const long long e = s + chunk < total ? s + chunk : total;
    if (s >= e) break;
    workers.emplace_back([=]() {
      std::memcpy(out + s, src + s, (e - s) * sizeof(float));
    });
  }
  for (auto& th : workers) th.join();
  munmap(base, st.st_size);
  return n;
}

// Peek the record count without reading the payload.
long long hvq_record_count(const char* path) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -1;
  uint32_t n;
  ssize_t got = read(fd, &n, 4);
  close(fd);
  return got == 4 ? (long long)n : -1;
}

// Write a count-prefixed float32 record file. Returns 0 on success.
int hvq_write_records(const char* path, const float* data, long long n,
                      long long record_dim) {
  int fd = open(path, O_CREAT | O_TRUNC | O_WRONLY, 0644);
  if (fd < 0) return -1;
  uint32_t n32 = (uint32_t)n;
  if (write(fd, &n32, 4) != 4) {
    close(fd);
    return -1;
  }
  long long remaining = n * record_dim * (long long)sizeof(float);
  const char* p = reinterpret_cast<const char*>(data);
  while (remaining > 0) {
    ssize_t w = write(fd, p, remaining);
    if (w <= 0) {
      close(fd);
      return -1;
    }
    p += w;
    remaining -= w;
  }
  return close(fd);
}

// ---------------------------------------------------------------------------
// threaded synthetic generation (write_data.c / write_query.c semantics)
// ---------------------------------------------------------------------------

namespace {

struct Xoshiro256 {
  uint64_t s[4];
  explicit Xoshiro256(uint64_t seed) {
    // splitmix64 expansion
    for (int i = 0; i < 4; ++i) {
      seed += 0x9e3779b97f4a7c15ULL;
      uint64_t z = seed;
      z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
      z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
      s[i] = z ^ (z >> 31);
    }
  }
  static uint64_t rotl(uint64_t x, int k) { return (x << k) | (x >> (64 - k)); }
  uint64_t next() {
    const uint64_t result = rotl(s[1] * 5, 7) * 9;
    const uint64_t t = s[1] << 17;
    s[2] ^= s[0];
    s[3] ^= s[1];
    s[1] ^= s[2];
    s[0] ^= s[3];
    s[2] ^= t;
    s[3] = rotl(s[3], 45);
    return result;
  }
  // uniform in [lo, hi)
  float uniform(float lo, float hi) {
    const float u = (next() >> 40) * (1.0f / 16777216.0f);
    return lo + u * (hi - lo);
  }
  uint32_t below(uint32_t bound) { return (uint32_t)(next() % bound); }
};

}  // namespace

// Fill n data records (102 floats: C, T, 100 dims) with the reference
// generator's value ranges (write_data.c:26-42). categories <= 0 keeps the
// continuous C; otherwise C is discretized to `categories` levels in [-1,1].
void hvq_gen_data(float* out, long long n, uint64_t seed, int categories,
                  int threads) {
  int t = threads > 0 ? threads : (int)std::thread::hardware_concurrency();
  if (t < 1) t = 1;
  std::vector<std::thread> workers;
  const long long chunk = (n + t - 1) / t;
  for (int w = 0; w < t; ++w) {
    const long long s = w * chunk;
    const long long e = s + chunk < n ? s + chunk : n;
    if (s >= e) break;
    workers.emplace_back([=]() {
      Xoshiro256 rng(seed * 0x9e3779b9u + (uint64_t)w);
      for (long long i = s; i < e; ++i) {
        float* rec = out + i * 102;
        if (categories > 0) {
          uint32_t c = rng.below((uint32_t)categories);
          rec[0] = categories == 1
                       ? -1.0f
                       : -1.0f + 2.0f * (float)c / (float)(categories - 1);
        } else {
          rec[0] = rng.uniform(-1.0f, 1.0f);
        }
        rec[1] = rng.uniform(-3.0f, 3.0f);
        for (int d = 0; d < 100; ++d) rec[2 + d] = rng.uniform(-6.0f, 6.0f);
      }
    });
  }
  for (auto& th : workers) th.join();
}

// Fill m query records (104 floats: type, v, l, r, 100 dims) with the
// reference generator's semantics (write_query.c:28-58).
void hvq_gen_queries(float* out, long long m, uint64_t seed, int categories,
                     int threads) {
  int t = threads > 0 ? threads : (int)std::thread::hardware_concurrency();
  if (t < 1) t = 1;
  std::vector<std::thread> workers;
  const long long chunk = (m + t - 1) / t;
  for (int w = 0; w < t; ++w) {
    const long long s = w * chunk;
    const long long e = s + chunk < m ? s + chunk : m;
    if (s >= e) break;
    workers.emplace_back([=]() {
      Xoshiro256 rng(seed * 0x51d7348du + (uint64_t)w);
      for (long long i = s; i < e; ++i) {
        float* rec = out + i * 104;
        const uint32_t type = rng.below(4);
        rec[0] = (float)type;
        const bool has_c = type == 1 || type == 3;
        const bool has_t = type == 2 || type == 3;
        if (has_c) {
          if (categories > 0) {
            uint32_t c = rng.below((uint32_t)categories);
            rec[1] = categories == 1
                         ? -1.0f
                         : -1.0f + 2.0f * (float)c / (float)(categories - 1);
          } else {
            rec[1] = rng.uniform(-1.0f, 1.0f);
          }
        } else {
          rec[1] = -1.0f;
        }
        if (has_t) {
          const float l = rng.uniform(-3.0f, 3.0f);
          rec[2] = l;
          rec[3] = rng.uniform(l, 4.0f);  // r in [l, 4]: never empty
        } else {
          rec[2] = -1.0f;
          rec[3] = -1.0f;
        }
        for (int d = 0; d < 100; ++d) rec[4 + d] = rng.uniform(-6.0f, 6.0f);
      }
    });
  }
  for (auto& th : workers) th.join();
}

// ---------------------------------------------------------------------------
// hardware perf counters (perfevent.hpp capability, fresh implementation)
// ---------------------------------------------------------------------------

#if defined(__linux__)

namespace {

struct ReadFormat {
  uint64_t value;
  uint64_t time_enabled;
  uint64_t time_running;
};

struct Counter {
  int fd = -1;
  ReadFormat prev{}, snapshot{};
};

struct PerfSession {
  std::vector<Counter> counters;
};

int open_counter(uint32_t type, uint64_t config) {
  perf_event_attr attr{};
  attr.type = type;
  attr.size = sizeof(attr);
  attr.config = config;
  attr.disabled = 1;
  attr.inherit = 1;
  attr.exclude_kernel = 0;
  attr.exclude_hv = 0;
  attr.read_format =
      PERF_FORMAT_TOTAL_TIME_ENABLED | PERF_FORMAT_TOTAL_TIME_RUNNING;
  return (int)syscall(__NR_perf_event_open, &attr, 0, -1, -1, 0);
}

}  // namespace

// Counter order (fixed ABI, mirrored in the Python binding):
// 0 cycles, 1 kcycles, 2 instructions, 3 L1d-read-misses, 4 LLC-misses,
// 5 branch-misses, 6 task-clock-ns.
void* hvq_perf_open() {
  auto* s = new PerfSession();
  s->counters.resize(7);
  s->counters[0].fd =
      open_counter(PERF_TYPE_HARDWARE, PERF_COUNT_HW_CPU_CYCLES);
  {
    perf_event_attr attr{};
    attr.type = PERF_TYPE_HARDWARE;
    attr.size = sizeof(attr);
    attr.config = PERF_COUNT_HW_CPU_CYCLES;
    attr.disabled = 1;
    attr.inherit = 1;
    attr.exclude_user = 1;  // kernel-only cycles
    attr.read_format =
        PERF_FORMAT_TOTAL_TIME_ENABLED | PERF_FORMAT_TOTAL_TIME_RUNNING;
    s->counters[1].fd =
        (int)syscall(__NR_perf_event_open, &attr, 0, -1, -1, 0);
  }
  s->counters[2].fd =
      open_counter(PERF_TYPE_HARDWARE, PERF_COUNT_HW_INSTRUCTIONS);
  s->counters[3].fd = open_counter(
      PERF_TYPE_HW_CACHE,
      PERF_COUNT_HW_CACHE_L1D | (PERF_COUNT_HW_CACHE_OP_READ << 8) |
          (PERF_COUNT_HW_CACHE_RESULT_MISS << 16));
  s->counters[4].fd =
      open_counter(PERF_TYPE_HARDWARE, PERF_COUNT_HW_CACHE_MISSES);
  s->counters[5].fd =
      open_counter(PERF_TYPE_HARDWARE, PERF_COUNT_HW_BRANCH_MISSES);
  s->counters[6].fd =
      open_counter(PERF_TYPE_SOFTWARE, PERF_COUNT_SW_TASK_CLOCK);
  return s;
}

void hvq_perf_start(void* handle) {
  auto* s = static_cast<PerfSession*>(handle);
  for (auto& c : s->counters) {
    if (c.fd < 0) continue;
    ioctl(c.fd, PERF_EVENT_IOC_RESET, 0);
    ioctl(c.fd, PERF_EVENT_IOC_ENABLE, 0);
    (void)read(c.fd, &c.prev, sizeof(c.prev));
  }
}

void hvq_perf_stop(void* handle) {
  auto* s = static_cast<PerfSession*>(handle);
  for (auto& c : s->counters) {
    if (c.fd < 0) continue;
    (void)read(c.fd, &c.snapshot, sizeof(c.snapshot));
    ioctl(c.fd, PERF_EVENT_IOC_DISABLE, 0);
  }
}

// Multiplex-corrected deltas into out[7]; missing counters give -1.
void hvq_perf_read(void* handle, double* out) {
  auto* s = static_cast<PerfSession*>(handle);
  for (size_t i = 0; i < s->counters.size(); ++i) {
    auto& c = s->counters[i];
    if (c.fd < 0) {
      out[i] = -1.0;
      continue;
    }
    const double dv = (double)(c.snapshot.value - c.prev.value);
    const double de =
        (double)(c.snapshot.time_enabled - c.prev.time_enabled);
    const double dr =
        (double)(c.snapshot.time_running - c.prev.time_running);
    out[i] = dr > 0 ? dv * (de / dr) : dv;  // scale for multiplexing
  }
}

void hvq_perf_close(void* handle) {
  auto* s = static_cast<PerfSession*>(handle);
  for (auto& c : s->counters)
    if (c.fd >= 0) close(c.fd);
  delete s;
}

#else  // non-Linux stubs

void* hvq_perf_open() { return nullptr; }
void hvq_perf_start(void*) {}
void hvq_perf_stop(void*) {}
void hvq_perf_read(void*, double* out) {
  for (int i = 0; i < 7; ++i) out[i] = -1.0;
}
void hvq_perf_close(void*) {}

#endif

}  // extern "C"
