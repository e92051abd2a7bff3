// Concurrency self-test for the port's native host runtime.
//
// The only threaded host code of the port is hvq_native.cpp (parallel
// generator fills and the mmap reader's parallel copy-out). This binary
// exercises both under concurrency: the generator twice at the same seed
// (bit-identical), a write and a threaded read back of the same bytes.
// Built with g++ by hvq_tpu_torch.native.self_test(); add
// -fsanitize=thread to the flags to check the threads for races.
//
//     self_test <scratch file path>

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {
long long hvq_read_records(const char*, long long, float*, long long, int);
int hvq_write_records(const char*, const float*, long long, long long);
void hvq_gen_data(float*, long long, uint64_t, int, int);
void hvq_gen_queries(float*, long long, uint64_t, int, int);
}

int main(int argc, char** argv) {
  const long long n = 20000;
  std::vector<float> data((size_t)n * 102);
  hvq_gen_data(data.data(), n, 42, 16, 4);   // 4 threads write disjoint rows

  // determinism across thread counts of the same worker split
  std::vector<float> data2((size_t)n * 102);
  hvq_gen_data(data2.data(), n, 42, 16, 4);
  if (std::memcmp(data.data(), data2.data(), data.size() * 4) != 0) {
    std::fprintf(stderr, "FAIL: generator not deterministic\n");
    return 1;
  }

  const char* path = argc > 1 ? argv[1] : "hvq_native_selftest.bin";
  if (hvq_write_records(path, data.data(), n, 102) != 0) {
    std::fprintf(stderr, "FAIL: write\n");
    return 1;
  }
  std::vector<float> back((size_t)n * 102);
  long long got = hvq_read_records(path, 102, back.data(), n, 4);
  if (got != n ||
      std::memcmp(back.data(), data.data(), back.size() * 4) != 0) {
    std::fprintf(stderr, "FAIL: read round-trip (%lld)\n", got);
    return 1;
  }

  std::vector<float> q((size_t)1000 * 104);
  hvq_gen_queries(q.data(), 1000, 7, 8, 4);
  std::remove(path);
  std::printf("native self-test OK\n");
  return 0;
}
