// Phase times of K3 (csrc/segment_rows.cu) tile by tile, on one GPU.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -DGEOSPLAT_K3_STAMPS \
//        -I geosplatting_tpu_torch/csrc -o k3_probe k3_probe.cu && ./k3_probe
//
// Runs K3 on a seeded [1.4M, 10] f32 input (the stage-1 slice's shape) five
// times and, for the last run, prints one JSON object: the kernel's span,
// the mean microseconds of each phase of a tile by decile of tile id
// (local: staged -> scanned; wait: scanned -> published and every earlier
// word it needs seen; carry; store: rescan and stores issued), and how many
// tiles were in each phase at 13 instants.
#include "segment_rows.cu"

#include <algorithm>
#include <cstdio>
#include <vector>

int main() {
  using namespace geosplat;
  const long long M = 1400000;
  const int C = 10;
  std::vector<float> h(M * C);
  unsigned s = 1;
  for (auto& v : h) {
    s = s * 1664525u + 1013904223u;
    v = ((s >> 8) & 0xffff) / 65536.0f - 0.5f;
  }
  float *x, *out, *scratch;
  unsigned long long* stamps;
  const ScanShape sh = scan_shape(M, C);
  const long long T = sh.num_tiles;
  if (cudaMalloc(&x, M * C * 4) || cudaMalloc(&out, M * C * 4) ||
      cudaMalloc(&scratch, k3_scratch_floats(M, C) * 4) || cudaMalloc(&stamps, T * 64)) {
    fprintf(stderr, "k3_probe: cudaMalloc failed\n");
    return 1;
  }
  cudaMemcpy(x, h.data(), M * C * 4, cudaMemcpyHostToDevice);
  cudaMemcpyToSymbol(k3_stamps, &stamps, sizeof(stamps));
  for (int r = 0; r < 5; ++r) {
    cudaMemset(stamps, 0, T * 64);
    const int status = k3_cumsum_rows(x, out, scratch, M, C, nullptr);
    if (status != 0 || cudaDeviceSynchronize() != cudaSuccess) {
      fprintf(stderr, "k3_probe: K3 failed (%d)\n", status);
      return 1;
    }
  }
  std::vector<unsigned long long> t(T * 8);
  cudaMemcpy(t.data(), stamps, T * 64, cudaMemcpyDeviceToHost);
  unsigned long long t0 = ~0ull, t1 = 0;
  for (long long i = 0; i < T; ++i) {
    t0 = std::min(t0, t[i * 8]);
    t1 = std::max(t1, t[i * 8 + 4]);
  }
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k3_scan, kScanThreads, sh.smem_bytes);
  printf("{\"shape\": [%lld, %d], \"tiles\": %lld, \"ctas_per_sm\": %d, \"group\": %d, "
         "\"span_us\": %.2f, \"deciles_us\": [", M, C, T, per_sm, sh.group, (t1 - t0) / 1e3);
  for (int d = 0; d < 10; ++d) {
    const long long lo = T * d / 10, hi = T * (d + 1) / 10;
    double acc[4] = {0, 0, 0, 0}, start = 0;
    for (long long i = lo; i < hi; ++i) {
      start += t[i * 8] - t0;
      for (int k = 0; k < 4; ++k) acc[k] += t[i * 8 + k + 1] - t[i * 8 + k];
    }
    const double n = 1e3 * (hi - lo);
    printf("%s{\"start\": %.2f, \"local\": %.2f, \"wait\": %.2f, \"carry\": %.2f, "
           "\"store\": %.2f}", d ? ", " : "", start / n, acc[0] / n, acc[1] / n, acc[2] / n,
           acc[3] / n);
  }
  printf("], \"in_phase\": [");
  for (int k = 0; k <= 12; ++k) {
    const unsigned long long at = t0 + (t1 - t0) * k / 12;
    int cnt[4] = {0, 0, 0, 0};
    for (long long i = 0; i < T; ++i)
      for (int q = 0; q < 4; ++q) cnt[q] += t[i * 8 + q] <= at && at < t[i * 8 + q + 1];
    printf("%s{\"at_us\": %.1f, \"local\": %d, \"wait\": %d, \"carry\": %d, \"store\": %d}",
           k ? ", " : "", (at - t0) / 1e3, cnt[0], cnt[1], cnt[2], cnt[3]);
  }
  printf("]}\n");
  return 0;
}
