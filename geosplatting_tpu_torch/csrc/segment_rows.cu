// K3: inclusive prefix sum along axis 0 of a row-major [M, C] float32 array.
//
// Replaces geosplatting_tpu/ops/segment_rows.py:_cumsum_kernel (the Pallas
// blocked cumsum launched by blocked_cumsum), which on the TPU ran 256-row
// triangular matmuls with a sequential carry across its grid.
//
// Bound on the H100: bytes. The scan does one add per element, so at the
// stage-1 shape ([1.4M, 10] f32 = 56 MB in, 56 MB out) the least time is
// 112 MB over 3.35 TB/s, about 33 us; arithmetic is negligible.
//
// Design: a three-pass block scan, because CTAs run in no order and cannot
// carry a sum across the grid the way the TPU's sequential grid did.
//   1. block_column_sums: each CTA owns a contiguous chunk of rows and writes
//      its per-column totals.
//   2. block_scan over the [num_blocks, C] totals in one CTA gives each
//      chunk its exclusive per-column offset.
//   3. block_scan over the data: every CTA rescans its chunk from its offset.
// Inside a CTA the threads form (column, row range) pairs, so each thread
// walks a contiguous run of rows of one column and keeps its running sum in
// a register (f32 accumulation throughout). The data is read twice and
// written once; a single-pass decoupled look-back scan is the later
// optimisation that would reach the one-read bound.
#include "common.cuh"

namespace geosplat {

constexpr int kScanThreads = 256;
constexpr int kScanRowsPerThread = 16;

__device__ __forceinline__ void thread_rows(long long num_rows, int rows_per_thread,
                                            int cols, long long& r0, long long& r1) {
  const int threads_per_col = blockDim.x / cols;
  const int j = threadIdx.x / cols;
  const long long chunk = (long long)threads_per_col * rows_per_thread;
  r0 = (long long)blockIdx.x * chunk + (long long)j * rows_per_thread;
  r1 = r0 + rows_per_thread;
  if (r1 > num_rows) r1 = num_rows;
}

__global__ void __launch_bounds__(kScanThreads)
block_column_sums(const float* __restrict__ x, float* __restrict__ totals,
                  long long num_rows, int cols, int rows_per_thread) {
  __shared__ float part[kScanThreads];
  const int tid = threadIdx.x;
  const int c = tid % cols;
  long long r0, r1;
  thread_rows(num_rows, rows_per_thread, cols, r0, r1);
  float s = 0.0f;
  for (long long r = r0; r < r1; ++r) s += x[r * cols + c];
  part[tid] = s;
  __syncthreads();
  if (tid < cols) {
    const int threads_per_col = blockDim.x / cols;
    float t = 0.0f;
    for (int q = 0; q < threads_per_col; ++q) t += part[q * cols + tid];
    totals[(long long)blockIdx.x * cols + tid] = t;
  }
}

// Scan of each CTA's chunk, starting from offsets[blockIdx.x] (or 0).
__global__ void __launch_bounds__(kScanThreads)
block_scan(const float* __restrict__ x, float* __restrict__ out,
           const float* __restrict__ offsets, long long num_rows, int cols,
           int rows_per_thread, int exclusive) {
  __shared__ float part[kScanThreads];
  const int tid = threadIdx.x;
  const int c = tid % cols;
  const int j = tid / cols;
  long long r0, r1;
  thread_rows(num_rows, rows_per_thread, cols, r0, r1);
  float s = 0.0f;
  for (long long r = r0; r < r1; ++r) s += x[r * cols + c];
  part[tid] = s;
  __syncthreads();
  float run = offsets != nullptr ? offsets[(long long)blockIdx.x * cols + c] : 0.0f;
  for (int q = 0; q < j; ++q) run += part[q * cols + c];
  for (long long r = r0; r < r1; ++r) {
    const float v = x[r * cols + c];
    if (exclusive) {
      out[r * cols + c] = run;
      run += v;
    } else {
      run += v;
      out[r * cols + c] = run;
    }
  }
}

struct ScanShape {
  int threads;
  long long num_blocks;
  int top_rows_per_thread;
};

static ScanShape scan_shape(long long num_rows, int cols) {
  ScanShape s;
  const int threads_per_col = kScanThreads / cols;
  s.threads = threads_per_col * cols;
  const long long chunk = (long long)threads_per_col * kScanRowsPerThread;
  s.num_blocks = (num_rows + chunk - 1) / chunk;
  s.top_rows_per_thread = (int)((s.num_blocks + threads_per_col - 1) / threads_per_col);
  return s;
}

}  // namespace geosplat

using namespace geosplat;

extern "C" {

// Scratch floats the caller allocates for k3_cumsum_rows.
long long k3_scratch_floats(long long num_rows, int cols) {
  if (num_rows <= 0 || cols <= 0 || cols > kScanThreads) return -1;
  return 2 * scan_shape(num_rows, cols).num_blocks * cols;
}

int k3_cumsum_rows(const float* x, float* out, float* scratch, long long num_rows,
                   int cols, void* stream) {
  if (num_rows <= 0 || cols <= 0 || cols > kScanThreads) return (int)cudaErrorInvalidValue;
  const ScanShape s = scan_shape(num_rows, cols);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* totals = scratch;
  float* offsets = scratch + s.num_blocks * cols;
  block_column_sums<<<(unsigned)s.num_blocks, s.threads, 0, st>>>(
      x, totals, num_rows, cols, kScanRowsPerThread);
  block_scan<<<1, s.threads, 0, st>>>(totals, offsets, nullptr, s.num_blocks, cols,
                                      s.top_rows_per_thread, 1);
  block_scan<<<(unsigned)s.num_blocks, s.threads, 0, st>>>(
      x, out, offsets, num_rows, cols, kScanRowsPerThread, 0);
  return (int)cudaGetLastError();
}

const char* geosplat_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
