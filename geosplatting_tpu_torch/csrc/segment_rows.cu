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
// Design: one pass, so the input is read once and the output written once.
//   * Tiles. Persistent CTAs take tile ids from an atomic counter, in order,
//     and stage each tile of R rows, one contiguous span of R * C floats, in
//     shared memory with 16-byte cp.async copies, the next tile's while the
//     current one is scanned (two buffers).
//   * Scan inside the tile. Thread (run j, column c) walks rows
//     [j L, (j + 1) L) of column c in shared memory. L is chosen with
//     (L - 1) C = 0 mod 32, so the 32 threads of a warp read 32 distinct
//     banks. The run totals are scanned per column with warp shuffles.
//   * Carry between tiles: the deterministic variant of decoupled look-back
//     (Merrill & Garland, "Single-pass Parallel Prefix Scan with Decoupled
//     Look-back", 2016), in two levels. Each tile publishes its per-column
//     aggregate behind a flag; the last tile of each group of G ~ sqrt(T)
//     tiles also publishes the group's sum. A tile's carry is the sum of the
//     groups before its own and of the tiles before it in its group, at most
//     about 2 sqrt(T) rows of C floats read with 16-byte loads in a fixed
//     order. No tile waits for another's carry, only for aggregates published
//     right after a local scan, and the result is the same bits from run to
//     run. Each published value travels with its flag in one 64-bit word
//     (flag in the high half), stored and loaded as a single-copy-atomic
//     access: a reader spins on the words themselves, and no release fence
//     makes a tile wait for its earlier output stores to drain.
//   * The tile is rescanned in shared memory from its carry and stored back
//     with 16-byte stores.
// The words and the tile counter live in the caller's scratch and are zeroed
// by one cudaMemsetAsync on the same stream before the kernel.
//
// Measured on the H100 at [1.4M, 10] (PERF.md, compare_composite_trees.py
// time-k3): 65 us, against 88 us for the three-pass scan this replaces. Each
// tile's time now goes mostly to waiting, in rounds of CTAs that started
// together, for the aggregates of its round's earlier tiles. Designs that
// measured slower: look-back to the nearest published prefix (89-95 us, the
// tiles waiting on the chain of prefixes), a one-level carry over every
// predecessor's aggregate (82 us, the CTAs reading the same L2 lines), and
// flags published by release stores (81 us: each release waited for the
// CTA's previous tile's output stores to drain).
#include "common.cuh"

#include <cstdint>

namespace geosplat {

// Per-tile phase times for k3_probe.cu (built with -DGEOSPLAT_K3_STAMPS);
// nothing otherwise.
#ifdef GEOSPLAT_K3_STAMPS
__device__ unsigned long long* k3_stamps;   // [T, 8] %globaltimer ns, set by the probe
#define K3_STAMP(k)                                                                  \
  do {                                                                               \
    if (threadIdx.x == 0) {                                                          \
      unsigned long long t;                                                          \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));                          \
      k3_stamps[tile * 8 + (k)] = t;                                                 \
    }                                                                                \
  } while (0)
#else
#define K3_STAMP(k) \
  do {              \
  } while (0)
#endif

constexpr int kScanThreads = 256;
constexpr int kScanWarps = kScanThreads / 32;
constexpr int kTileFloats = 8192;   // target floats of one staged tile
constexpr int kCarryLoads = 4;      // 16-byte word loads a thread keeps in flight

using Word = unsigned long long;    // a published float in the low half, 1 in the high half

__device__ __forceinline__ Word publish_word(float v) {
  return (1ull << 32) | __float_as_uint(v);
}

__device__ __forceinline__ void store_word(Word* p, Word w) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;\n" ::"l"(p), "l"(w) : "memory");
}

// Two words with one 16-byte access; each word is read single-copy atomic.
__device__ __forceinline__ void load_words(const Word* p, Word& a, Word& b) {
  asm volatile("ld.volatile.global.v2.u64 {%0, %1}, [%2];\n"
               : "=l"(a), "=l"(b) : "l"(p) : "memory");
}

__device__ __forceinline__ Word load_word(const Word* p) {
  Word w;
  asm volatile("ld.volatile.global.u64 %0, [%1];\n" : "=l"(w) : "l"(p) : "memory");
  return w;
}

__device__ __forceinline__ float warp_inclusive_scan(float v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float t = __shfl_up_sync(kFullMask, v, d);
    if (lane >= d) v += t;
  }
  return v;
}

struct ScanShape {
  int runs;        // P: row runs per column (P * C <= kScanThreads threads walk)
  int run_rows;    // L: rows a walking thread scans
  int tile_rows;   // R: rows of one tile, a multiple of 4
  long long num_tiles;
  int group;       // G: tiles of a group, a multiple of 4 near sqrt(T)
  long long num_groups;
  size_t smem_bytes;
};

static int gcd(int a, int b) { return b == 0 ? a : gcd(b, a % b); }

static ScanShape scan_shape(long long num_rows, int cols) {
  ScanShape s;
  s.runs = kScanThreads / cols;
  // (L - 1) * C = 0 mod 32 keeps a warp's column reads on distinct banks
  const int step = 32 / gcd(cols, 32);
  const int want = (kTileFloats / cols + s.runs - 1) / s.runs;
  s.run_rows = 1 + (want - 1 + step - 1) / step * step;
  s.tile_rows = s.runs * s.run_rows / 4 * 4;   // >= 32 for every C in 1..256
  s.num_tiles = (num_rows + s.tile_rows - 1) / s.tile_rows;
  int g = 4;
  while ((long long)g * g < s.num_tiles) g += 4;
  s.group = g;
  s.num_groups = (s.num_tiles + g - 1) / g;
  // two tile buffers, run totals and offsets, carry partials, three [C]
  // vectors and the per-thread sums of the carry
  s.smem_bytes = sizeof(float) * (2 * (size_t)s.tile_rows * cols + 2 * (size_t)s.runs * cols
                                  + 3 * (size_t)cols + 2 * kScanThreads);
  return s;
}

// Scratch, all zeroed before each launch: the tile counter (padded to 16
// bytes), the tiles' aggregate words (T * C, padded to an even count) and
// the groups' sum words (NG * C). Both arrays, and the words of each group
// of tiles (G % 4 == 0), start 16-byte aligned.
struct ScanScratch {
  unsigned* counter;
  Word* agg;
  Word* group_sum;
};

static long long agg_words(const ScanShape& s, int cols) {
  return (s.num_tiles * cols + 1) / 2 * 2;
}

static long long scratch_bytes(const ScanShape& s, int cols) {
  return 16 + (long long)sizeof(Word) * (agg_words(s, cols) + s.num_groups * cols);
}

static ScanScratch scratch_layout(float* scratch, const ScanShape& s, int cols) {
  ScanScratch sc;
  sc.counter = reinterpret_cast<unsigned*>(scratch);
  sc.agg = reinterpret_cast<Word*>(scratch + 4);
  sc.group_sum = sc.agg + agg_words(s, cols);
  return sc;
}

// Words per round of the carry's 16-byte loads: a multiple of 2 and of C, so
// that every word a thread loads belongs to the same 2 columns in every
// round, and at most 2 * kScanThreads.
static int carry_stride(int cols) {
  const int l = 2 / gcd(cols, 2) * cols;   // lcm(2, C)
  return 2 * kScanThreads / l * l;
}

// Starts staging tile `tile` (its n floats) into buf: 16-byte copies with
// cp.async (committed as one group) where both pointers allow, else 4-byte
// loads that complete here.
__device__ __forceinline__ void stage_tile(float* buf, const float* x, long long tile,
                                           long long num_rows, int cols, int tile_rows,
                                           int vec) {
  const long long r0 = tile * tile_rows;
  const int n = (int)min((long long)tile_rows, num_rows - r0) * cols;
  const float* src = x + r0 * cols;
  int head = 0;
  if (vec) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* b4 = reinterpret_cast<float4*>(buf);
    for (int i = threadIdx.x; i < n / 4; i += kScanThreads) cp_async16(b4 + i, s4 + i);
    head = n / 4 * 4;
  }
  asm volatile("cp.async.commit_group;\n" ::);
  for (int i = head + threadIdx.x; i < n; i += kScanThreads) buf[i] = __ldcs(src + i);
}

// Adds the values of words [0, len) of a row-major [*, C] span p (16-byte
// aligned) into the thread's acc, and sets unset where a word is not
// published yet: thread t takes words [2t, 2t + 2) of every `stride`
// words, so acc[k] holds column (2t + k) % C.
__device__ __forceinline__ void add_words(float acc[2], bool& unset, const Word* p,
                                          long long len, int stride) {
  const long long first = 2LL * threadIdx.x;
  if (first >= stride) return;
  for (long long base = 0; base < len; base += (long long)stride * kCarryLoads) {
    Word w[kCarryLoads][2];
#pragma unroll
    for (int u = 0; u < kCarryLoads; ++u) {
      const long long off = base + (long long)u * stride + first;
      if (off + 2 <= len) {
        load_words(p + off, w[u][0], w[u][1]);
      } else {
        w[u][0] = off < len ? load_word(p + off) : publish_word(0.0f);
        w[u][1] = publish_word(0.0f);
      }
    }
#pragma unroll
    for (int u = 0; u < kCarryLoads; ++u) {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        unset |= (w[u][k] >> 32) == 0;
        acc[k] += __uint_as_float((unsigned)w[u][k]);
      }
    }
  }
}

// The CTA's per-thread acc -> column sums in out[C], in a fixed order.
// lanes [2 * threads] and part [runs, C] are shared scratch.
__device__ __forceinline__ void column_sums(const float acc[2], float* lanes, float* part,
                                            float* out, int cols, int runs, int stride) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int k = 0; k < 2; ++k) lanes[2 * tid + k] = acc[k];
  __syncthreads();
  const int c = tid % cols;
  const int j = tid / cols;
  if (j < runs) {
    float v = 0.0f;
    for (int e = c + j * cols; e < stride; e += runs * cols) v += lanes[e];
    part[tid] = v;
  }
  __syncthreads();
  if (tid < cols) {
    float v = 0.0f;
    for (int jj = 0; jj < runs; ++jj) v += part[jj * cols + tid];
    out[tid] = v;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kScanThreads)
k3_scan(const float* __restrict__ x, float* __restrict__ out, ScanScratch sc,
        long long num_rows, long long num_tiles, int cols, int tile_rows, int run_rows,
        int runs, int group, int stride, int vec) {
  extern __shared__ float4 smem4[];
  const int buf_floats = tile_rows * cols;   // a multiple of 4
  float* bufs = reinterpret_cast<float*>(smem4);         // [2, buf_floats]
  float* run_off = bufs + 2 * buf_floats;                // [runs, C]: totals, then offsets
  float* part = run_off + runs * cols;                   // [runs, C]: column_sums scratch
  float* col_tot = part + runs * cols;                   // [C] tile aggregate
  float* gsum = col_tot + cols;                          // [C] a group's sum
  float* carry = gsum + cols;                            // [C] sum of all earlier tiles
  float* lanes = carry + cols;                           // [2 * threads] column_sums scratch
  __shared__ unsigned tile_ids[2];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int c = tid % cols;
  const int j = tid / cols;
  const bool walker = j < runs;

  if (tid == 0) tile_ids[0] = atomicAdd(sc.counter, 1u);
  __syncthreads();
  long long tile = tile_ids[0];
  if (tile < num_tiles) stage_tile(bufs, x, tile, num_rows, cols, tile_rows, vec);
  for (int b = 0; tile < num_tiles; b ^= 1) {
    // 1. take the next tile id and start staging it; wait for this one
    if (tid == 0) tile_ids[b ^ 1] = atomicAdd(sc.counter, 1u);
    __syncthreads();
    const long long next = tile_ids[b ^ 1];
    if (next < num_tiles) {
      stage_tile(bufs + (b ^ 1) * buf_floats, x, next, num_rows, cols, tile_rows, vec);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      cp_async_wait_all();
    }
    __syncthreads();
    float* tile_s = bufs + b * buf_floats;
    K3_STAMP(0);   // staged
    const long long r0 = tile * tile_rows;
    const int rows = (int)min((long long)tile_rows, num_rows - r0);
    const int n = rows * cols;

    // 2. thread (j, c) sums its run of column c
    const int lo = walker ? min(j * run_rows, rows) : 0;
    const int hi = walker ? min(lo + run_rows, rows) : 0;
    float sum = 0.0f;
#pragma unroll 8
    for (int r = lo; r < hi; ++r) sum += tile_s[r * cols + c];
    if (walker) run_off[tid] = sum;
    __syncthreads();

    // 3. per column, the run totals -> exclusive run offsets and the tile total
    for (int cc = warp; cc < cols; cc += kScanWarps) {
      float total = 0.0f;
      for (int k0 = 0; k0 < runs; k0 += 32) {
        const int jj = k0 + lane;
        const float v = jj < runs ? run_off[jj * cols + cc] : 0.0f;
        const float inc = warp_inclusive_scan(v, lane);
        const float before = __shfl_up_sync(kFullMask, inc, 1);
        if (jj < runs) run_off[jj * cols + cc] = total + (lane == 0 ? 0.0f : before);
        total += __shfl_sync(kFullMask, inc, 31);
      }
      if (lane == 0) col_tot[cc] = total;
    }
    __syncthreads();

    K3_STAMP(1);   // scanned locally
    // 4. publish the aggregate; the last tile of a group also its group's sum
    if (tid < cols) store_word(sc.agg + tile * cols + tid, publish_word(col_tot[tid]));
    const long long g = tile / group;
    const long long g0 = g * group;
    float acc[2];
    bool unset;
    if (tile == g0 + group - 1) {
      do {
        acc[0] = acc[1] = 0.0f;
        unset = false;
        add_words(acc, unset, sc.agg + g0 * cols, (long long)group * cols, stride);
      } while (__syncthreads_or(unset));
      column_sums(acc, lanes, part, gsum, cols, runs, stride);
      if (tid < cols) store_word(sc.group_sum + g * cols + tid, publish_word(gsum[tid]));
    }

    // 5. the carry: the sums of the groups before this one and of the tiles
    // before this one in its group, in a fixed order, once all are published
    do {
      acc[0] = acc[1] = 0.0f;
      unset = false;
      add_words(acc, unset, sc.group_sum, g * cols, stride);
      add_words(acc, unset, sc.agg + g0 * cols, (tile - g0) * cols, stride);
    } while (__syncthreads_or(unset));
    K3_STAMP(2);   // published, and every needed word seen
    column_sums(acc, lanes, part, carry, cols, runs, stride);

    K3_STAMP(3);   // carry summed
    // 6. rescan each run in shared memory from its offset
    if (walker) {
      float run = carry[c] + run_off[tid];
#pragma unroll 8
      for (int r = lo; r < hi; ++r) {
        run += tile_s[r * cols + c];
        tile_s[r * cols + c] = run;
      }
    }
    __syncthreads();

    // 7. store the tile; the barrier at the top of the next iteration keeps
    // this buffer from being restaged before every thread has read it
    float* dst = out + r0 * cols;
    int head = 0;
    if (vec) {
      float4* d4 = reinterpret_cast<float4*>(dst);
      const float4* t4 = reinterpret_cast<const float4*>(tile_s);
      for (int i = tid; i < n / 4; i += kScanThreads) __stcs(d4 + i, t4[i]);
      head = n / 4 * 4;
    }
    for (int i = head + tid; i < n; i += kScanThreads) __stcs(dst + i, tile_s[i]);
    K3_STAMP(4);   // stores issued
    tile = next;
  }
}

}  // namespace geosplat

using namespace geosplat;

extern "C" {

// Scratch floats the caller allocates for k3_cumsum_rows.
long long k3_scratch_floats(long long num_rows, int cols) {
  if (num_rows <= 0 || cols <= 0 || cols > kScanThreads) return -1;
  return scratch_bytes(scan_shape(num_rows, cols), cols) / (long long)sizeof(float);
}

int k3_cumsum_rows(const float* x, float* out, float* scratch, long long num_rows,
                   int cols, void* stream) {
  if (num_rows <= 0 || cols <= 0 || cols > kScanThreads) return (int)cudaErrorInvalidValue;
  const ScanShape s = scan_shape(num_rows, cols);
  if (s.num_tiles > 0xffffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const ScanScratch sc = scratch_layout(scratch, s, cols);
  cudaError_t err = cudaFuncSetAttribute(k3_scan, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)s.smem_bytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(scratch, 0, scratch_bytes(s, cols), st);
  if (err != cudaSuccess) return (int)err;
  const int vec = (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  // as many CTAs as stay resident at once, each looping over tiles in order
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k3_scan, kScanThreads,
                                                      s.smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const long long grid = s.num_tiles < resident ? s.num_tiles : resident;
  k3_scan<<<(unsigned)grid, kScanThreads, s.smem_bytes, st>>>(
      x, out, sc, num_rows, s.num_tiles, cols, s.tile_rows, s.run_rows, s.runs, s.group,
      carry_stride(cols), vec);
  return (int)cudaGetLastError();
}

const char* geosplat_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
