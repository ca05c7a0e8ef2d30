// K2: the backward of K1's compositing, in chunks that run in parallel.
//
// Replaces geosplatting_tpu/ops/rasterize_pairs.py:_bwd_kernel, which walked
// a tile's chunks back to front on a sequential grid, carried the suffix sum
// of w * s in VMEM and skipped chunks behind every pixel's contributor count
// (dead_r). Here the chunks of a tile (rasterize_chunks.cuh) are independent
// CTAs in two passes:
//   1. k2_chunk_suffix: each chunk's per-pixel S_c = sum of w * s over its
//      rank-live pairs, from the transmittance K1's saved chunk products give
//      at its start (a tile's first chunk writes 0: no chunk reads it);
//   2. k2_composite_bwd: each chunk takes suffix_after as the sum of its
//      tile's later chunks' S, the transmittance at its end from K1 (t_final
//      in the chunk that holds the pixel's last contributor, else the product
//      of the saved chunk products), and walks its live pairs back to front.
//      A chunk behind every pixel's contributor count writes zero rows and
//      exits, like the TPU kernel's dead-chunk exit.
// Each pair's gradient row is written by exactly one CTA, in sorted order and
// without atomics; the per-Gaussian reduction stays with K3
// (contiguous_segment_sum), as on the TPU.
//
// Bound on the H100: FP32 operations per walked (pair, pixel) for the
// evaluation, and per kept (pair, pixel) for the rest. Only the lanes whose
// pair is live and kept do the gradient arithmetic, and a warp sums a pair's
// 7 + C per-pixel terms only if one of its lanes is such a lane, with a
// transposing butterfly (about 16 shuffles for 16 terms, instead of 5 each).
// e^-sigma comes from eval_pair, and one reciprocal of (1 - alpha) serves
// the transmittance rebuild and d_alpha.
#include "rasterize_chunks.cuh"

namespace geosplat {

__host__ __device__ constexpr int pow2_at_least(int n) {
  return n <= 1 ? 1 : 2 * pow2_at_least((n + 1) / 2);
}
__host__ __device__ constexpr int log2_of(int n) { return n <= 1 ? 0 : 1 + log2_of(n / 2); }

// One step of the transposing butterfly: lanes whose bit OFF is set keep the
// upper HALF of v and send the lower half to their partner, which keeps the
// lower half; each adds what it receives. After log2(N) steps each lane
// holds one term summed over N lanes; a plain butterfly over the remaining
// lane bits finishes the sum over the warp.
template <int HALF, int OFF>
__device__ __forceinline__ void transpose_step(float* v, int lane) {
  if constexpr (HALF >= 1) {
    const bool upper = (lane & OFF) != 0;
#pragma unroll
    for (int i = 0; i < HALF; ++i) {
      const float send = upper ? v[i] : v[i + HALF];
      const float keep = upper ? v[i + HALF] : v[i];
      v[i] = keep + __shfl_xor_sync(kFullMask, send, OFF);
    }
    transpose_step<HALF / 2, OFF / 2>(v, lane);
  }
}

// Sums each of the N (a power of two <= 32) terms v over the warp. Returns,
// in lane l, the sum of term l >> (5 - log2 N) (N - 1 + 5 - log2 N shuffles).
template <int N>
__device__ __forceinline__ float transpose_reduce(float* v, int lane) {
  static_assert(N >= 1 && N <= 32 && (N & (N - 1)) == 0, "N: a power of two <= 32");
  transpose_step<N / 2, 16>(v, lane);
  float r = v[0];
#pragma unroll
  for (int off = 16 >> log2_of(N); off > 0; off >>= 1) r += __shfl_xor_sync(kFullMask, r, off);
  return r;
}

struct TileGrads {
  float depth, alpha;
};

template <int C>
__device__ __forceinline__ TileGrads load_grads(const float* grad_out, int tile, float* g) {
  const int npx = blockDim.x;
  const long long base = (long long)tile * (C + 2) * npx + threadIdx.x;
#pragma unroll
  for (int c = 0; c < C; ++c) g[c] = grad_out[base + (long long)c * npx];
  return {grad_out[base + (long long)C * npx], grad_out[base + (long long)(C + 1) * npx]};
}

// s = dL/d(w): the pixel's output gradients dotted with the pair's columns.
template <int C>
__device__ __forceinline__ float pair_s(const float* p, const float* g, TileGrads gt) {
  float s = gt.alpha + gt.depth * p[6];
#pragma unroll
  for (int c = 0; c < C; ++c) s += g[c] * p[kHdr + c];
  return s;
}

// Rank-live pairs of this chunk for this pixel: the first `live` of it.
__device__ __forceinline__ int live_in_chunk(const Chunk& ch, int count) {
  return max(min(ch.hi, count) - ch.lo, 0);
}

template <int C>
__global__ void __launch_bounds__(kMaxTilePixels)
chunk_suffix_kernel(const float* __restrict__ pairs, const long long* __restrict__ seg_start,
                    const int* __restrict__ chunk_tile,
                    const int* __restrict__ tile_chunk_start, int num_tiles, int tw, int tsx,
                    int tsy, int kc, const float* __restrict__ prod,
                    const float* __restrict__ grad_out, const int* __restrict__ n_contrib,
                    float* __restrict__ suffix) {
  constexpr int S = RowShape<C>::kStride;
  __shared__ __align__(16) float rows[2][kBatch * S];
  const Chunk ch = chunk_at(chunk_tile, tile_chunk_start, seg_start, num_tiles, kc);
  if (!ch.valid(num_tiles)) return;
  const long long at = (long long)ch.index * blockDim.x + threadIdx.x;
  if (ch.index == ch.first) {  // only earlier chunks read a chunk's sum
    suffix[at] = 0.0f;
    return;
  }
  const int live = live_in_chunk(ch, n_contrib[(long long)ch.tile * blockDim.x + threadIdx.x]);
  const int walk = block_max(live);
  float sum = 0.0f;
  if (walk > 0) {
    float px, py;
    pixel_center(ch.tile, tw, tsx, tsy, px, py);
    float g[C];
    const TileGrads gt = load_grads<C>(grad_out, ch.tile, g);
    float T = chunk_transmittance(prod, ch.first, ch.index);
    bool done = live == 0;
    walk_rows<C>(rows, pairs + (ch.start + ch.lo) * S, walk, done, [&](const float* p, int j) {
      if (j >= live) {
        done = true;
        return;
      }
      const PairPixel e = eval_pair(p, px, py);
      if (!e.keep) return;
      sum += e.alpha_raw * T * pair_s<C>(p, g, gt);
      T *= 1.0f - e.alpha_raw;
    });
  }
  suffix[at] = sum;
}

template <int C>
__global__ void __launch_bounds__(kMaxTilePixels)
composite_bwd_kernel(const float* __restrict__ pairs, const long long* __restrict__ seg_start,
                     const int* __restrict__ chunk_tile,
                     const int* __restrict__ tile_chunk_start, int num_tiles, int tw, int tsx,
                     int tsy, int kc, const float* __restrict__ grad_out,
                     const float* __restrict__ t_final, const int* __restrict__ n_contrib,
                     const float* __restrict__ prod, const float* __restrict__ suffix,
                     float* __restrict__ d_pairs, long long max_pairs) {
  constexpr int W = RowShape<C>::kWidth;
  constexpr int S = RowShape<C>::kStride;
  constexpr int N = pow2_at_least(W);
  constexpr int kLanesPerTerm = 32 / N;
  __shared__ __align__(16) float rows[2][kBatch * S];
  __shared__ float red[kMaxWarps][kBatch][W];
  const int npx = blockDim.x;
  const int nwarps = npx / 32;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;

  // rows of pairs outside every tile (dropped or pruned) are zero
  const long long tail = seg_start[num_tiles];
  for (long long i = tail * W + (long long)blockIdx.x * npx + tid; i < max_pairs * W;
       i += (long long)gridDim.x * npx)
    d_pairs[i] = 0.0f;

  const Chunk ch = chunk_at(chunk_tile, tile_chunk_start, seg_start, num_tiles, kc);
  if (!ch.valid(num_tiles)) return;
  const long long px_at = (long long)ch.tile * npx + tid;
  const int count = n_contrib[px_at];
  const int live = live_in_chunk(ch, count);
  const int kmax = block_max(live);
  // pairs behind every pixel's last contributor get zero rows
  float* dst = d_pairs + (ch.start + ch.lo) * W;
  for (int i = kmax * W + tid; i < (ch.hi - ch.lo) * W; i += npx) dst[i] = 0.0f;
  if (kmax == 0) return;  // dead chunk

  float px, py;
  pixel_center(ch.tile, tw, tsx, tsy, px, py);
  float g[C];
  const TileGrads gt = load_grads<C>(grad_out, ch.tile, g);
  float suf = 0.0f;  // sum over later contributors of w * s
  for (int c = ch.index + 1; c <= ch.last; ++c) suf += suffix[(long long)c * npx + tid];
  float T = count <= ch.hi ? t_final[px_at] : chunk_transmittance(prod, ch.first, ch.index + 1);

  const float* src = pairs + (ch.start + ch.lo) * S;
  const int nb = (kmax + kBatch - 1) / kBatch;
  stage_rows<C>(rows[0], src + (long long)(kmax - min(kBatch, kmax)) * S, min(kBatch, kmax));
  for (int b = 0; b < nb; ++b) {
    const int hi = kmax - b * kBatch;
    const int m = min(kBatch, hi);
    const int r0 = hi - m;
    cp_async_wait_all();
    // barrier: batch b has landed, and batch b - 1's rows and sums are consumed
    __syncthreads();
    if (b + 1 < nb) {
      const int m1 = min(kBatch, r0);
      stage_rows<C>(rows[(b + 1) & 1], src + (long long)(r0 - m1) * S, m1);
    }
    const float* buf = rows[b & 1];
    for (int jj = m - 1; jj >= 0; --jj) {
      const float* p = buf + jj * S;
      float v[N];
#pragma unroll
      for (int k = 0; k < N; ++k) v[k] = 0.0f;
      bool active = false;
      if (r0 + jj < live) {
        const PairPixel e = eval_pair(p, px, py);
        if (e.keep) {  // a pair that is not kept changes nothing
          active = true;
          const float alpha = e.alpha_raw;
          const float inv = 1.0f / (1.0f - alpha);
          const float t_excl = T * inv;
          const float w = alpha * t_excl;
          const float s = pair_s<C>(p, g, gt);
          const float d_alpha = alpha < kMaxAlpha ? t_excl * s - suf * inv : 0.0f;
          suf += w * s;
          T = t_excl;
          const float d_sigma = -alpha * d_alpha;
          v[0] = d_sigma * (p[2] * e.dx + p[3] * e.dy);
          v[1] = d_sigma * (p[4] * e.dy + p[3] * e.dx);
          v[2] = 0.5f * d_sigma * e.dx * e.dx;
          v[3] = d_sigma * e.dx * e.dy;
          v[4] = 0.5f * d_sigma * e.dy * e.dy;
          v[5] = e.decay * d_alpha;
          v[6] = w * gt.depth;
#pragma unroll
          for (int c = 0; c < C; ++c) v[kHdr + c] = w * g[c];
        }
      }
      if (__any_sync(kFullMask, active)) {
        const float r = transpose_reduce<N>(v, lane);
        const int term = lane / kLanesPerTerm;
        if (lane % kLanesPerTerm == 0 && term < W) red[warp][jj][term] = r;
      } else if (lane < W) {
        red[warp][jj][lane] = 0.0f;
      }
    }
    __syncthreads();
    float* out = dst + (long long)r0 * W;
    for (int i = tid; i < m * W; i += npx) {
      const int jj = i / W;
      const int k = i - jj * W;
      float s = 0.0f;
      for (int w = 0; w < nwarps; ++w) s += red[w][jj][k];
      if (k == 5 && !(buf[jj * S + 5] > 0.0f)) s = 0.0f;  // d_opacity iff opacity > 0
      out[i] = s;
    }
  }
}

static bool bad_shape(int num_tiles, int num_slots, int tsx, int tsy, int kc) {
  const int npx = tsx * tsy;
  return num_tiles <= 0 || num_slots < num_tiles || npx <= 0 || npx > kMaxTilePixels ||
         npx % 32 != 0 || kc <= 0;
}

}  // namespace geosplat

using namespace geosplat;

extern "C" {

int k2_chunk_suffix(const float* pairs, const long long* seg_start, const int* chunk_tile,
                    const int* tile_chunk_start, int num_tiles, int num_slots, int tw, int tsx,
                    int tsy, int channels, int kc, const float* prod, const float* grad_out,
                    const int* n_contrib, float* suffix, void* stream) {
  if (bad_shape(num_tiles, num_slots, tsx, tsy, kc)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool ok = with_channels(channels, [&](auto c) {
    chunk_suffix_kernel<decltype(c)::value><<<num_slots, tsx * tsy, 0, st>>>(
        pairs, seg_start, chunk_tile, tile_chunk_start, num_tiles, tw, tsx, tsy, kc, prod,
        grad_out, n_contrib, suffix);
  });
  return ok ? (int)cudaGetLastError() : (int)cudaErrorInvalidValue;
}

int k2_composite_bwd(const float* pairs, const long long* seg_start, const int* chunk_tile,
                     const int* tile_chunk_start, int num_tiles, int num_slots, int tw, int tsx,
                     int tsy, int channels, int kc, const float* grad_out, const float* t_final,
                     const int* n_contrib, const float* prod, const float* suffix,
                     float* d_pairs, long long max_pairs, void* stream) {
  if (bad_shape(num_tiles, num_slots, tsx, tsy, kc)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool ok = with_channels(channels, [&](auto c) {
    composite_bwd_kernel<decltype(c)::value><<<num_slots, tsx * tsy, 0, st>>>(
        pairs, seg_start, chunk_tile, tile_chunk_start, num_tiles, tw, tsx, tsy, kc, grad_out,
        t_final, n_contrib, prod, suffix, d_pairs, max_pairs);
  });
  return ok ? (int)cudaGetLastError() : (int)cudaErrorInvalidValue;
}

}  // extern "C"
