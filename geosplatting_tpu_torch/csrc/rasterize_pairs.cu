// K1 and K2: front-to-back alpha compositing of depth-sorted (tile, Gaussian)
// pairs, forward and backward.
//
// K1 replaces geosplatting_tpu/ops/rasterize_pairs.py:_fwd_kernel and K2
// replaces geosplatting_tpu/ops/rasterize_pairs.py:_bwd_kernel. The TPU
// kernels walked a chunk list sequentially and carried per-pixel log
// transmittance in VMEM across a tile's chunks; here one CTA owns one tile
// and one thread owns one pixel, so the carry is a register.
//
// Bound on the H100: FP32 operations and expf per live (pair, pixel). The
// pair rows a tile reads (7 + C floats each) are shared by its P pixels, so
// bytes per pair-pixel are ~(7 + C) * 4 / P, far below the ~20 FP32
// operations and one expf each pair-pixel costs. Both kernels therefore
// stage a batch of pair rows in shared memory once per CTA and keep every
// per-pixel quantity in registers; work stops at each pixel's last
// contributor (K1 exits the tile once __syncthreads_count shows every pixel
// saturated, K2 starts at the tile's largest contributor count).
//
// K2 writes one gradient row per pair in sorted order with no atomics: each
// pair's per-pixel terms are summed within a warp by shuffles and across
// warps through shared memory, and the per-Gaussian reduction stays with K3
// (contiguous_segment_sum), as on the TPU.
//
// Contract (gate order of rasterize_pairs.py:520-523): a pair contributes to
// a pixel iff the transmittance before it exceeds 1e-4; alpha is zeroed
// unless sigma >= 0 and alpha >= 1/255. K1 saves, per pixel, the
// transmittance after its last contributor and the contributor count; K2
// rebuilds T_before = T_after / (1 - alpha) walking back to front and
// gates pairs by rank against that count.
#include "common.cuh"

namespace geosplat {

constexpr int kBwdBatch = 32;
constexpr int kMaxWarps = kMaxTilePixels / 32;

__device__ __forceinline__ void pixel_center(int tile, int tw, int tsx, int tsy,
                                             float& px, float& py) {
  const int tid = threadIdx.x;
  px = (float)((tile % tw) * tsx + tid % tsx) + 0.5f;
  py = (float)((tile / tw) * tsy + tid / tsx) + 0.5f;
}

__global__ void __launch_bounds__(kMaxTilePixels)
composite_fwd_kernel(const float* __restrict__ pairs, const long long* __restrict__ seg_start,
                     int tw, int tsx, int tsy, int channels,
                     float* __restrict__ out, float* __restrict__ t_final,
                     int* __restrict__ n_contrib) {
  __shared__ float rows[kMaxTilePixels * kMaxRow];
  const int tile = blockIdx.x;
  const int npx = blockDim.x;
  const int tid = threadIdx.x;
  const int width = kHdr + channels;
  float px, py;
  pixel_center(tile, tw, tsx, tsy, px, py);
  const long long start = seg_start[tile];
  const int count = (int)(seg_start[tile + 1] - start);

  float acc[kMaxChannels];
#pragma unroll
  for (int c = 0; c < kMaxChannels; ++c) acc[c] = 0.0f;
  float acc_depth = 0.0f, acc_alpha = 0.0f;
  float T = 1.0f;
  int contrib = 0;
  bool done = false;

  for (int b = 0; b < count; b += npx) {
    // barrier: every pixel saturated ends the tile, and the previous batch's
    // rows are no longer read
    if (__syncthreads_count(done) == npx) break;
    const int nb = min(npx, count - b);
    const float* src = pairs + (start + b) * width;
    for (int i = tid; i < nb * width; i += npx) rows[i] = src[i];
    __syncthreads();
    if (done) continue;
    for (int j = 0; j < nb; ++j) {
      if (T <= kTransmittanceEps) {  // gate on the transmittance before the pair
        done = true;
        break;
      }
      const float* p = rows + j * width;
      const PairPixel e = eval_pair(p, px, py);
      const float alpha = e.keep ? e.alpha_raw : 0.0f;
      const float w = alpha * T;
#pragma unroll
      for (int c = 0; c < kMaxChannels; ++c)
        if (c < channels) acc[c] += w * p[kHdr + c];
      acc_depth += w * p[6];
      acc_alpha += w;
      T *= 1.0f - alpha;
      ++contrib;
    }
  }

  const long long base = (long long)tile * (channels + 2) * npx + tid;
#pragma unroll
  for (int c = 0; c < kMaxChannels; ++c)
    if (c < channels) out[base + (long long)c * npx] = acc[c];
  out[base + (long long)channels * npx] = acc_depth;
  out[base + (long long)(channels + 1) * npx] = acc_alpha;
  t_final[(long long)tile * npx + tid] = T;
  n_contrib[(long long)tile * npx + tid] = contrib;
}

__global__ void __launch_bounds__(kMaxTilePixels)
composite_bwd_kernel(const float* __restrict__ pairs, const long long* __restrict__ seg_start,
                     int num_tiles, int tw, int tsx, int tsy, int channels,
                     const float* __restrict__ grad_out, const float* __restrict__ t_final,
                     const int* __restrict__ n_contrib, float* __restrict__ d_pairs,
                     long long max_pairs) {
  __shared__ float rows[kBwdBatch * kMaxRow];
  __shared__ float red[kMaxWarps][kBwdBatch][kMaxRow];
  __shared__ int warp_max[kMaxWarps];
  const int tile = blockIdx.x;
  const int npx = blockDim.x;
  const int nwarps = npx / 32;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int width = kHdr + channels;
  float px, py;
  pixel_center(tile, tw, tsx, tsy, px, py);
  const long long start = seg_start[tile];
  const int count = (int)(seg_start[tile + 1] - start);

  const int my_count = n_contrib[(long long)tile * npx + tid];
  float T = t_final[(long long)tile * npx + tid];
  const long long gbase = (long long)tile * (channels + 2) * npx + tid;
  float g[kMaxChannels];
#pragma unroll
  for (int c = 0; c < kMaxChannels; ++c)
    g[c] = c < channels ? grad_out[gbase + (long long)c * npx] : 0.0f;
  const float g_depth = grad_out[gbase + (long long)channels * npx];
  const float g_alpha = grad_out[gbase + (long long)(channels + 1) * npx];

  // the tile's largest contributor count: pairs behind it get zero rows
  int m = my_count;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = max(m, __shfl_xor_sync(kFullMask, m, off));
  if (lane == 0) warp_max[warp] = m;
  __syncthreads();
  int kmax = 0;
  for (int w = 0; w < nwarps; ++w) kmax = max(kmax, warp_max[w]);
  for (long long i = (start + kmax) * width + tid; i < (start + count) * width; i += npx)
    d_pairs[i] = 0.0f;

  float suffix = 0.0f;  // sum over later contributors of w * s
  for (int hi = kmax; hi > 0; hi -= kBwdBatch) {
    const int lo = max(hi - kBwdBatch, 0);
    const int nb = hi - lo;
    __syncthreads();  // the previous batch's rows and partial sums are consumed
    const float* src = pairs + (start + lo) * width;
    for (int i = tid; i < nb * width; i += npx) rows[i] = src[i];
    __syncthreads();
    for (int jj = nb - 1; jj >= 0; --jj) {
      const float* p = rows + jj * width;
      const bool live = lo + jj < my_count;
      float v[kMaxRow];
#pragma unroll
      for (int k = 0; k < kMaxRow; ++k) v[k] = 0.0f;
      if (live) {
        const PairPixel e = eval_pair(p, px, py);
        const float alpha = e.keep ? e.alpha_raw : 0.0f;
        const float one_minus = 1.0f - alpha;
        const float t_excl = T / one_minus;
        const float w = alpha * t_excl;
        float s = g_alpha + g_depth * p[6];
#pragma unroll
        for (int c = 0; c < kMaxChannels; ++c)
          if (c < channels) s += g[c] * p[kHdr + c];
        float d_alpha = t_excl * s - suffix / fmaxf(one_minus, 1e-6f);
        if (!e.keep || e.alpha_raw >= kMaxAlpha) d_alpha = 0.0f;
        suffix += w * s;
        T = t_excl;
        const float d_sigma = -alpha * d_alpha;
        v[0] = d_sigma * (p[2] * e.dx + p[3] * e.dy);
        v[1] = d_sigma * (p[4] * e.dy + p[3] * e.dx);
        v[2] = 0.5f * d_sigma * e.dx * e.dx;
        v[3] = d_sigma * e.dx * e.dy;
        v[4] = 0.5f * d_sigma * e.dy * e.dy;
        v[5] = e.keep ? expf(-e.sigma) * d_alpha : 0.0f;
        v[6] = w * g_depth;
#pragma unroll
        for (int c = 0; c < kMaxChannels; ++c)
          if (c < channels) v[kHdr + c] = w * g[c];
      }
      if (__any_sync(kFullMask, live)) {
#pragma unroll
        for (int k = 0; k < kMaxRow; ++k) {
          if (k < width) {
            const float r = warp_sum(v[k]);
            if (lane == 0) red[warp][jj][k] = r;
          }
        }
      } else if (lane == 0) {
        for (int k = 0; k < width; ++k) red[warp][jj][k] = 0.0f;
      }
    }
    __syncthreads();
    float* dst = d_pairs + (start + lo) * width;
    for (int i = tid; i < nb * width; i += npx) {
      const int jj = i / width;
      const int k = i - jj * width;
      float s = 0.0f;
      for (int w = 0; w < nwarps; ++w) s += red[w][jj][k];
      if (k == 5 && !(rows[jj * width + 5] > 0.0f)) s = 0.0f;  // d_opacity iff opacity > 0
      dst[i] = s;
    }
  }

  // rows of pairs outside every tile (dropped or pruned) are zero
  const long long tail = seg_start[num_tiles];
  for (long long i = tail * width + (long long)blockIdx.x * npx + tid; i < max_pairs * width;
       i += (long long)gridDim.x * npx)
    d_pairs[i] = 0.0f;
}

static bool bad_shape(int num_tiles, int tsx, int tsy, int channels) {
  const int npx = tsx * tsy;
  return num_tiles <= 0 || npx <= 0 || npx > kMaxTilePixels || npx % 32 != 0 ||
         channels <= 0 || channels > kMaxChannels;
}

}  // namespace geosplat

using namespace geosplat;

extern "C" {

int k1_composite_fwd(const float* pairs, const long long* seg_start, int num_tiles, int tw,
                     int tsx, int tsy, int channels, float* out, float* t_final,
                     int* n_contrib, void* stream) {
  if (bad_shape(num_tiles, tsx, tsy, channels)) return (int)cudaErrorInvalidValue;
  composite_fwd_kernel<<<num_tiles, tsx * tsy, 0, static_cast<cudaStream_t>(stream)>>>(
      pairs, seg_start, tw, tsx, tsy, channels, out, t_final, n_contrib);
  return (int)cudaGetLastError();
}

int k2_composite_bwd(const float* pairs, const long long* seg_start, int num_tiles, int tw,
                     int tsx, int tsy, int channels, const float* grad_out,
                     const float* t_final, const int* n_contrib, float* d_pairs,
                     long long max_pairs, void* stream) {
  if (bad_shape(num_tiles, tsx, tsy, channels)) return (int)cudaErrorInvalidValue;
  composite_bwd_kernel<<<num_tiles, tsx * tsy, 0, static_cast<cudaStream_t>(stream)>>>(
      pairs, seg_start, num_tiles, tw, tsx, tsy, channels, grad_out, t_final, n_contrib,
      d_pairs, max_pairs);
  return (int)cudaGetLastError();
}

}  // extern "C"
