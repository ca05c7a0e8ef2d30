// K1: front-to-back alpha compositing of depth-sorted (tile, Gaussian) pairs,
// in chunks that run in parallel.
//
// Replaces geosplatting_tpu/ops/rasterize_pairs.py:_fwd_kernel. The TPU
// kernel walked a tile's chunks on a sequential grid and carried the
// per-pixel log transmittance across them in VMEM. Here the chunks of a tile
// (rasterize_chunks.cuh) run as independent CTAs in two passes:
//   1. k1_chunk_products: each chunk's per-pixel product of (1 - alpha) over
//      its pairs (evaluation only, no gate), saved as [chunk slots, P];
//   2. k1_composite_fwd: each chunk starts from the product of its tile's
//      earlier chunks' products, exits at once where that is <= 1e-4, and
//      otherwise walks its pairs with the contract's gate; a tile's only
//      chunk writes the tile's outputs, and the chunks of a tile with
//      several write partial sums that a second kernel of the same call
//      combines per tile in chunk order (no float atomics, so the outputs
//      are the same bit for bit from run to run).
//
// Bound on the H100: FP32 operations and one expf per walked (pair, pixel).
// A chunk's pair rows (a multiple of 16 bytes each) are shared by its P
// pixels, so they are staged in shared memory with cp.async, double
// buffered, and every per-pixel quantity stays in registers; the channel
// count is a template parameter, so the per-channel loops are unrolled.
//
// Contract (gate order of rasterize_pairs.py:520-523): a pair contributes to
// a pixel iff the transmittance before it exceeds 1e-4; alpha is zeroed
// unless sigma >= 0 and alpha >= 1/255. K1 saves, per pixel, the
// transmittance after its last contributor and the contributor count, which
// counts a prefix of the tile's pairs: the combine stops at the first chunk
// that a pixel did not walk to its end.
#include "rasterize_chunks.cuh"

namespace geosplat {

template <int C>
__global__ void __launch_bounds__(kMaxTilePixels)
chunk_products_kernel(const float* __restrict__ pairs, const long long* __restrict__ seg_start,
                      const int* __restrict__ chunk_tile,
                      const int* __restrict__ tile_chunk_start, int num_tiles, int tw, int tsx,
                      int tsy, int kc, float* __restrict__ prod) {
  constexpr int S = RowShape<C>::kStride;
  __shared__ __align__(16) float rows[2][kBatch * S];
  const Chunk ch = chunk_at(chunk_tile, tile_chunk_start, seg_start, num_tiles, kc);
  if (!ch.valid(num_tiles)) return;
  float px, py;
  pixel_center(ch.tile, tw, tsx, tsy, px, py);
  float trans = 1.0f;
  bool done = false;
  walk_rows<C>(rows, pairs + (ch.start + ch.lo) * S, ch.hi - ch.lo, done,
               [&](const float* p, int) {
                 const PairPixel e = eval_pair(p, px, py);
                 if (e.keep) trans *= 1.0f - e.alpha_raw;
               });
  prod[(long long)ch.index * blockDim.x + threadIdx.x] = trans;
}

template <int C>
__global__ void __launch_bounds__(kMaxTilePixels)
composite_fwd_kernel(const float* __restrict__ pairs, const long long* __restrict__ seg_start,
                     const int* __restrict__ chunk_tile,
                     const int* __restrict__ tile_chunk_start, int num_tiles, int tw, int tsx,
                     int tsy, int kc, const float* __restrict__ prod, float* __restrict__ out,
                     float* __restrict__ t_final, int* __restrict__ n_contrib,
                     float* __restrict__ part, float* __restrict__ part_t,
                     int* __restrict__ part_n) {
  constexpr int S = RowShape<C>::kStride;
  __shared__ __align__(16) float rows[2][kBatch * S];
  const Chunk ch = chunk_at(chunk_tile, tile_chunk_start, seg_start, num_tiles, kc);
  if (!ch.valid(num_tiles)) return;
  const int npx = blockDim.x;
  const int tid = threadIdx.x;
  float px, py;
  pixel_center(ch.tile, tw, tsx, tsy, px, py);

  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.0f;
  float acc_depth = 0.0f, acc_alpha = 0.0f;
  float T = chunk_transmittance(prod, ch.first, ch.index);
  int contrib = 0;
  bool done = !(T > kTransmittanceEps);  // saturated before this chunk
  walk_rows<C>(rows, pairs + (ch.start + ch.lo) * S, ch.hi - ch.lo, done,
               [&](const float* p, int) {
                 if (T <= kTransmittanceEps) {  // gate on the transmittance before the pair
                   done = true;
                   return;
                 }
                 const PairPixel e = eval_pair(p, px, py);
                 const float alpha = e.keep ? e.alpha_raw : 0.0f;
                 const float w = alpha * T;
#pragma unroll
                 for (int c = 0; c < C; ++c) acc[c] += w * p[kHdr + c];
                 acc_depth += w * p[6];
                 acc_alpha += w;
                 T *= 1.0f - alpha;
                 ++contrib;
               });

  // a tile's only chunk writes the tile's outputs; otherwise the partials
  const bool only = ch.first == ch.last;
  const long long slot = only ? ch.tile : ch.index;
  float* o = only ? out : part;
  const long long base = slot * (C + 2) * npx + tid;
#pragma unroll
  for (int c = 0; c < C; ++c) o[base + (long long)c * npx] = acc[c];
  o[base + (long long)C * npx] = acc_depth;
  o[base + (long long)(C + 1) * npx] = acc_alpha;
  (only ? t_final : part_t)[slot * npx + tid] = T;
  (only ? n_contrib : part_n)[slot * npx + tid] = contrib;
}

// One CTA per tile with several chunks: sums the partials in chunk order up
// to and including the first chunk the pixel did not walk to its end.
template <int C>
__global__ void __launch_bounds__(kMaxTilePixels)
combine_kernel(const long long* __restrict__ seg_start,
               const int* __restrict__ tile_chunk_start, int kc,
               const float* __restrict__ part, const float* __restrict__ part_t,
               const int* __restrict__ part_n, float* __restrict__ out,
               float* __restrict__ t_final, int* __restrict__ n_contrib) {
  const int tile = blockIdx.x;
  const int first = tile_chunk_start[tile];
  const int last = tile_chunk_start[tile + 1] - 1;
  if (first == last) return;
  const int npx = blockDim.x;
  const int tid = threadIdx.x;
  const int count = (int)(seg_start[tile + 1] - seg_start[tile]);
  float acc[C + 2];
#pragma unroll
  for (int k = 0; k < C + 2; ++k) acc[k] = 0.0f;
  float T = 1.0f;
  int contrib = 0;
  for (int c = first; c <= last; ++c) {
    const int n = part_n[(long long)c * npx + tid];
#pragma unroll
    for (int k = 0; k < C + 2; ++k) acc[k] += part[((long long)c * (C + 2) + k) * npx + tid];
    contrib += n;
    if (n > 0) T = part_t[(long long)c * npx + tid];
    if (n < min(kc, count - (c - first) * kc)) break;
  }
  const long long base = (long long)tile * (C + 2) * npx + tid;
#pragma unroll
  for (int k = 0; k < C + 2; ++k) out[base + (long long)k * npx] = acc[k];
  t_final[(long long)tile * npx + tid] = T;
  n_contrib[(long long)tile * npx + tid] = contrib;
}

static bool bad_shape(int num_tiles, int num_slots, int tsx, int tsy, int kc) {
  const int npx = tsx * tsy;
  return num_tiles <= 0 || num_slots < num_tiles || npx <= 0 || npx > kMaxTilePixels ||
         npx % 32 != 0 || kc <= 0;
}

}  // namespace geosplat

using namespace geosplat;

extern "C" {

int k1_chunk_products(const float* pairs, const long long* seg_start, const int* chunk_tile,
                      const int* tile_chunk_start, int num_tiles, int num_slots, int tw,
                      int tsx, int tsy, int channels, int kc, float* prod, void* stream) {
  if (bad_shape(num_tiles, num_slots, tsx, tsy, kc)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool ok = with_channels(channels, [&](auto c) {
    chunk_products_kernel<decltype(c)::value><<<num_slots, tsx * tsy, 0, st>>>(
        pairs, seg_start, chunk_tile, tile_chunk_start, num_tiles, tw, tsx, tsy, kc, prod);
  });
  return ok ? (int)cudaGetLastError() : (int)cudaErrorInvalidValue;
}

int k1_composite_fwd(const float* pairs, const long long* seg_start, const int* chunk_tile,
                     const int* tile_chunk_start, int num_tiles, int num_slots, int tw, int tsx,
                     int tsy, int channels, int kc, const float* prod, float* out,
                     float* t_final, int* n_contrib, float* part, float* part_t, int* part_n,
                     void* stream) {
  if (bad_shape(num_tiles, num_slots, tsx, tsy, kc)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int status = 0;
  const bool ok = with_channels(channels, [&](auto c) {
    constexpr int kC = decltype(c)::value;
    composite_fwd_kernel<kC><<<num_slots, tsx * tsy, 0, st>>>(
        pairs, seg_start, chunk_tile, tile_chunk_start, num_tiles, tw, tsx, tsy, kc, prod, out,
        t_final, n_contrib, part, part_t, part_n);
    status = (int)cudaGetLastError();
    if (status != 0) return;
    combine_kernel<kC><<<num_tiles, tsx * tsy, 0, st>>>(
        seg_start, tile_chunk_start, kc, part, part_t, part_n, out, t_final, n_contrib);
    status = (int)cudaGetLastError();
  });
  return ok ? status : (int)cudaErrorInvalidValue;
}

}  // extern "C"
