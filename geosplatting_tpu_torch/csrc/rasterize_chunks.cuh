// The chunk work unit shared by the compositing kernels (K1 in
// rasterize_fwd.cu, K2 in rasterize_bwd.cu).
//
// Each tile's depth-sorted pairs are the contiguous range [seg_start[t],
// seg_start[t+1]). A chunk is at most kc consecutive pairs of one tile; an
// empty tile is one chunk of no pairs. The chunk list (built on the device by
// ops/rasterize_pairs.py chunk_list) gives every chunk slot its tile
// (chunk_tile, num_tiles past the real count) and every tile its first slot
// (tile_chunk_start [T+1]); one CTA owns one chunk slot and one thread one
// pixel of the tile. The transmittance a chunk starts from is the product of
// its tile's earlier chunks' per-pixel products of (1 - alpha), which K1's
// first pass saves, so the chunks of one tile run in parallel.
#pragma once

#include "common.cuh"

namespace geosplat {

constexpr int kBatch = 32;  // pair rows staged per cp.async group

__device__ __forceinline__ void pixel_center(int tile, int tw, int tsx, int tsy,
                                             float& px, float& py) {
  const int tid = threadIdx.x;
  px = (float)((tile % tw) * tsx + tid % tsx) + 0.5f;
  py = (float)((tile / tw) * tsy + tid / tsx) + 0.5f;
}

struct Chunk {
  int tile;         // num_tiles for a slot past the real chunk count
  int index;        // this chunk's slot
  int first, last;  // the slots of the tile's first and last chunk
  long long start;  // the tile's first sorted pair
  int lo, hi;       // the chunk's pairs, as ranks within the tile

  __device__ bool valid(int num_tiles) const { return tile < num_tiles; }
};

__device__ __forceinline__ Chunk chunk_at(const int* chunk_tile, const int* tile_chunk_start,
                                          const long long* seg_start, int num_tiles, int kc) {
  Chunk ch;
  ch.index = blockIdx.x;
  ch.tile = chunk_tile[ch.index];
  if (!ch.valid(num_tiles)) return ch;
  ch.first = tile_chunk_start[ch.tile];
  ch.last = tile_chunk_start[ch.tile + 1] - 1;
  ch.start = seg_start[ch.tile];
  const int count = (int)(seg_start[ch.tile + 1] - ch.start);
  ch.lo = (ch.index - ch.first) * kc;
  ch.hi = min(ch.lo + kc, count);
  return ch;
}

// Per-pixel product of the saved chunk products of slots [first, upto), in
// slot order: the transmittance before slot upto's first pair. K1 and K2
// both call this, so they agree on it bit for bit.
__device__ __forceinline__ float chunk_transmittance(const float* prod, int first, int upto) {
  const int npx = blockDim.x;
  float t = 1.0f;
  for (int c = first; c < upto; ++c) t *= prod[(long long)c * npx + threadIdx.x];
  return t;
}

// The largest v over the CTA (every thread gets it).
__device__ __forceinline__ int block_max(int v) {
  __shared__ int warp_max[kMaxWarps];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = max(v, __shfl_xor_sync(kFullMask, v, off));
  if (threadIdx.x % 32 == 0) warp_max[threadIdx.x / 32] = v;
  __syncthreads();
  int m = warp_max[0];
  for (int w = 1; w < (int)blockDim.x / 32; ++w) m = max(m, warp_max[w]);
  __syncthreads();
  return m;
}

// Walks the n packed rows at src front to back, staged in batches of kBatch
// through the double buffer rows (the next batch's copy overlaps this one's
// work). body(row, rank) runs per row and per thread until the thread's
// `done` is set; the walk ends early once every thread of the CTA is done.
template <int C, typename Body>
__device__ __forceinline__ void walk_rows(float (*rows)[kBatch * RowShape<C>::kStride],
                                          const float* src, int n, bool& done, Body&& body) {
  constexpr int S = RowShape<C>::kStride;
  const int npx = blockDim.x;
  const int nb = (n + kBatch - 1) / kBatch;
  if (nb == 0 || __syncthreads_count(done) == npx) return;
  stage_rows<C>(rows[0], src, min(kBatch, n));
  for (int b = 0; b < nb; ++b) {
    cp_async_wait_all();
    // barrier: batch b has landed, and every thread is past batch b - 1,
    // whose buffer the next copy reuses
    if (__syncthreads_count(done) == npx) return;
    if (b + 1 < nb)
      stage_rows<C>(rows[(b + 1) & 1], src + (long long)(b + 1) * kBatch * S,
                    min(kBatch, n - (b + 1) * kBatch));
    const float* buf = rows[b & 1];
    const int m = min(kBatch, n - b * kBatch);
    for (int j = 0; j < m && !done; ++j) body(buf + j * S, b * kBatch + j);
  }
}

}  // namespace geosplat
