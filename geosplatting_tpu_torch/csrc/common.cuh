// Shared constants and helpers for the hand-written Hopper kernels.
#pragma once

#include <cuda_runtime.h>

namespace geosplat {

constexpr unsigned kFullMask = 0xffffffffu;

// Rasterizer contract (geosplatting_tpu/ops/rasterize.py:40-42).
constexpr float kTransmittanceEps = 1e-4f;
constexpr float kMinAlpha = 1.0f / 255.0f;
constexpr float kMaxAlpha = 0.999f;

// Packed pair row: mu2 | conic3 (a, b, c) | opacity | depth | color C.
constexpr int kHdr = 7;
constexpr int kMaxChannels = 16;
constexpr int kMaxRow = kHdr + kMaxChannels;
constexpr int kMaxTilePixels = 256;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFullMask, v, off);
  return v;
}

// One (pair, pixel) evaluation, shared by the forward and the backward so
// both see bit-identical alphas: sigma = 0.5 (a dx^2 + c dy^2) + b dx dy,
// alpha = min(o e^-sigma, 0.999), kept iff sigma >= 0 and alpha >= 1/255.
struct PairPixel {
  float dx, dy, sigma, alpha_raw;
  bool keep;
};

__device__ __forceinline__ PairPixel eval_pair(const float* p, float px, float py) {
  PairPixel r;
  r.dx = p[0] - px;
  r.dy = p[1] - py;
  r.sigma = 0.5f * (p[2] * r.dx * r.dx + p[4] * r.dy * r.dy) + p[3] * r.dx * r.dy;
  r.alpha_raw = fminf(p[5] * expf(-r.sigma), kMaxAlpha);
  r.keep = (r.sigma >= 0.0f) && (r.alpha_raw >= kMinAlpha);
  return r;
}

}  // namespace geosplat
