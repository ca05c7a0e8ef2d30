// Shared constants and helpers for the hand-written Hopper kernels.
#pragma once

#include <cuda_runtime.h>

#include <type_traits>

namespace geosplat {

constexpr unsigned kFullMask = 0xffffffffu;

// Rasterizer contract (geosplatting_tpu/ops/rasterize.py:40-42).
constexpr float kTransmittanceEps = 1e-4f;
constexpr float kMinAlpha = 1.0f / 255.0f;
constexpr float kMaxAlpha = 0.999f;

// Packed pair row: mu2 | conic3 (a, b, c) | opacity | depth | color C, padded
// with zeros to a stride of a multiple of 4 floats so rows stage in 16-byte
// copies (ops/rasterize_pairs.py row_stride).
constexpr int kHdr = 7;
constexpr int kMaxChannels = 16;
constexpr int kMaxTilePixels = 256;
constexpr int kMaxWarps = kMaxTilePixels / 32;

template <int C>
struct RowShape {
  static constexpr int kWidth = kHdr + C;                // floats a gradient row holds
  static constexpr int kStride = (kWidth + 3) / 4 * 4;   // floats a packed pair row holds
  static constexpr int kVecs = kStride / 4;              // 16-byte copies per pair row
};

// Calls f(std::integral_constant<int, C>{}) for a runtime C in 1..kMaxChannels,
// so every per-channel loop is unrolled at compile time. Returns false for
// any other C.
template <typename F>
bool with_channels(int c, F&& f) {
  switch (c) {
#define GEOSPLAT_CASE(n) \
  case n:                \
    f(std::integral_constant<int, n>{}); \
    return true;
    GEOSPLAT_CASE(1) GEOSPLAT_CASE(2) GEOSPLAT_CASE(3) GEOSPLAT_CASE(4)
    GEOSPLAT_CASE(5) GEOSPLAT_CASE(6) GEOSPLAT_CASE(7) GEOSPLAT_CASE(8)
    GEOSPLAT_CASE(9) GEOSPLAT_CASE(10) GEOSPLAT_CASE(11) GEOSPLAT_CASE(12)
    GEOSPLAT_CASE(13) GEOSPLAT_CASE(14) GEOSPLAT_CASE(15) GEOSPLAT_CASE(16)
#undef GEOSPLAT_CASE
    default:
      return false;
  }
}

// One (pair, pixel) evaluation, shared by the forward and the backward so
// both see bit-identical alphas: sigma = 0.5 (a dx^2 + c dy^2) + b dx dy,
// alpha = min(o e^-sigma, 0.999), kept iff sigma >= 0 and alpha >= 1/255.
// sigma is rounded after every operation, in the plain versions' order (no
// fused multiply-adds), so the kernels and the plain versions on the card
// keep the same pairs at the 1/255 cutoff. e^-sigma is kept for the
// backward's d(opacity).
struct PairPixel {
  float dx, dy, sigma, decay, alpha_raw;
  bool keep;
};

__device__ __forceinline__ PairPixel eval_pair(const float* p, float px, float py) {
  PairPixel r;
  r.dx = p[0] - px;
  r.dy = p[1] - py;
  const float quad = __fadd_rn(__fmul_rn(__fmul_rn(p[2], r.dx), r.dx),
                               __fmul_rn(__fmul_rn(p[4], r.dy), r.dy));
  r.sigma = __fadd_rn(__fmul_rn(0.5f, quad), __fmul_rn(__fmul_rn(p[3], r.dx), r.dy));
  r.decay = expf(-r.sigma);
  r.alpha_raw = fminf(p[5] * r.decay, kMaxAlpha);
  r.keep = (r.sigma >= 0.0f) && (r.alpha_raw >= kMinAlpha);
  return r;
}

// --- asynchronous row staging (cp.async, 16 bytes a copy) ----------------------

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Starts copying n packed pair rows from src (device memory) to dst (shared
// memory) with the whole CTA; cp_async_wait_all + a barrier make them visible.
template <int C>
__device__ __forceinline__ void stage_rows(float* dst, const float* src, int n) {
  constexpr int kVecs = RowShape<C>::kVecs;
  const float4* s = reinterpret_cast<const float4*>(src);
  float4* d = reinterpret_cast<float4*>(dst);
  for (int i = threadIdx.x; i < n * kVecs; i += blockDim.x) cp_async16(d + i, s + i);
  asm volatile("cp.async.commit_group;\n" ::);
}

}  // namespace geosplat
