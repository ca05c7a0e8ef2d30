// K4: the SDF sphere trace of the shading's soft shadows, one thread a ray.
//
// Replaces no Pallas kernel: the JAX package's trace
// (geosplatting_tpu/ops/sdf_visibility.py:make_sdf_visibility) is plain jnp,
// and so was its port (ops/sdf_visibility.py:make_sdf_visibility_plain): a
// dozen elementwise passes over up to 2^23 rays and an [M, 8] row gather of
// the cell corners for each of its fixed 24 steps, every ray taking every
// step. It is the largest share of the card's time in stages 2 and 3.
//
// Bound on the H100: the corner reads. A ray reads 24 bytes and writes 4, and
// a step that changes the result costs ~88 FP32 operations (PERF.md), both far
// under a millisecond a view; each step's trilinear lookup waits on a read of
// the SDF table from L2 (device memory only where the table is past L2), and
// the next step's point depends on it.
//
// Design:
//   * One thread a ray keeps t and v in registers through the march; the
//     origin and direction are read once, v is written once, nothing else
//     touches device memory but the corner reads.
//   * Each ray stops after the step in which its result was settled: v
//     reached 0 (min(0, x >= 0) stays 0), or t did not change, which happens
//     only at t = t_max once the point at t_max has been sampled; every later
//     step samples that same point and leaves v and t as they are. So the
//     exit changes no bit of the result. The sample at t_max is kept: a
//     learnt SDF need not be positive on the grid's box.
//   * The arithmetic is the plain step's on the card, operation by
//     operation and in its order, each rounded (no contraction into fused
//     multiply-adds): p / scale is p * (1 / scale), as PyTorch divides by a
//     scalar on the card (1 / scale in double, rounded to float: measured at
//     scales 0.6-1.3), and the sums take the orders of its sum(-1) there,
//     ((c0 + c4) + (c2 + c6)) + ((c1 + c5) + (c3 + c7)) for the 8 corner terms
//     and (x + z) + y for the box distance's squares (each measured bit-equal
//     on 2^20 rows). So K4 gives the plain march's bits, and the same live
//     steps. Minima and clamps pass NaN on as torch.minimum and torch.clamp.
//   * The corners come from the packed cell rows [R^3, 8] (_pack_cells), one
//     32-byte row a step in two 16-byte loads. Measured against the flat
//     vertex grid [(R+1)^3] (eight loads from four places a step; 3.6 MB at
//     R = 96 against 28 MB packed): 0.98 against 2.13 ms at R = 96 and 0.98
//     against 2.25 ms at R = 128, where the packed table (67 MB) is past L2
//     (2^23 rays, 24 steps; NVIDIA H100 80GB HBM3, 700 W). So one layout
//     serves every grid.
//   * Counting, when the caller passes counts: a ray's live steps (steps that
//     start with t < t_max and v > 0) and, per warp, its lanes holding a ray
//     times the steps of its longest ray, each warp-reduced and added with one
//     atomicAdd a warp.
#include "common.cuh"

#include <cstdint>

namespace geosplat {

constexpr int kTraceThreads = 256;

struct TraceParams {
  int rx, ry, rz;
  float res_x, res_y, res_z;
  float inv_scale;   // 1 / scale as the card's plain p / scale rounds it
  float scale;
  float t_start, t_max, min_step, softness;
  int num_steps;
};

// torch.minimum / torch.maximum: a NaN operand is the result
__device__ __forceinline__ float nan_min(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

__device__ __forceinline__ float clamp01(float x) { return nan_min(nan_max(x, 0.0f), 1.0f); }

// The grid coordinate of one axis, floor(g) clamped to the cells, and the
// fraction g - floor(g) of the unclamped cell.
__device__ __forceinline__ void axis(float p, float inv_scale, float res, int r, int& cell,
                                     float& frac) {
  const float g = __fmul_rn(__fadd_rn(__fmul_rn(__fmul_rn(p, inv_scale), 0.5f), 0.5f), res);
  const float fl = floorf(g);
  frac = __fsub_rn(g, fl);
  // fmaxf takes 0 for a NaN g: any cell will do, the fraction is NaN
  cell = (int)fminf(fmaxf(fl, 0.0f), (float)(r - 1));
}

// The trilinear SDF at p plus the distance to the grid's box (sample_packed):
// cells holds each cell's 8 corners, corner (dz * 2 + dy) * 2 + dx.
__device__ __forceinline__ float sample_sdf(const float* __restrict__ cells, const TraceParams& q,
                                            float px, float py, float pz) {
  int x0, y0, z0;
  float fx, fy, fz;
  axis(px, q.inv_scale, q.res_x, q.rx, x0, fx);
  axis(py, q.inv_scale, q.res_y, q.ry, y0, fy);
  axis(pz, q.inv_scale, q.res_z, q.rz, z0, fz);
  const float4* row =
      reinterpret_cast<const float4*>(cells + 8LL * ((z0 * q.ry + y0) * q.rx + x0));
  const float4 a = __ldg(row), b = __ldg(row + 1);
  const float c[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  const float wx[2] = {__fsub_rn(1.0f, fx), fx};
  const float wy[2] = {__fsub_rn(1.0f, fy), fy};
  const float wz[2] = {__fsub_rn(1.0f, fz), fz};
  float pr[8];
#pragma unroll
  for (int k = 0; k < 8; ++k)
    pr[k] = __fmul_rn(c[k], __fmul_rn(__fmul_rn(wz[k >> 2], wy[(k >> 1) & 1]), wx[k & 1]));
  const float vals = __fadd_rn(__fadd_rn(__fadd_rn(pr[0], pr[4]), __fadd_rn(pr[2], pr[6])),
                               __fadd_rn(__fadd_rn(pr[1], pr[5]), __fadd_rn(pr[3], pr[7])));
  const float ox = nan_max(__fsub_rn(fabsf(px), q.scale), 0.0f);
  const float oy = nan_max(__fsub_rn(fabsf(py), q.scale), 0.0f);
  const float oz = nan_max(__fsub_rn(fabsf(pz), q.scale), 0.0f);
  const float sq = __fadd_rn(__fadd_rn(__fmul_rn(ox, ox), __fmul_rn(oz, oz)), __fmul_rn(oy, oy));
  const float d_box = __fsqrt_rn(__fadd_rn(sq, static_cast<float>(1e-12)));
  return d_box > 0.0f ? __fadd_rn(vals, d_box) : vals;
}

__global__ void __launch_bounds__(kTraceThreads)
sdf_trace_kernel(const float* __restrict__ origins, const float* __restrict__ dirs,
                 const float* __restrict__ cells, float* __restrict__ out, long long num_rays,
                 TraceParams q, unsigned long long* __restrict__ counts) {
  const long long i = (long long)blockIdx.x * kTraceThreads + threadIdx.x;
  const bool has = i < num_rays;
  int steps = 0, live = 0;
  if (has) {
    const float ox = origins[3 * i], oy = origins[3 * i + 1], oz = origins[3 * i + 2];
    const float dx = dirs[3 * i], dy = dirs[3 * i + 1], dz = dirs[3 * i + 2];
    float t = q.t_start, v = 1.0f;
    while (steps < q.num_steps) {
      // t <= t_max and v >= 0: the minimum is 0 once the ray is settled
      live += nan_min(__fsub_rn(q.t_max, t), v) != 0.0f;
      const float d = sample_sdf(cells, q, __fadd_rn(ox, __fmul_rn(dx, t)),
                                 __fadd_rn(oy, __fmul_rn(dy, t)), __fadd_rn(oz, __fmul_rn(dz, t)));
      const float term =
          clamp01(__fdiv_rn(__fmul_rn(d, q.softness), nan_max(t, static_cast<float>(1e-4))));
      const float v1 = nan_min(v, term);
      const float t1 = nan_min(__fadd_rn(t, nan_max(d, q.min_step)), q.t_max);
      ++steps;
      const bool settled = v1 == 0.0f || t1 == t;
      v = v1;
      t = t1;
      if (settled) break;
    }
    out[i] = clamp01(v);
  }
  if (counts != nullptr) {
    const unsigned lanes = __ballot_sync(kFullMask, has);
    const unsigned longest = __reduce_max_sync(kFullMask, (unsigned)steps);
    const unsigned live_sum = __reduce_add_sync(kFullMask, (unsigned)live);
    if ((threadIdx.x & 31) == 0 && lanes != 0) {
      atomicAdd(counts, (unsigned long long)live_sum);
      atomicAdd(counts + 1, (unsigned long long)__popc(lanes) * longest);
    }
  }
}

}  // namespace geosplat

using namespace geosplat;

extern "C" {

// vis(origins, dirs) of make_sdf_visibility for num_rays rays ([num_rays, 3]
// each, contiguous) into out [num_rays]. cells: the packed cell rows
// [rz ry rx, 8] (16-byte aligned). inv_scale: the factor by which PyTorch
// multiplies for a division by the scalar scale on the card. counts: null, or
// [2] int64 to which the live and the issued ray-steps are added.
int sdf_trace(const float* origins, const float* dirs, const float* cells, float* out,
              unsigned long long* counts, long long num_rays, int rx, int ry, int rz,
              float scale, float inv_scale, float t_start, float t_max, float min_step,
              float softness, int num_steps, void* stream) {
  if (num_rays <= 0 || rx <= 0 || ry <= 0 || rz <= 0 || num_steps < 0 ||
      (long long)rx * ry * rz > 0x7fffffffLL || reinterpret_cast<uintptr_t>(cells) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  TraceParams q;
  q.rx = rx;
  q.ry = ry;
  q.rz = rz;
  q.res_x = (float)rx;
  q.res_y = (float)ry;
  q.res_z = (float)rz;
  q.inv_scale = inv_scale;
  q.scale = scale;
  q.t_start = t_start;
  q.t_max = t_max;
  q.min_step = min_step;
  q.softness = softness;
  q.num_steps = num_steps;
  const long long blocks = (num_rays + kTraceThreads - 1) / kTraceThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  sdf_trace_kernel<<<(unsigned)blocks, kTraceThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      origins, dirs, cells, out, num_rays, q, counts);
  return (int)cudaGetLastError();
}

}  // extern "C"
