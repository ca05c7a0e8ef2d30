// K5: the Monte-Carlo shading loop of env_shade, forward and backward, one
// thread a point.
//
// Replaces no Pallas kernel: the JAX package evaluates the loop in plain jnp
// (geosplatting_tpu/ops/envshade.py:env_shade), and so did its port
// (ops/envshade.py: S checkpointed steps of _mc_step, each two _eval_sample
// calls of eval_bsdf and the MIS and visibility weights). Added because that
// loop was the port's largest host cost: some 200 small launches a step, run
// again by the checkpoint's recomputation and twice over by autograd's
// backward, about 50,000 launches a training view of 64 steps, with the card
// idle 85 % of the time between them.
//
// Bound on the H100: the sample reads. A step reads 56 bytes a point (the two
// directions, MIS weights and visibilities, the bank entry and the texel):
// 64 x 786,432 x 56 B = 2.8 GB a stage-2 view, 0.84 ms at 3.35 TB/s (stage 3,
// 640,000 points: 0.69 ms), against 2 x benchmark/opcount.py's
// EVAL_SAMPLE_OPS = 300 FP32 operations a step, 0.23 ms at 67 TFLOP/s. The
// backward reads the same, plus its atomics into the light.
//
// Design:
//   * Registers across the steps. A thread reads its point's kd, arm, normal
//     and view direction once, walks the S steps reading step k's samples
//     (layout [S, N, ...], so neighbouring threads read neighbouring rows),
//     keeps the (diffuse, specular, residual) sums in registers and writes
//     them once. What depends on the point alone (the specular colour, alpha^2,
//     n . wo and its Smith term) is computed once, with the same operations.
//   * The plain step's float order. Every operation is the plain step's on
//     the card, in its order and each rounded (no contraction into fused
//     multiply-adds), so the forward gives the plain loop's bits, as K4 does
//     for the trace (csrc/sdf_trace.cu): a sum over the last axis of 3 is
//     (x0 + x2) + x1, as PyTorch reduces it on the card; x / pi is
//     x * (1 / pi) with 1 / pi rounded to float, as PyTorch divides by a
//     scalar there; 1 / x is a division (Tensor.__rtruediv__ is reciprocal);
//     a mean of 3 is that sum times float(N) / float(3 N), PyTorch's mean
//     factor; x ** 5 is powf(x, 5), with the exponent a kernel argument as in
//     PyTorch's pow kernel; the sums run (acc + d1) + d2. Clamps pass NaN on
//     as torch.clamp does.
//   * The backward recomputes each step's forward in registers (no
//     checkpoint, nothing saved per step) and runs its hand-derived adjoint
//     (tests/test_torch_mc_shade.py writes it out in PyTorch and holds it
//     against autograd), with autograd's conventions where they decide a
//     value: a clamp passes the gradient where min <= x <= max, a where()
//     passes nothing to the branch it did not take, and the masked branch
//     keeps its finite stand-in inputs. The gradients of kd, arm, the normal
//     and the view direction build up in registers over the steps and are
//     written once. The adjoint's own arithmetic is free to contract: its sums
//     run in another order than autograd's in any case.
//   * The bank's gradient (the light sample's colour, [m^2, 3]) is summed per
//     block in shared memory when m^2 x 12 bytes fit in what a block may use
//     (24 KB at m^2 = 2,025), and added to device memory once per block by
//     persistent blocks; past that, by global atomics. The BSDF sample's
//     texel gradient goes by global atomicAdd. A zero gradient is not added
//     (adding 0 changes no bit).
//   * A point whose three upstream gradients are all exactly zero skips its
//     steps: every term it would add is then 0 times a finite value (the
//     stand-in inputs keep the masked branch finite), so for finite inputs
//     the skip changes no bit. In stage 2 that covers most padding rows.
#include "common.cuh"

#include <cstdint>

namespace geosplat {

constexpr int kShadeThreads = 256;

// PyTorch's scalars as it converts them to float on the card
constexpr float kEps = static_cast<float>(1e-4);              // SPECULAR_EPS
constexpr float kEpsHi = static_cast<float>(1.0 - 1e-4);      // 1 - SPECULAR_EPS
constexpr float kAlphaMin = static_cast<float>(0.08 * 0.08);  // min_roughness ** 2
constexpr float kFloor = static_cast<float>(1e-20);           // safe_normalize's eps
constexpr float kPi = static_cast<float>(3.141592653589793);
constexpr float kInvPi = 1.0f / kPi;                          // x / pi as x * (1 / pi)
constexpr float kF0 = static_cast<float>(0.04);

enum ShadeMode { kPbr = 0, kWhiteLobe = 1 };

struct ShadeArgs {
  const float *kd, *arm, *nrm, *wo, *bank_cols, *light_rows;
  const float *wi_l, *mis_l, *v_l;
  const long long* bidx;
  const float *wi_b, *mis_b, *v_b;
  const long long* tex_b;
  long long n;
  int steps, mode;
  float frac, third, exponent;
};

// torch.clamp: a NaN operand is the result
__device__ __forceinline__ float clamp_min(float x, float lo) { return x != x ? x : fmaxf(x, lo); }

__device__ __forceinline__ float clamp2(float x, float lo, float hi) {
  return x != x ? x : fminf(fmaxf(x, lo), hi);
}

// (a * b).sum(-1) over 3 on the card
__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a[0], b[0]), __fmul_rn(a[2], b[2])), __fmul_rn(a[1], b[1]));
}

// _lambda_ggx, with its intermediates for the backward
struct Smith {
  float c, c2, tan2, root, lam;
};

// What a point's steps share.
struct Point {
  float kd[3], arm[3], n[3], wo[3];
  float sc[3];     // spec_col
  float a2;        // alpha_sqr
  float wo_n;      // wo . n
  Smith so;        // Lambda at wo . n
  float lo_half;   // Lambda at the masked branch's stand-in 0.5
};

__device__ __forceinline__ Smith smith(float a2, float cos_t) {
  Smith s;
  s.c = clamp2(cos_t, kEps, kEpsHi);
  s.c2 = __fmul_rn(s.c, s.c);
  s.tan2 = __fdiv_rn(__fsub_rn(1.0f, s.c2), s.c2);
  s.root = __fsqrt_rn(__fadd_rn(1.0f, __fmul_rn(a2, s.tan2)));
  s.lam = __fmul_rn(0.5f, __fsub_rn(s.root, 1.0f));
  return s;
}

__device__ __forceinline__ Point load_point(const ShadeArgs& a, long long i) {
  Point p;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    p.kd[c] = __ldg(a.kd + 3 * i + c);
    p.arm[c] = __ldg(a.arm + 3 * i + c);
    p.n[c] = __ldg(a.nrm + 3 * i + c);
    p.wo[c] = __ldg(a.wo + 3 * i + c);
  }
  // spec_col = (0.04 (1 - metallic) + kd metallic) (1 - occlusion)
  const float f0 = __fmul_rn(kF0, __fsub_rn(1.0f, p.arm[2]));
  const float occ = __fsub_rn(1.0f, p.arm[0]);
#pragma unroll
  for (int c = 0; c < 3; ++c) p.sc[c] = __fmul_rn(__fadd_rn(f0, __fmul_rn(p.kd[c], p.arm[2])), occ);
  const float alpha = clamp2(__fmul_rn(p.arm[1], p.arm[1]), kAlphaMin, 1.0f);
  p.a2 = __fmul_rn(alpha, alpha);
  p.wo_n = dot3(p.wo, p.n);
  p.so = smith(p.a2, p.wo_n);
  p.lo_half = smith(p.a2, 0.5f).lam;
  return p;
}

// One sample's BSDF (eval_bsdf, or the white lobe), with what the backward
// needs of it.
struct Bsdf {
  float ndl, lam;              // n . wi, clamp(n . wi, min 0) / pi
  float spec[3];               // where(front, f w, 0)
  bool front;
  float x[3], sq, r, h[3];     // wo + wi, |.|^2, its clamped root, the half vector
  float wo_h, n_h, swn;        // wo . h, n . h, safe wo . n
  float cd, dd, d;             // the NDF's clamped cosine, its denominator's root, D
  Smith si;                    // Lambda at n . wi
  float g, xp, pw, f[3], w;    // G, clamp(1 - wo . h, 0, 1), its 5th power, Fresnel, D G / 4 wo.n
};

__device__ __forceinline__ void eval_bsdf(const Point& p, const float* wi, int mode,
                                          float exponent, Bsdf& b) {
  b.ndl = dot3(p.n, wi);
  b.lam = __fmul_rn(clamp_min(b.ndl, 0.0f), kInvPi);
  b.front = false;
  b.spec[0] = b.spec[1] = b.spec[2] = 0.0f;
  if (mode != kPbr) return;
#pragma unroll
  for (int c = 0; c < 3; ++c) b.x[c] = __fadd_rn(p.wo[c], wi[c]);
  b.sq = dot3(b.x, b.x);
  b.r = __fsqrt_rn(clamp_min(b.sq, kFloor));
#pragma unroll
  for (int c = 0; c < 3; ++c) b.h[c] = __fdiv_rn(b.x[c], b.r);
  b.wo_h = dot3(p.wo, b.h);
  b.n_h = dot3(p.n, b.h);
  const float wi_n = b.ndl;  // (wi * n).sum(-1): the same products in the same order
  b.front = (p.wo_n > kEps) && (wi_n > kEps);
  b.swn = b.front ? clamp_min(p.wo_n, kEps) : 1.0f;
  b.cd = clamp2(b.front ? b.n_h : 0.5f, kEps, kEpsHi);
  b.dd = __fadd_rn(__fmul_rn(__fsub_rn(__fmul_rn(b.cd, p.a2), b.cd), b.cd), 1.0f);
  b.d = __fdiv_rn(p.a2, __fmul_rn(__fmul_rn(b.dd, b.dd), kPi));
  b.si = smith(p.a2, b.front ? wi_n : 0.5f);
  const float lo = b.front ? p.so.lam : p.lo_half;
  b.g = __fdiv_rn(1.0f, __fadd_rn(__fadd_rn(1.0f, lo), b.si.lam));
  b.xp = clamp2(__fsub_rn(1.0f, b.wo_h), 0.0f, 1.0f);
  b.pw = powf(b.xp, exponent);
  b.w = __fdiv_rn(__fmul_rn(__fmul_rn(b.d, b.g), 0.25f), b.swn);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    b.f[c] = __fadd_rn(p.sc[c], __fmul_rn(__fsub_rn(1.0f, p.sc[c]), b.pw));
    b.spec[c] = b.front ? __fmul_rn(b.f[c], b.w) : 0.0f;
  }
}

// One sample of a step: its direction, MIS weight, visibility and colour.
struct Sample {
  float wi[3], mis, v, col[3];
};

__device__ __forceinline__ void load_samples(const ShadeArgs& a, long long row, Sample& sl,
                                             Sample& sb, long long& bank, long long& tex) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    sl.wi[c] = __ldg(a.wi_l + 3 * row + c);
    sb.wi[c] = __ldg(a.wi_b + 3 * row + c);
  }
  sl.mis = __ldg(a.mis_l + row);
  sl.v = __ldg(a.v_l + row);
  sb.mis = __ldg(a.mis_b + row);
  sb.v = __ldg(a.v_b + row);
  bank = __ldg(a.bidx + row);
  tex = __ldg(a.tex_b + row);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    sl.col[c] = __ldg(a.bank_cols + 3 * bank + c);
    sb.col[c] = __ldg(a.light_rows + 3 * tex + c);
  }
}

// _eval_sample's three terms, added to the sums as (acc + d1) + d2 adds them.
__device__ __forceinline__ void add_sample(const ShadeArgs& a, const Sample& s, const Bsdf& b,
                                           float* d, float* sp, float* r) {
  const float m = __fmul_rn(s.mis, a.frac);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float common = __fmul_rn(m, s.col[c]);
    d[c] = __fadd_rn(d[c], __fmul_rn(__fmul_rn(b.lam, common), s.v));
    sp[c] = __fadd_rn(sp[c], __fmul_rn(__fmul_rn(b.spec[c], common), s.v));
  }
  const float omv = __fsub_rn(1.0f, s.v);
  const float mean_d = __fmul_rn(__fadd_rn(__fadd_rn(b.lam, b.lam), b.lam), a.third);
  const float mean_s =
      __fmul_rn(__fadd_rn(__fadd_rn(b.spec[0], b.spec[2]), b.spec[1]), a.third);
  r[0] = __fadd_rn(r[0], __fmul_rn(__fmul_rn(__fmul_rn(mean_d, omv), s.mis), a.frac));
  r[1] = __fadd_rn(r[1], __fmul_rn(__fmul_rn(__fmul_rn(mean_s, omv), s.mis), a.frac));
}

__global__ void __launch_bounds__(kShadeThreads)
mc_shade_fwd_kernel(ShadeArgs a, float* __restrict__ diffuse, float* __restrict__ specular,
                    float* __restrict__ residual) {
  const long long i = (long long)blockIdx.x * kShadeThreads + threadIdx.x;
  if (i >= a.n) return;
  const Point p = load_point(a, i);
  float d[3] = {0.0f, 0.0f, 0.0f}, sp[3] = {0.0f, 0.0f, 0.0f}, r[2] = {0.0f, 0.0f};
  for (int k = 0; k < a.steps; ++k) {
    Sample sl, sb;
    long long bank, tex;
    load_samples(a, (long long)k * a.n + i, sl, sb, bank, tex);
    Bsdf b;
    eval_bsdf(p, sl.wi, a.mode, a.exponent, b);
    add_sample(a, sl, b, d, sp, r);
    eval_bsdf(p, sb.wi, a.mode, a.exponent, b);
    add_sample(a, sb, b, d, sp, r);
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    diffuse[3 * i + c] = d[c];
    specular[3 * i + c] = sp[c];
  }
  residual[2 * i] = r[0];
  residual[2 * i + 1] = r[1];
}

// --- the backward ---------------------------------------------------------------

// A point's gradients as they build up over its steps: the normal's and the
// view direction's, and those of spec_col and alpha_sqr, taken back to kd
// and arm once at the end.
struct PointGrad {
  float n[3], wo[3], sc[3], a2;
};

// The adjoint of one sample (tests/test_torch_mc_shade.py:eval_sample_adjoint):
// adds to g the point's gradients and writes the colour's into g_col.
__device__ __forceinline__ void sample_adjoint(const ShadeArgs& a, const Point& p, const Sample& s,
                                               const Bsdf& b, const float* gd, const float* gs,
                                               const float* gr, PointGrad& g, float* g_col) {
  const float m = s.mis * a.frac;
  const float k = (1.0f - s.v) * s.mis * a.frac;
  float common[3];
  float g_lam = gr[0] * k;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    common[c] = m * s.col[c];
    g_lam += gd[c] * common[c] * s.v;
    g_col[c] = m * s.v * (gd[c] * b.lam + gs[c] * b.spec[c]);
  }
  const float g_ndl = b.ndl >= 0.0f ? g_lam * kInvPi : 0.0f;
#pragma unroll
  for (int c = 0; c < 3; ++c) g.n[c] += g_ndl * s.wi[c];
  if (!b.front) return;  // no specular gradient: the where() passes nothing
  float g_f[3], g_w = 0.0f, g_p = 0.0f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float g_spec = gs[c] * common[c] * s.v + gr[1] * k * a.third;
    g_f[c] = g_spec * b.w;
    g_w += g_spec * b.f[c];
    g.sc[c] += g_f[c] * (1.0f - b.pw);
    g_p += g_f[c] * (1.0f - p.sc[c]);
  }
  // d/dx x^e = e x^(e-1), as autograd's pow backward
  const float g_xp = g_p * a.exponent * powf(b.xp, a.exponent - 1.0f);
  const float one_m = 1.0f - b.wo_h;
  const float g_wo_h = (one_m >= 0.0f && one_m <= 1.0f) ? -g_xp : 0.0f;
  const float inv_swn = 1.0f / b.swn;
  const float g_d = g_w * b.g * 0.25f * inv_swn;
  const float g_g = g_w * b.d * 0.25f * inv_swn;
  float g_wo_n = -g_w * b.w * inv_swn;  // front: wo . n > eps, inside the clamp
  // D = a2 / (dd^2 pi), dd = (c a2 - c) c + 1
  const float g_dd = -2.0f * g_d * b.d / b.dd;
  g.a2 += g_d / (b.dd * b.dd * kPi) + g_dd * b.cd * b.cd;
  const float g_n_h =
      (b.n_h >= kEps && b.n_h <= kEpsHi) ? g_dd * 2.0f * b.cd * (p.a2 - 1.0f) : 0.0f;
  // G = 1 / (1 + Lambda(wo . n) + Lambda(wi . n))
  const float g_den = -g_g * b.g * b.g;
  float g_wi_n = 0.0f;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const Smith& sm = j == 0 ? p.so : b.si;
    const float cos_t = j == 0 ? p.wo_n : b.ndl;
    const float g_root = 0.25f * g_den / sm.root;
    g.a2 += g_root * sm.tan2;
    const float g_c = (cos_t >= kEps && cos_t <= kEpsHi)
                          ? -g_root * p.a2 / (sm.c2 * sm.c2) * 2.0f * sm.c : 0.0f;
    if (j == 0) g_wo_n += g_c; else g_wi_n += g_c;
  }
  // h = (wo + wi) / sqrt(max(|wo + wi|^2, 1e-20))
  float g_h[3], gh_x = 0.0f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    g_h[c] = g_wo_h * p.wo[c] + g_n_h * p.n[c];
    gh_x += g_h[c] * b.x[c];
  }
  const float g_r = -gh_x / (b.r * b.r);
  const float g_sq = b.sq >= kFloor ? g_r / (2.0f * b.r) : 0.0f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    g.wo[c] += g_h[c] / b.r + 2.0f * b.x[c] * g_sq + g_wo_h * b.h[c] + g_wo_n * p.n[c];
    g.n[c] += g_n_h * b.h[c] + g_wo_n * p.wo[c] + g_wi_n * s.wi[c];
  }
}

__device__ __forceinline__ void add_nonzero(float* dst, const float* v) {
  if (v[0] != 0.0f || v[1] != 0.0f || v[2] != 0.0f) {
#pragma unroll
    for (int c = 0; c < 3; ++c) atomicAdd(dst + c, v[c]);
  }
}

__global__ void __launch_bounds__(kShadeThreads)
mc_shade_bwd_kernel(ShadeArgs a, const float* __restrict__ g_diffuse,
                    const float* __restrict__ g_specular, const float* __restrict__ g_residual,
                    float* __restrict__ g_kd, float* __restrict__ g_arm,
                    float* __restrict__ g_nrm, float* __restrict__ g_wo, float* g_bank,
                    float* g_light, int bank_rows, int bank_in_smem) {
  extern __shared__ float s_bank[];
  if (bank_in_smem) {
    for (int e = threadIdx.x; e < 3 * bank_rows; e += kShadeThreads) s_bank[e] = 0.0f;
    __syncthreads();
  }
  float* bank_dst = bank_in_smem ? s_bank : g_bank;
  const long long stride = (long long)gridDim.x * kShadeThreads;
  for (long long i = (long long)blockIdx.x * kShadeThreads + threadIdx.x; i < a.n; i += stride) {
    float gd[3], gs[3], gr[2];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      gd[c] = __ldg(g_diffuse + 3 * i + c);
      gs[c] = __ldg(g_specular + 3 * i + c);
    }
    gr[0] = __ldg(g_residual + 2 * i);
    gr[1] = __ldg(g_residual + 2 * i + 1);
    PointGrad g = {};
    const Point p = load_point(a, i);
    const bool any = gd[0] != 0.0f || gd[1] != 0.0f || gd[2] != 0.0f || gs[0] != 0.0f ||
                     gs[1] != 0.0f || gs[2] != 0.0f || gr[0] != 0.0f || gr[1] != 0.0f;
    for (int k = 0; any && k < a.steps; ++k) {
      const long long row = (long long)k * a.n + i;
      Sample sl, sb;
      long long bank, tex;
      load_samples(a, row, sl, sb, bank, tex);
      Bsdf b;
      float g_col[3];
      eval_bsdf(p, sl.wi, a.mode, a.exponent, b);
      sample_adjoint(a, p, sl, b, gd, gs, gr, g, g_col);
      if (g_bank != nullptr) add_nonzero(bank_dst + 3 * bank, g_col);
      eval_bsdf(p, sb.wi, a.mode, a.exponent, b);
      sample_adjoint(a, p, sb, b, gd, gs, gr, g, g_col);
      if (g_light != nullptr) add_nonzero(g_light + 3 * tex, g_col);
    }
    // spec_col = t4 (1 - occlusion), t4 = 0.04 (1 - metallic) + kd metallic;
    // alpha_sqr = clamp(roughness^2, 0.08^2, 1)^2
    const float occ = 1.0f - p.arm[0];
    float g_occ = 0.0f, g_met = 0.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float t4 = kF0 * (1.0f - p.arm[2]) + p.kd[c] * p.arm[2];
      const float g_t4 = g.sc[c] * occ;
      g_occ -= g.sc[c] * t4;
      g_met += g_t4 * (p.kd[c] - kF0);
      g_kd[3 * i + c] = g_t4 * p.arm[2];
      g_nrm[3 * i + c] = g.n[c];
      g_wo[3 * i + c] = g.wo[c];
    }
    const float rough2 = p.arm[1] * p.arm[1];
    const float alpha = clamp2(rough2, kAlphaMin, 1.0f);
    const bool inside = rough2 >= kAlphaMin && rough2 <= 1.0f;
    g_arm[3 * i] = g_occ;
    g_arm[3 * i + 1] = inside ? g.a2 * 2.0f * alpha * 2.0f * p.arm[1] : 0.0f;
    g_arm[3 * i + 2] = g_met;
  }
  if (bank_in_smem && g_bank != nullptr) {
    __syncthreads();
    for (int e = threadIdx.x; e < 3 * bank_rows; e += kShadeThreads)
      if (s_bank[e] != 0.0f) atomicAdd(g_bank + e, s_bank[e]);
  }
}

ShadeArgs make_args(const float* kd, const float* arm, const float* nrm, const float* wo,
                    const float* bank_cols, const float* light_rows, const float* wi_l,
                    const float* mis_l, const float* v_l, const long long* bidx,
                    const float* wi_b, const float* mis_b, const float* v_b,
                    const long long* tex_b, long long n, int steps, int mode, float frac,
                    float third, float exponent) {
  return ShadeArgs{kd, arm, nrm, wo, bank_cols, light_rows, wi_l, mis_l, v_l, bidx,
                   wi_b, mis_b, v_b, tex_b, n, steps, mode, frac, third, exponent};
}

}  // namespace geosplat

using namespace geosplat;

extern "C" {

// env_shade's sample loop for n points and `steps` steps into diffuse [n, 3],
// specular [n, 3] and residual [n, 2] (written, not added to). kd, arm, nrm,
// wo: [n, 3]; bank_cols: [m^2, 3]; light_rows: [texels, 3]; the samples
// [steps, n, 3] (wi_l, wi_b) or [steps, n] (the rest; bidx and tex_b int64).
// mode: 0 pbr, 1 the white Lambertian lobe ("diffuse", "white"). frac: the
// float of 1 / steps; third: float(n) / float(3 n); exponent: 5.
int mc_shade_fwd(const float* kd, const float* arm, const float* nrm, const float* wo,
                 const float* bank_cols, const float* light_rows, const float* wi_l,
                 const float* mis_l, const float* v_l, const long long* bidx, const float* wi_b,
                 const float* mis_b, const float* v_b, const long long* tex_b, float* diffuse,
                 float* specular, float* residual, long long n, int steps, int mode, float frac,
                 float third, float exponent, void* stream) {
  if (n < 0 || steps < 0 || (mode != kPbr && mode != kWhiteLobe))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const long long blocks = (n + kShadeThreads - 1) / kShadeThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const ShadeArgs a = make_args(kd, arm, nrm, wo, bank_cols, light_rows, wi_l, mis_l, v_l, bidx,
                                wi_b, mis_b, v_b, tex_b, n, steps, mode, frac, third, exponent);
  mc_shade_fwd_kernel<<<(unsigned)blocks, kShadeThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, diffuse, specular, residual);
  return (int)cudaGetLastError();
}

// The backward of mc_shade_fwd for upstream gradients g_diffuse, g_specular,
// g_residual: writes g_kd, g_arm, g_nrm, g_wo ([n, 3] each) and adds into
// g_bank [bank_rows, 3] and g_light [texels, 3] (zeroed by the caller; null
// to skip either).
int mc_shade_bwd(const float* kd, const float* arm, const float* nrm, const float* wo,
                 const float* bank_cols, const float* light_rows, const float* wi_l,
                 const float* mis_l, const float* v_l, const long long* bidx, const float* wi_b,
                 const float* mis_b, const float* v_b, const long long* tex_b,
                 const float* g_diffuse, const float* g_specular, const float* g_residual,
                 float* g_kd, float* g_arm, float* g_nrm, float* g_wo, float* g_bank,
                 float* g_light, long long n, int steps, int mode, float frac, float third,
                 float exponent, int bank_rows, void* stream) {
  if (n < 0 || steps < 0 || bank_rows <= 0 || (mode != kPbr && mode != kWhiteLobe))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaError_t err;
  int device = 0, sms = 0, smem_max = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return (int)err;
  if ((err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                    device)) != cudaSuccess)
    return (int)err;
  // the bank's gradient in shared memory when it fits a block
  const long long bank_bytes = 12LL * bank_rows;
  const int in_smem = g_bank != nullptr && bank_bytes <= smem_max;
  const int smem = in_smem ? (int)bank_bytes : 0;
  if ((err = cudaFuncSetAttribute(mc_shade_bwd_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, mc_shade_bwd_kernel,
                                                           kShadeThreads, smem)) != cudaSuccess)
    return (int)err;
  // as many blocks as stay resident at once, each looping over points, so
  // each block adds its bank sums to device memory once
  const long long needed = (n + kShadeThreads - 1) / kShadeThreads;
  const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const long long grid = needed < resident ? needed : resident;
  const ShadeArgs a = make_args(kd, arm, nrm, wo, bank_cols, light_rows, wi_l, mis_l, v_l, bidx,
                                wi_b, mis_b, v_b, tex_b, n, steps, mode, frac, third, exponent);
  mc_shade_bwd_kernel<<<(unsigned)grid, kShadeThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      a, g_diffuse, g_specular, g_residual, g_kd, g_arm, g_nrm, g_wo, g_bank, g_light, bank_rows,
      in_smem);
  return (int)cudaGetLastError();
}

}  // extern "C"
