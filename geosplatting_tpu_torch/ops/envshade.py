"""Monte-Carlo environment shading with multiple importance sampling.

Counterpart of ``geosplatting_tpu/ops/envshade.py``: light pdf tables of a
lat-long environment (pdf proportional to max(RGB) sin(theta), row and
column CDFs), inverse-CDF light sampling through a stratified bank of
directions shared by all points, GGX-VNDF and cosine BSDF sampling, the
separated diffuse / specular BSDF, and ``env_shade``: per point, n^2 steps
of one light sample and one BSDF sample combined with the summed-pdf balance
heuristic, plus the shadowed residual fraction.

What is differentiated is what the JAX package differentiates: the BSDF's
value (into kd, arm, normals and, through the view direction, positions)
and the radiance lookups (into the light table). The sample directions, the
MIS pdf sum, the visibility and the normal offset of the shadow-ray origin
are constants of the backward; differentiating them overflows the f32
gradients. Here that makes all of the sampling gradient-free, so it runs
under ``torch.no_grad`` ahead of the sample loop, in batches of steps, and
the sphere trace with it.

The sample loop over the precomputed samples is K5 (``csrc/mc_shade.cu``)
for tensors on the card: one ``torch.autograd.Function`` whose forward and
backward are one kernel launch each (``mc_shade``), the backward
recomputing every step in registers. For tensors on the CPU it is
``mc_shade_plain``, the S steps of ``_mc_step``, each rematerialised in the
backward (``torch.utils.checkpoint``); the card's tests hold K5 to it.

Randomness is injected: ``env_shade`` takes its draws as tensors
(``ShadeDraws``); ``draw_shade`` makes them from a ``torch.Generator``.

Spans: ``envshade.sample`` (the bank and each batch of steps' samples),
``envshade.visibility`` (their shadow rays), ``envshade.loop`` around the
sample loop's forward and ``envshade.mc_step`` inside it: on the card K5's
forward launch, on the CPU each step (and its recomputation in the
backward); while a profiler records, also ``envshade.loop_backward``, the
loop's backward on autograd's thread (K5's backward launch on the card), and
the counter ``shade.points``.
"""
from __future__ import annotations

import functools
import math
from typing import Callable, NamedTuple

import numpy as np
import torch
from torch.autograd.function import once_differentiable
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from .. import _kernels, counters
from ..graphics import gmath
from .segment_rows import gather_rows

SPECULAR_EPS = 1e-4
_LUMA = (0.2126, 0.7152, 0.0722)
# points traced at once by the sampling pass (bounds its temporaries to ~1 GB)
_BATCH_ROWS = 1 << 23


class LightPdf(NamedTuple):
    data: torch.Tensor   # [H, W, 3] radiance (differentiable)
    pdf: torch.Tensor    # [H, W] normalised texel pdf (detached)
    rows: torch.Tensor   # [H] row cdf
    cols: torch.Tensor   # [H, W] per-row column cdf


class ShadeDraws(NamedTuple):
    """The random numbers of one ``env_shade`` call."""

    ub: torch.Tensor     # [m*m] uniform [0, 1): the light bank's jitter in u
    vb: torch.Tensor     # [m*m] uniform [0, 1): ... in v
    bidx: torch.Tensor   # [S, N] int64 in [0, m*m): bank entry per step and point
    u: torch.Tensor      # [S, N, 3] uniform [0, 1): BSDF sample (u1, u2, lobe choice)

    def to(self, device) -> "ShadeDraws":
        return ShadeDraws(*(x.to(device) for x in self))


def draw_shade(num_points: int, *, num_samples_x: int = 8, light_bank: int = 2048,
               generator: torch.Generator | None = None, device=None) -> ShadeDraws:
    """Draws for ``env_shade`` on ``num_points`` points: n^2 steps for
    ``num_samples_x`` n and a bank of m^2 directions, m = round(sqrt(light_bank))."""
    m2 = int(round(light_bank ** 0.5)) ** 2
    s = num_samples_x * num_samples_x
    kw = dict(generator=generator, device=device)
    return ShadeDraws(
        ub=torch.rand(m2, **kw), vb=torch.rand(m2, **kw),
        bidx=torch.randint(0, m2, (s, num_points), **kw),
        u=torch.rand((s, num_points, 3), **kw),
    )


def compute_light_pdf(data: torch.Tensor) -> LightPdf:
    """Pdf and CDF tables of a lat-long radiance table [H, W, 3]; the tables
    are detached (radiance gradients flow through the lookups only)."""
    h = data.shape[0]
    y = (torch.arange(h, device=data.device) + 0.5) / h
    pdf = torch.clamp(data.detach().amax(-1), min=1e-3) * torch.sin(y * math.pi)[:, None]
    pdf = pdf / pdf.sum()
    cols = torch.cumsum(pdf, 1)
    rows = torch.cumsum(cols[:, -1], 0)
    cols = cols / torch.where(cols[:, -1:] > 0, cols[:, -1:], 1.0)
    rows = rows / torch.where(rows[-1] > 0, rows[-1], 1.0)
    return LightPdf(data=data, pdf=pdf, rows=rows, cols=cols)


def _dir_to_tc(d: torch.Tensor) -> torch.Tensor:
    u = torch.atan2(d[..., 0], -d[..., 2]) / (2 * math.pi) + 0.5
    v = torch.arccos(torch.clamp(d[..., 1], -1.0, 1.0)) / math.pi
    return torch.stack((u, v), -1)


def _tc_to_dir(uv: torch.Tensor) -> torch.Tensor:
    phi = (uv[..., 0] - 0.5) * 2 * math.pi
    theta = uv[..., 1] * math.pi
    sin_t = torch.sin(theta)
    return torch.stack((sin_t * torch.sin(phi), torch.cos(theta), -sin_t * torch.cos(phi)), -1)


def _texel(light: LightPdf, d: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(flat nearest-texel index, solid-angle pdf weight) of direction(s) d."""
    h, w = light.pdf.shape
    tc = _dir_to_tc(d)
    x = (tc[..., 0] * w).long().clamp(0, w - 1)
    y = (tc[..., 1] * h).long().clamp(0, h - 1)
    denom = 2 * math.pi ** 2 * torch.clamp(torch.sin(tc[..., 1] * math.pi), min=1e-4)
    return y * w + x, denom.new_full((), float(h * w)) / denom


def light_pdf_at(light: LightPdf, d: torch.Tensor) -> torch.Tensor:
    """Solid-angle pdf of the light sampler at direction(s) d."""
    idx, weight = _texel(light, d)
    return light.pdf.reshape(-1)[idx] * weight


def sample_light(light: LightPdf, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Inverse-CDF sample directions for (u, v) in [0, 1): [..., 3]."""
    h, w = light.pdf.shape
    shape = u.shape
    u, v = u.reshape(-1), v.reshape(-1)
    y = torch.searchsorted(light.rows, v, side="left").clamp(0, h - 1)
    prev_r = torch.where(y > 0, light.rows[(y - 1).clamp(min=0)], 0.0)
    ry = torch.clamp((v - prev_r) / torch.clamp(light.rows[y] - prev_r, min=1e-12), 0.0, 1.0)
    cols_y = light.cols[y]                                   # [M, W]
    x = torch.searchsorted(cols_y, u[:, None], side="left")[:, 0].clamp(0, w - 1)
    prev_c = torch.where(x > 0, cols_y.gather(1, (x - 1).clamp(min=0)[:, None])[:, 0], 0.0)
    cx = cols_y.gather(1, x[:, None])[:, 0]
    rx = torch.clamp((u - prev_c) / torch.clamp(cx - prev_c, min=1e-12), 0.0, 1.0)
    uv = torch.stack(((x + rx) / w, (y + ry) / h), -1)
    return _tc_to_dir(uv).reshape(shape + (3,))


def eval_light(light: LightPdf, d: torch.Tensor) -> torch.Tensor:
    """Nearest-texel radiance at direction(s) d, differentiable into the
    table (a ``gather_rows``)."""
    idx, _ = _texel(light, d)
    return gather_rows(light.data.reshape(-1, light.data.shape[-1]), idx)


def eval_light_and_pdf(light: LightPdf, d: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(radiance [..., 3], solid-angle pdf [...]) at direction(s) d."""
    idx, weight = _texel(light, d)
    radiance = gather_rows(light.data.reshape(-1, light.data.shape[-1]), idx)
    return radiance, light.pdf.reshape(-1)[idx] * weight


# --- the BSDF ---------------------------------------------------------------------


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(-1, keepdim=True)


def _ndf_ggx(alpha_sqr, cos_t):
    c = torch.clamp(cos_t, SPECULAR_EPS, 1 - SPECULAR_EPS)
    d = (c * alpha_sqr - c) * c + 1.0
    return alpha_sqr / (d * d * math.pi)


def _lambda_ggx(alpha_sqr, cos_t):
    c = torch.clamp(cos_t, SPECULAR_EPS, 1 - SPECULAR_EPS)
    c2 = c * c
    tan2 = (1 - c2) / c2
    return 0.5 * (torch.sqrt(1 + alpha_sqr * tan2) - 1.0)


def _masking_smith(alpha_sqr, cos_i, cos_o):
    return 1.0 / (1.0 + _lambda_ggx(alpha_sqr, cos_i) + _lambda_ggx(alpha_sqr, cos_o))


def eval_bsdf(kd, arm, nrm, wo, wi, min_roughness: float = 0.08):
    """(diffuse as rgb, specular rgb): a demodulated-albedo Lambert lobe and
    GGX specular; arm = (occlusion, roughness, metallic). The masked-out
    branch gets finite stand-in inputs, so its backward stays bounded."""
    lambert = torch.clamp(_dot(nrm, wi), min=0.0) / math.pi
    diffuse = lambert.expand(lambert.shape[:-1] + (3,))
    alpha = arm[..., 1:2] * arm[..., 1:2]
    spec_col = (0.04 * (1 - arm[..., 2:3]) + kd * arm[..., 2:3]) * (1 - arm[..., 0:1])
    _alpha = torch.clamp(alpha, min_roughness ** 2, 1.0)[..., 0]
    alpha_sqr = _alpha * _alpha
    h = gmath.safe_normalize(wo + wi)
    wo_n = _dot(wo, nrm)[..., 0]
    wi_n = _dot(wi, nrm)[..., 0]
    wo_h = _dot(wo, h)[..., 0]
    n_h = _dot(nrm, h)[..., 0]
    front = (wo_n > SPECULAR_EPS) & (wi_n > SPECULAR_EPS)
    safe_wo_n = torch.where(front, torch.clamp(wo_n, min=SPECULAR_EPS), 1.0)
    d = _ndf_ggx(alpha_sqr, torch.where(front, n_h, 0.5))
    g = _masking_smith(alpha_sqr, torch.where(front, wo_n, 0.5), torch.where(front, wi_n, 0.5))
    f = spec_col + (1.0 - spec_col) * torch.clamp(1.0 - wo_h, 0, 1)[..., None] ** 5
    w = f * (d * g * 0.25 / safe_wo_n)[..., None]
    return diffuse, torch.where(front[..., None], w, 0.0)


def _local(v: torch.Tensor, t: torch.Tensor, b: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    return torch.stack((_dot(v, t)[..., 0], _dot(v, b)[..., 0], _dot(v, n)[..., 0]), -1)


def _ggx_vndf_pdf(n, wo, wi, alpha):
    t, b = gmath.build_tangent_frame(n)
    wo_l = _local(wo, t, b, n)
    wi_l = _local(wi, t, b, n)
    valid = (wo_l[..., 2] > 0) & (wi_l[..., 2] > 0)
    m = gmath.safe_normalize(wo_l + wi_l)
    wo_h = (m * wo_l).sum(-1)
    d = _ndf_ggx(alpha * alpha, torch.where(valid, m[..., 2], 0.5))
    g1 = 1.0 / (1.0 + _lambda_ggx(alpha * alpha, torch.where(valid, wo_l[..., 2], 0.5)))
    pdf = g1 * d * torch.clamp(wo_h, min=0.0) / torch.where(
        valid, torch.clamp(wo_l[..., 2], min=SPECULAR_EPS), 1.0)
    pdf = pdf / torch.where(valid, torch.clamp(4 * wo_h, min=SPECULAR_EPS), 1.0)
    return torch.where(valid, pdf, 0.0)


def _cosine_sample(n, u1, u2):
    t, b = gmath.build_tangent_frame(n)
    r = torch.sqrt(u1)
    phi = 2 * math.pi * u2
    local = torch.stack(
        (r * torch.cos(phi), r * torch.sin(phi), torch.sqrt(torch.clamp(1 - u1, min=0.0))), -1)
    wi = local[..., 0:1] * t + local[..., 1:2] * b + local[..., 2:3] * n
    return wi, torch.clamp(local[..., 2], min=0.0) / math.pi


def _ggx_vndf_sample(n, wo, u1, u2, alpha):
    """Heitz's VNDF sampling in the local frame: (wi, pdf)."""
    t, b = gmath.build_tangent_frame(n)
    wo_l = _local(wo, t, b, n)
    a = alpha[..., None]
    vh = gmath.safe_normalize(wo_l * torch.cat((a, a, torch.ones_like(a)), -1))
    lensq = vh[..., 0] ** 2 + vh[..., 1] ** 2
    inv = 1.0 / torch.sqrt(torch.clamp(lensq, min=1e-12))
    t1 = torch.where(
        (lensq > 1e-9)[..., None],
        torch.stack((-vh[..., 1] * inv, vh[..., 0] * inv, torch.zeros_like(inv)), -1),
        vh.new_tensor([1.0, 0.0, 0.0]).expand(vh.shape),
    )
    t2 = torch.cross(vh, t1, dim=-1)
    r = torch.sqrt(u1)
    phi = 2 * math.pi * u2
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + vh[..., 2])
    # eps floors keep sqrt finite where the argument rounds to 0
    p2 = (1.0 - s) * torch.sqrt(torch.clamp(1.0 - p1 * p1, min=1e-12)) + s * p2
    p3 = torch.sqrt(torch.clamp(1.0 - p1 * p1 - p2 * p2, min=1e-12))
    m_l = gmath.safe_normalize(p1[..., None] * t1 + p2[..., None] * t2 + p3[..., None] * vh)
    wi_l = 2.0 * (wo_l * m_l).sum(-1, keepdim=True) * m_l - wo_l
    wi = wi_l[..., 0:1] * t + wi_l[..., 1:2] * b + wi_l[..., 2:3] * n
    pdf = _ggx_vndf_pdf(n, wo, gmath.safe_normalize(wi), alpha)
    return gmath.safe_normalize(wi), pdf


def _bsdf_pdf(p_diffuse, n, wo, wi, alpha):
    cos_pdf = torch.clamp(_dot(n, wi)[..., 0], min=0.0) / math.pi
    return p_diffuse * cos_pdf + (1 - p_diffuse) * _ggx_vndf_pdf(n, wo, wi, alpha)


# --- env_shade --------------------------------------------------------------------


class _Samples(NamedTuple):
    """Per step (leading axis S) and point: the two samples' directions,
    MIS weights 1 / pdf sum, visibilities, the light sample's bank entry and
    the BSDF sample's texel."""

    wi_l: torch.Tensor
    mis_l: torch.Tensor
    v_l: torch.Tensor
    bidx: torch.Tensor
    wi_b: torch.Tensor
    mis_b: torch.Tensor
    v_b: torch.Tensor
    tex_b: torch.Tensor


@torch.no_grad()
def _draw_samples(light, positions, normals, wo, kd, arm, bank_dirs, bank_pdf, draws,
                  visibility_fn, shadow_scale) -> _Samples:
    """Every step's sample directions, MIS weights and visibilities, in
    batches of steps (gradient-free: each is a constant of the backward)."""
    n_pts = positions.shape[0]
    metallic = arm[..., 2:3]
    spec_col = 0.04 * (1 - metallic) + kd * metallic
    luma = kd.new_tensor(_LUMA)
    lum = (kd * luma).sum(-1)
    cos_no = torch.clamp(_dot(wo, normals)[..., 0], min=0.0)
    f_view = spec_col + (1 - spec_col) * torch.clamp(1 - cos_no, 0, 1)[..., None] ** 5
    spec_w = torch.where(cos_no > 0, (f_view * luma).sum(-1), 0.0)
    diff_w = (1 - metallic[..., 0]) * lum
    p_diffuse = torch.where(diff_w + spec_w > 0,
                            diff_w / torch.clamp(diff_w + spec_w, min=1e-12), 1.0)
    alpha = arm[..., 1] * arm[..., 1]
    origins = positions + normals * 1e-3

    s = draws.bidx.shape[0]
    batch = max(1, _BATCH_ROWS // (2 * max(n_pts, 1)))
    out = []
    for k0 in range(0, s, batch):
        bidx = draws.bidx[k0:k0 + batch]
        u = draws.u[k0:k0 + batch]
        with record_function("envshade.sample"):
            wi_l = bank_dirs[bidx]
            pdf_l = bank_pdf[bidx] + _bsdf_pdf(p_diffuse, normals, wo, wi_l, alpha)
            wi_cos, pdf_cos = _cosine_sample(normals, u[..., 0], u[..., 1])
            wi_ggx, pdf_ggx = _ggx_vndf_sample(normals, wo, u[..., 0], u[..., 1], alpha)
            take_diff = u[..., 2] < p_diffuse
            wi_b = torch.where(take_diff[..., None], wi_cos, wi_ggx)
            pdf_bb = torch.where(
                take_diff,
                p_diffuse * pdf_cos + (1 - p_diffuse) * _ggx_vndf_pdf(normals, wo, wi_cos, alpha),
                (1 - p_diffuse) * pdf_ggx
                + p_diffuse * torch.clamp(_dot(normals, wi_ggx)[..., 0], min=0) / math.pi,
            )
            tex_b, weight_b = _texel(light, wi_b)
            pdf_b = light.pdf.reshape(-1)[tex_b] * weight_b + pdf_bb
        with record_function("envshade.visibility"):
            if visibility_fn is not None:
                o = origins.expand(wi_l.shape)
                v = visibility_fn(torch.cat((o, o)).reshape(-1, 3),
                                  torch.cat((wi_l, wi_b)).reshape(-1, 3))
                v = v.reshape((2,) + wi_l.shape[:-1]) * shadow_scale + (1 - shadow_scale)
            else:
                v = torch.ones((2,) + wi_l.shape[:-1], device=positions.device)
        out.append(_Samples(wi_l, 1.0 / torch.clamp(pdf_l, min=1e-4), v[0], bidx,
                            wi_b, 1.0 / torch.clamp(pdf_b, min=1e-4), v[1], tex_b))
    return _Samples(*(torch.cat(parts) for parts in zip(*out)))


def _eval_sample(kd, arm, normals, wo, wi, mis_w, v, light_col, sample_frac, bsdf):
    diff_b, spec_b = eval_bsdf(kd, arm, normals, wo, wi)
    if bsdf in ("diffuse", "white"):
        # a white Lambertian lobe: cos / pi in every channel, no specular
        spec_b = torch.zeros_like(spec_b)
        diff_b = (torch.clamp((normals * wi).sum(-1, keepdim=True), min=0.0) / math.pi
                  ).expand_as(diff_b)
    common = (mis_w * sample_frac)[..., None] * light_col
    diff = diff_b * common * v[..., None]
    spec = spec_b * common * v[..., None]
    resi = torch.stack((
        diff_b.mean(-1) * (1 - v) * mis_w * sample_frac,
        spec_b.mean(-1) * (1 - v) * mis_w * sample_frac,
    ), -1)
    return diff, spec, resi


def _mc_step(sample_frac, bsdf, kd, arm, normals, wo, bank_cols, light_rows,
             wi_l, mis_l, v_l, bidx, wi_b, mis_b, v_b, tex_b, d_acc, s_acc, r_acc):
    with record_function("envshade.mc_step"):
        d1, s1, r1 = _eval_sample(kd, arm, normals, wo, wi_l, mis_l, v_l,
                                  gather_rows(bank_cols, bidx), sample_frac, bsdf)
        d2, s2, r2 = _eval_sample(kd, arm, normals, wo, wi_b, mis_b, v_b,
                                  gather_rows(light_rows, tex_b), sample_frac, bsdf)
        return d_acc + d1 + d2, s_acc + s1 + s2, r_acc + r1 + r2


def mc_shade_plain(kd, arm, normals, wo, bank_cols, light_rows, smp: _Samples,
                   bsdf: str = "pbr"):
    """Plain version of K5: the S steps of ``_mc_step``, each checkpointed
    while autograd records, for tensors on the CPU (and the card's check).
    Returns ((diffuse, specular, residual), the first step's output)."""
    s, n_pts = smp.bidx.shape
    step = functools.partial(_mc_step, 1.0 / s, bsdf)
    acc = first = (kd.new_zeros((n_pts, 3)), kd.new_zeros((n_pts, 3)), kd.new_zeros((n_pts, 2)))
    for k in range(s):
        args = (kd, arm, normals, wo, bank_cols, light_rows, *(x[k] for x in smp), *acc)
        if torch.is_grad_enabled():
            # the draws are tensors, so the recomputation needs no RNG state
            acc = checkpoint(step, *args, use_reentrant=False, preserve_rng_state=False)
        else:
            acc = step(*args)
        if k == 0:
            first = acc
    return acc, first


# K5 (csrc/mc_shade.cu): the sample loop for tensors on the card
_MODES = {"pbr": 0, "diffuse": 1, "white": 1}
_FRESNEL_POWER = 5.0


class _MCShade(torch.autograd.Function):
    """The S steps of ``_mc_step`` in one launch each way: the forward
    kernel gives the plain loop's (diffuse, specular, residual), the
    backward kernel recomputes each step and sends the gradients to kd, arm,
    the normals, wo, the bank's colours and the light's rows."""

    @staticmethod
    def forward(ctx, kd, arm, normals, wo, bank_cols, light_rows, smp, bsdf):
        n, s = kd.shape[0], smp.bidx.shape[0]
        for name, x in (("kd", kd), ("arm", arm), ("normals", normals), ("wo", wo)):
            _kernels.check_cuda_tensor(x, f"mc_shade.{name}", torch.float32, (n, 3))
        _kernels.check_cuda_tensor(bank_cols, "mc_shade.bank_cols", torch.float32,
                                   (bank_cols.shape[0], 3))
        _kernels.check_cuda_tensor(light_rows, "mc_shade.light_rows", torch.float32,
                                   (light_rows.shape[0], 3))
        for name, x in zip(_Samples._fields, smp):
            _kernels.check_cuda_tensor(
                x, f"mc_shade.{name}", torch.int64 if name in ("bidx", "tex_b") else torch.float32,
                (s, n, 3) if name in ("wi_l", "wi_b") else (s, n))
        out = (torch.empty_like(kd), torch.empty_like(kd), kd.new_empty((n, 2)))
        ctx.args = (n, s, _MODES[bsdf], 1.0 / s, float(np.float32(n) / np.float32(3 * n)),
                    _FRESNEL_POWER)
        ctx.smp = smp
        ptrs = [x.data_ptr() for x in (kd, arm, normals, wo, bank_cols, light_rows, *smp, *out)]
        _kernels.launch("mc_shade_fwd", *ptrs, *ctx.args, _kernels.stream_of(kd))
        ctx.save_for_backward(kd, arm, normals, wo, bank_cols, light_rows)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g_diffuse, g_specular, g_residual):
        kd, arm, normals, wo, bank_cols, light_rows = ctx.saved_tensors
        ups = [g.contiguous() for g in (g_diffuse, g_specular, g_residual)]
        grads = [torch.empty_like(kd) for _ in range(4)]
        needs = ctx.needs_input_grad
        g_bank = torch.zeros_like(bank_cols) if needs[4] else None
        g_light = torch.zeros_like(light_rows) if needs[5] else None
        ptrs = [x.data_ptr() for x in (kd, arm, normals, wo, bank_cols, light_rows, *ctx.smp,
                                       *ups, *grads)]
        _kernels.launch("mc_shade_bwd", *ptrs, *(0 if g is None else g.data_ptr()
                                                 for g in (g_bank, g_light)),
                        *ctx.args, bank_cols.shape[0], _kernels.stream_of(kd))
        # the white lobe reads neither kd, arm nor wo
        pbr = ctx.args[2] == _MODES["pbr"]
        g_kd, g_arm, g_nrm, g_wo = grads
        return (g_kd if pbr else None, g_arm if pbr else None, g_nrm, g_wo if pbr else None,
                g_bank, g_light, None, None)


def mc_shade(kd, arm, normals, wo, bank_cols, light_rows, smp: _Samples, bsdf: str = "pbr"):
    """K5: ``env_shade``'s sample loop over the precomputed samples for
    tensors on the card, one kernel launch forward and one backward
    (``launches["mc_shade_fwd"]`` / ``["mc_shade_bwd"]``). Raises for a
    tensor that is not a contiguous float32 (int64 indices) CUDA tensor of
    the expected shape. Returns (diffuse [N, 3], specular [N, 3], residual
    [N, 2])."""
    if bsdf not in _MODES:
        raise ValueError(f"bsdf: {bsdf!r}")
    return _MCShade.apply(kd, arm, normals, wo, bank_cols, light_rows, smp, bsdf)


def env_shade(
    positions: torch.Tensor,     # [N, 3]
    normals: torch.Tensor,       # [N, 3]
    view_pos: torch.Tensor,      # [3] or [N, 3]
    kd: torch.Tensor,            # [N, 3]
    arm: torch.Tensor,           # [N, 3] = (occlusion, roughness, metallic)
    light: LightPdf,
    draws: ShadeDraws,
    *,
    visibility_fn: Callable | None = None,
    shadow_scale: float = 1.0,
    bsdf: str = "pbr",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (diffuse [N, 3], specular [N, 3], residual [N, 2]).

    S = ``draws.bidx.shape[0]`` steps (n^2 for ``num_samples_x`` n), each
    one light sample from the shared stratified bank of m^2 directions
    (m = ``sqrt(len(draws.ub))``) and one BSDF sample, weighted by the
    summed-pdf balance heuristic. ``bsdf="diffuse"`` or ``"white"``
    evaluates a white Lambertian lobe (cos / pi, no specular) at the same
    samples."""
    if bsdf not in _MODES:
        raise ValueError(f"bsdf: {bsdf!r}")
    m = int(round(draws.ub.shape[0] ** 0.5))
    wo = gmath.safe_normalize(view_pos - positions)
    with record_function("envshade.sample"):
        cell = torch.arange(m * m, device=positions.device)
        ub = ((cell % m).float() + draws.ub) / m
        vb = ((cell // m).float() + draws.vb) / m
        with torch.no_grad():
            bank_dirs = sample_light(light, ub, vb)
            bank_pdf = light_pdf_at(light, bank_dirs)
        # radiance per bank direction, once: a light sample is then one row
        # gather, differentiable into the table through the bank
        bank_cols = eval_light(light, bank_dirs)
    smp = _draw_samples(light, positions.detach(), normals.detach(), wo.detach(), kd.detach(),
                        arm.detach(), bank_dirs, bank_pdf, draws, visibility_fn, shadow_scale)
    light_rows = light.data.reshape(-1, light.data.shape[-1])
    n_pts = positions.shape[0]
    counters.count("shade.points", n_pts)
    inputs = (kd, arm, normals, wo, bank_cols, light_rows)
    mark_backward = (counters.recording() and torch.is_grad_enabled()
                     and any(x.requires_grad for x in inputs))
    with record_function("envshade.loop"):
        if positions.device.type == "cuda":
            inputs = tuple(x.contiguous() for x in inputs)
            with record_function("envshade.mc_step"):
                acc = mc_shade(*inputs, smp, bsdf)
            first = acc
        else:
            acc, first = mc_shade_plain(*inputs, smp, bsdf)
        if mark_backward:
            counters.BackwardSpan("envshade.loop_backward", first, inputs).open_at(acc)
    return acc
