"""K5, the Monte-Carlo shading loop of ``env_shade``, on the CPU.

A CPU tensor takes the plain loop (64 checkpointed steps of ``_mc_step`` in
the cells), which stays as K5's plain version: ``env_shade`` gives exactly
what the loop gave before K5, values and gradients, and launches no kernel.
The card's backward kernel (``csrc/mc_shade.cu``) follows the hand-derived
adjoint of ``_eval_sample`` written out here, held against autograd of the
plain step in float64 at points that sit on each clamp and branch.
"""
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from geosplatting_tpu_torch import _kernels
from geosplatting_tpu_torch.graphics import gmath
from geosplatting_tpu_torch.ops import envshade as es
from geosplatting_tpu_torch.ops.segment_rows import gather_rows

# multiples of 32 throughout, so every elementwise pass on the CPU takes its
# vectorised loop whole, whatever the vector width
NPTS = 64
H, W = 32, 64
VIEW = (0.3, 0.6, 2.8)
MODES = ("pbr", "diffuse", "white")


def scene(dtype=torch.float32):
    """Points on a shell with normals toward the viewer, and the rows that
    sit on the step's branches: back-facing (0-5), n = wo (6-11), roughness
    under the clamp (12-17) and at 1 (18-19); a smooth light with a lobe."""
    g = torch.Generator().manual_seed(0)
    view = torch.tensor(VIEW)
    d = F.normalize(torch.randn((NPTS, 3), generator=g), dim=-1)
    pos = d * (0.36 + 0.2 * torch.rand((NPTS, 1), generator=g))
    wo = gmath.safe_normalize(view - pos)
    nrm = F.normalize(0.3 * d + wo, dim=-1)
    nrm[0:6] = -nrm[0:6]
    nrm[6:12] = wo[6:12]
    kd = 0.2 + 0.6 * torch.rand((NPTS, 3), generator=g)
    arm = torch.stack((0.3 * torch.rand(NPTS, generator=g),
                       0.3 + 0.6 * torch.rand(NPTS, generator=g),
                       0.05 + 0.75 * torch.rand(NPTS, generator=g)), -1)
    arm[12:18, 1] = 0.05
    arm[18:20, 1] = 1.0
    i, j = torch.meshgrid(torch.arange(H) + 0.5, torch.arange(W) + 0.5, indexing="ij")
    th, ph = i / H * math.pi, j / W * 2 * math.pi
    lobe = torch.exp(-((th - 0.9) ** 2 + (ph - 2.0) ** 2) * 2.0)
    light = (0.3 + 0.15 * torch.sin(th) * (1 + torch.cos(ph)) + 2.0 * lobe)[..., None] \
        + torch.tensor([0.0, 0.07, 0.14])
    draws = es.draw_shade(NPTS, num_samples_x=2, light_bank=64, generator=g)
    wts = [torch.randn(s, generator=g) for s in ((NPTS, 3), (NPTS, 3), (NPTS, 2))]
    return [x.to(dtype) for x in (pos, nrm, view, kd, arm, light)], draws, wts


def visibility(origins, dirs):
    """Fractional, some 0 and some 1: every term of the residual is reached."""
    return torch.clamp(0.5 + 0.8 * dirs[..., 1], 0.0, 1.0)


def plain_env_shade(positions, normals, view_pos, kd, arm, light, draws, bsdf):
    """``env_shade`` as it stood before K5: the same sampling pass, then the
    loop of S checkpointed ``_mc_step`` calls."""
    s = draws.bidx.shape[0]
    m = int(round(draws.ub.shape[0] ** 0.5))
    wo = gmath.safe_normalize(view_pos - positions)
    cell = torch.arange(m * m)
    ub = ((cell % m).float() + draws.ub) / m
    vb = ((cell // m).float() + draws.vb) / m
    with torch.no_grad():
        bank_dirs = es.sample_light(light, ub, vb)
        bank_pdf = es.light_pdf_at(light, bank_dirs)
    bank_cols = es.eval_light(light, bank_dirs)
    smp = es._draw_samples(light, positions.detach(), normals.detach(), wo.detach(),
                           kd.detach(), arm.detach(), bank_dirs, bank_pdf, draws, visibility, 1.0)
    light_rows = light.data.reshape(-1, light.data.shape[-1])
    n_pts = positions.shape[0]
    acc = (positions.new_zeros((n_pts, 3)), positions.new_zeros((n_pts, 3)),
           positions.new_zeros((n_pts, 2)))

    def step(kd, arm, normals, wo, bank_cols, light_rows, wi_l, mis_l, v_l, bidx, wi_b, mis_b,
             v_b, tex_b, d_acc, s_acc, r_acc):
        d1, s1, r1 = es._eval_sample(kd, arm, normals, wo, wi_l, mis_l, v_l,
                                     gather_rows(bank_cols, bidx), 1.0 / s, bsdf)
        d2, s2, r2 = es._eval_sample(kd, arm, normals, wo, wi_b, mis_b, v_b,
                                     gather_rows(light_rows, tex_b), 1.0 / s, bsdf)
        return d_acc + d1 + d2, s_acc + s1 + s2, r_acc + r1 + r2

    for k in range(s):
        args = (kd, arm, normals, wo, bank_cols, light_rows, *(x[k] for x in smp), *acc)
        if torch.is_grad_enabled():
            acc = checkpoint(step, *args, use_reentrant=False, preserve_rng_state=False)
        else:
            acc = step(*args)
    return acc


def shade_cpu(bsdf, shade=None):
    """Outputs and the gradients of (positions, normals, kd, arm, light) of a
    weighted sum of them, through ``shade`` (``env_shade`` by default)."""
    (pos, nrm, view, kd, arm, light), draws, wts = scene()
    leaves = [x.clone().requires_grad_() for x in (pos, nrm, kd, arm, light)]
    lp = es.compute_light_pdf(leaves[4])
    if shade is None:
        out = es.env_shade(leaves[0], leaves[1], view, leaves[2], leaves[3], lp, draws,
                           visibility_fn=visibility, bsdf=bsdf)
    else:
        out = shade(leaves[0], leaves[1], view, leaves[2], leaves[3], lp, draws, bsdf)
    sum((o * w).sum() for o, w in zip(out, wts)).backward()
    return [o.detach() for o in out], [x.grad for x in leaves]


# The sums of (diffuse, specular, residual) and of the gradients of
# (positions, normals, kd, arm, light), in float64, captured from the loop
# before K5 on the CPU.
CAPTURED = {
    "pbr": (60.53311500698328, 6.17575595155995, 27.29685483027697, -1.1401850505540096,
            154.0306987944059, -0.16535822437094794, 2.521828685809851, -13.902575162516769),
    "diffuse": (60.53311500698328, 0.0, 25.00888028368354, None,
                -7.356163194403052, None, None, -14.049440254111687),
}
CAPTURED["white"] = CAPTURED["diffuse"]  # the same white Lambertian lobe


@pytest.mark.parametrize("bsdf", MODES)
def test_env_shade_on_the_cpu_is_the_plain_loop(bsdf):
    """Bit for bit the loop as it was, with no kernel launched; the captured
    sums pin the numbers themselves (rtol 1e-6: another CPU may take other
    vectorised sums in the light's tables)."""
    before = (_kernels.launches["mc_shade_fwd"], _kernels.launches["mc_shade_bwd"])
    outs, grads = shade_cpu(bsdf)
    assert (_kernels.launches["mc_shade_fwd"], _kernels.launches["mc_shade_bwd"]) == before
    want_outs, want_grads = shade_cpu(bsdf, plain_env_shade)
    for got, want in zip(outs + grads, want_outs + want_grads):
        if want is None:
            assert got is None
        else:
            np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert outs[2].max() > 1e-3 and outs[0].min() >= 0  # shadowed samples reach the residual
    sums = [None if x is None else float(x.double().sum()) for x in outs + grads]
    for got, want in zip(sums, CAPTURED[bsdf]):
        if want is None:
            assert got is None
        else:
            assert got == pytest.approx(want, rel=1e-6, abs=1e-9)


# --- the adjoint of one sample, as the backward kernel computes it ---------------


def eval_sample_adjoint(kd, arm, nrm, wo, wi, mis, v, light_col, gd, gs, gr, frac, bsdf):
    """Gradients of ``_eval_sample``'s (diffuse, specular, residual), given
    their upstream gradients (gd, gs, gr), into (kd, arm, nrm, wo, light_col),
    derived by hand. Conventions as autograd's: a clamp passes the gradient
    where min <= x <= max, a ``where`` nothing to the branch it did not
    take, and the branch's stand-in inputs are kept."""
    eps = es.SPECULAR_EPS

    def dot(a, b):
        return (a * b).sum(-1)

    m = mis * frac
    common = m[:, None] * light_col
    k = (1 - v) * mis * frac
    ndl = dot(nrm, wi)
    lam = torch.clamp(ndl, min=0.0) / math.pi
    g_lam = dot(gd, common) * v + gr[:, 0] * k
    g_nrm = ((ndl >= 0) * g_lam / math.pi)[:, None] * wi
    if bsdf != "pbr":
        g_light = m[:, None] * v[:, None] * gd * lam[:, None]
        return None, None, g_nrm, None, g_light
    a_raw = arm[:, 1] * arm[:, 1]
    a_cl = torch.clamp(a_raw, 0.08 ** 2, 1.0)
    a2 = a_cl * a_cl
    t4 = 0.04 * (1 - arm[:, 2:3]) + kd * arm[:, 2:3]
    sc = t4 * (1 - arm[:, 0:1])
    x = wo + wi
    sq = dot(x, x)
    r = torch.sqrt(torch.clamp(sq, min=1e-20))
    h = x / r[:, None]
    wo_n, wi_n, wo_h, n_h = dot(wo, nrm), ndl, dot(wo, h), dot(nrm, h)
    front = (wo_n > eps) & (wi_n > eps)
    fm = front.to(kd.dtype)
    swn = torch.where(front, torch.clamp(wo_n, min=eps), 1.0)
    n_h_in = torch.where(front, n_h, 0.5)
    c_d = torch.clamp(n_h_in, eps, 1 - eps)
    dd = (c_d * a2 - c_d) * c_d + 1.0
    dgx = a2 / (dd * dd * math.pi)

    def smith(cos):
        c = torch.clamp(cos, eps, 1 - eps)
        c2 = c * c
        tan2 = (1 - c2) / c2
        root = torch.sqrt(1 + a2 * tan2)
        return c, c2, tan2, root, 0.5 * (root - 1.0)

    wo_n_in, wi_n_in = torch.where(front, wo_n, 0.5), torch.where(front, wi_n, 0.5)
    smo, smi = smith(wo_n_in), smith(wi_n_in)
    gsm = 1.0 / (1.0 + smo[4] + smi[4])
    xp = torch.clamp(1.0 - wo_h, 0, 1)
    pw = xp ** 5
    f = sc + (1.0 - sc) * pw[:, None]
    wgt = dgx * gsm * 0.25 / swn
    spec = fm[:, None] * f * wgt[:, None]

    g_spec = fm[:, None] * (gs * common * v[:, None] + (gr[:, 1] * k / 3)[:, None])
    g_f = g_spec * wgt[:, None]
    g_w = dot(g_spec, f)
    g_sc = g_f * (1.0 - pw[:, None])
    g_xp = dot(g_f, 1.0 - sc) * 5 * xp ** 4
    g_wo_h = -g_xp * ((1 - wo_h >= 0) & (1 - wo_h <= 1))
    g_d = g_w * gsm * 0.25 / swn
    g_g = g_w * dgx * 0.25 / swn
    g_wo_n = -g_w * wgt / swn * fm
    g_a2 = g_d / (dd * dd * math.pi)
    g_dd = -2.0 * g_d * dgx / dd
    g_a2 = g_a2 + g_dd * c_d * c_d
    g_n_h = g_dd * 2.0 * c_d * (a2 - 1.0) * ((n_h_in >= eps) & (n_h_in <= 1 - eps)) * fm
    g_den = -g_g * gsm * gsm
    g_wi_n = torch.zeros_like(wo_n)
    for (c, c2, tan2, root, _), cos_in, is_o in ((smo, wo_n_in, True), (smi, wi_n_in, False)):
        g_root = 0.5 * g_den / (2.0 * root)
        g_a2 = g_a2 + g_root * tan2
        g_c = -g_root * a2 / (c2 * c2) * 2.0 * c * ((cos_in >= eps) & (cos_in <= 1 - eps)) * fm
        if is_o:
            g_wo_n = g_wo_n + g_c
        else:
            g_wi_n = g_wi_n + g_c
    g_h = g_wo_h[:, None] * wo + g_n_h[:, None] * nrm
    g_x = g_h / r[:, None]
    g_r = -dot(g_h, x) / (r * r)
    g_x = g_x + 2.0 * x * ((sq >= 1e-20) * g_r / (2.0 * r))[:, None]
    g_wo = g_x + g_wo_h[:, None] * h + g_wo_n[:, None] * nrm
    g_nrm = g_nrm + g_n_h[:, None] * h + g_wo_n[:, None] * wo + g_wi_n[:, None] * wi
    g_t4 = g_sc * (1 - arm[:, 0:1])
    g_arm = torch.stack((
        -dot(g_sc, t4),
        g_a2 * 2.0 * a_cl * ((a_raw >= 0.08 ** 2) & (a_raw <= 1.0)) * 2.0 * arm[:, 1],
        dot(g_t4, kd - 0.04)), -1)
    g_light = m[:, None] * v[:, None] * (gd * lam[:, None] + gs * spec)
    return g_t4 * arm[:, 2:3], g_arm, g_nrm, g_wo, g_light


def sample_points():
    """One sample a point, float64: the scene's points and wi from the
    normal, the reflection and random directions, plus rows with n . wi = 0,
    wi = wo (n_h and wo_h at 1), wi = -wo (|wo + wi| under the floor) and
    v at 0 and 1."""
    (pos, nrm, view, kd, arm, _), _, _ = scene(torch.float64)
    g = torch.Generator().manual_seed(3)
    wo = gmath.safe_normalize(view - pos)
    refl = gmath.safe_normalize(2 * (wo * nrm).sum(-1, keepdim=True) * nrm - wo)
    rnd = F.normalize(torch.randn((NPTS, 3), generator=g, dtype=torch.float64), dim=-1)
    wi = torch.where((torch.arange(NPTS) % 3 == 0)[:, None], refl,
                     F.normalize(nrm + 0.7 * rnd, dim=-1))
    wi[20:24] = rnd[20:24]
    nrm[24:26] = torch.tensor([0.0, 0.0, 1.0], dtype=torch.float64)
    wi[24:26] = torch.tensor([1.0, 0.0, 0.0], dtype=torch.float64)
    wi[26:28] = wo[26:28]
    wi[6:8] = wo[6:8]
    wi[28:30] = -wo[28:30]
    mis = 0.05 + 3 * torch.rand(NPTS, generator=g, dtype=torch.float64)
    v = torch.rand(NPTS, generator=g, dtype=torch.float64)
    v[30:33], v[33:36] = 0.0, 1.0
    light_col = 0.2 + 2 * torch.rand((NPTS, 3), generator=g, dtype=torch.float64)
    ups = [torch.randn(s, generator=g, dtype=torch.float64) for s in ((NPTS, 3), (NPTS, 3), (NPTS, 2))]
    return kd, arm, nrm, wo, wi, mis, v, light_col, ups


@pytest.mark.parametrize("bsdf", MODES)
def test_adjoint_matches_autograd_of_the_plain_step(bsdf):
    kd, arm, nrm, wo, wi, mis, v, light_col, (gd, gs, gr) = sample_points()
    frac = 1.0 / 64
    leaves = [x.clone().requires_grad_() for x in (kd, arm, nrm, wo, light_col)]
    out = es._eval_sample(leaves[0], leaves[1], leaves[2], leaves[3], wi, mis, v, leaves[4],
                          frac, bsdf)
    want = torch.autograd.grad(sum((o * w).sum() for o, w in zip(out, (gd, gs, gr))), leaves,
                               allow_unused=True)
    got = eval_sample_adjoint(kd, arm, nrm, wo, wi, mis, v, light_col, gd, gs, gr, frac, bsdf)
    front = ((wo * nrm).sum(-1) > es.SPECULAR_EPS) & ((wi * nrm).sum(-1) > es.SPECULAR_EPS)
    assert 0 < int(front.sum()) < NPTS  # both sides of the front test are reached
    for name, a, b in zip(("kd", "arm", "nrm", "wo", "light"), got, want):
        if b is None:
            assert a is None, name
        else:
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-10, atol=1e-12, err_msg=name)
