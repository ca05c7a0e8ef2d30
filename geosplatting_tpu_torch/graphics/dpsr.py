"""Differentiable Poisson surface reconstruction (DPSR): an oriented point
cloud's normals splatted trilinearly onto a grid, a spectral Poisson solve
for the indicator field, and its zero level set by marching.

Counterpart of ``geosplatting_tpu/graphics/dpsr.py`` (``point_rasterize``,
``dpsr_solve``, ``psr_to_mesh``), on ``torch.fft`` (complex64 from float32,
as ``jnp.fft``). Gradients reach the points and normals through the splat,
the FFTs and the marching.
"""
from __future__ import annotations

import math

import torch

from .marching import marching_cubes
from .mesh import TriangleMesh


def point_rasterize(points: torch.Tensor, values: torch.Tensor, resolution: int) -> torch.Tensor:
    """Trilinear scatter of per-point ``values`` [N, C] at ``points`` [N, 3]
    in [0, 1)^3 onto a grid [R, R, R, C] (indexed x, y, z)."""
    r = resolution
    g = points.clamp(0.0, 1.0 - 1e-6) * r - 0.5
    g0f = torch.floor(g)
    frac = g - g0f
    g0 = g0f.long()
    out = values.new_zeros((r * r * r, values.shape[-1]))
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                w = ((frac[:, 0] if dx else 1 - frac[:, 0])
                     * (frac[:, 1] if dy else 1 - frac[:, 1])
                     * (frac[:, 2] if dz else 1 - frac[:, 2]))
                xi = (g0[:, 0] + dx).clamp(0, r - 1)
                yi = (g0[:, 1] + dy).clamp(0, r - 1)
                zi = (g0[:, 2] + dz).clamp(0, r - 1)
                out = out.index_add(0, (xi * r + yi) * r + zi, values * w[:, None])
    return out.reshape(r, r, r, -1)


def dpsr_solve(points: torch.Tensor, normals: torch.Tensor, *, resolution: int = 128,
               sigma: float = 2.0) -> torch.Tensor:
    """The screened-Poisson indicator field chi [R, R, R], smoothed by a
    Gaussian of ``sigma`` (at 128 cells), its mean removed and scaled to a
    largest magnitude of 1 (the surface near its zero level)."""
    r = resolution
    v = point_rasterize(points, normals, r)
    freqs = torch.fft.fftfreq(r, device=points.device)
    kx, ky, kz = torch.meshgrid(freqs, freqs, freqs, indexing="ij")
    v_hat = torch.fft.fftn(v, dim=(0, 1, 2))
    k2 = kx ** 2 + ky ** 2 + kz ** 2
    smooth = torch.exp(-2.0 * (math.pi * sigma) ** 2 * k2 / (r / 128.0) ** 2)
    # the divergence over the Laplacian, in Fourier: i k . v_hat / -|2 pi k|^2
    ik_dot_v = (kx * v_hat[..., 0] + ky * v_hat[..., 1] + kz * v_hat[..., 2]) * (2j * math.pi)
    denom = -(2 * math.pi) ** 2 * k2
    denom = torch.where(denom.abs() < 1e-12, torch.ones_like(denom), denom)
    chi_hat = torch.where(k2 > 0, ik_dot_v / denom, torch.zeros_like(ik_dot_v)) * smooth
    chi = torch.fft.ifftn(chi_hat, dim=(0, 1, 2)).real
    chi = chi - chi.mean()
    return chi / torch.clamp(chi.abs().max(), min=1e-8)


def psr_to_mesh(points: torch.Tensor, normals: torch.Tensor, *, resolution: int = 64,
                sigma: float = 2.0, scale: float = 1.0) -> TriangleMesh:
    """The surface of ``dpsr_solve``'s field (chi > 0 inside) as a padded
    mesh over [-scale, scale]^3."""
    chi = dpsr_solve(points, normals, resolution=resolution, sigma=sigma)
    grid_r = resolution - 1
    return marching_cubes(-chi[:grid_r + 1, :grid_r + 1, :grid_r + 1], grid_r, scale)
