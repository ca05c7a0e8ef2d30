"""Spherical Gaussians: evaluation, integrals, products, a cosine-lobe
irradiance fit, a GGX lobe as an SG, fitting lobes to a cubemap, and the SG
environment texture.

Counterpart of ``geosplatting_tpu/graphics/sg.py`` (``SphericalGaussians``,
``random_sg``, ``fit_sg_to_cubemap``, ``sg_brdf_lobe``, ``TextureSG``).
The fit runs ``torch.optim.Adam`` (the optimizer under the port's
``train/optim.py``; optax's Adam with the same defaults in the JAX
package). Random lobes come from a ``torch.Generator`` where the JAX
package splits a key, or are given (``fit_sg_to_cubemap``'s ``init``);
``TextureSG.integral``'s per-point ``vmap`` is one broadcast here.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import gmath

# the clamped cosine as one SG: sharpness and amplitude of the standard fit
_COS_SHARPNESS = 2.133
_COS_AMPLITUDE = 1.17


def _cosine_integral(axis, sharpness, amplitude, normal):
    """Sum over lobes [M|1, N, .] of each lobe times the clamped cosine
    about ``normal`` [M, 3] (the cosine as an SG, the SG inner product in
    closed form). [M, 3]."""
    lam_sum = sharpness + _COS_SHARPNESS
    um = sharpness * axis + _COS_SHARPNESS * normal[:, None, :]
    dm = torch.sqrt((um * um).sum(-1, keepdim=True) + 1e-12)
    expo = torch.exp(dm - lam_sum)
    return (amplitude * _COS_AMPLITUDE * 2 * math.pi * expo * (1 - torch.exp(-2 * dm))
            / torch.clamp(dm, min=1e-8)).sum(1)


class SphericalGaussians(NamedTuple):
    axis: torch.Tensor        # [N, 3] unit lobe axes
    sharpness: torch.Tensor   # [N, 1]
    amplitude: torch.Tensor   # [N, 3]

    def evaluate(self, dirs: torch.Tensor) -> torch.Tensor:
        """The sum of the lobes at unit ``dirs`` [..., 3] -> [..., 3]."""
        cos = torch.einsum("...d,nd->...n", dirs, self.axis)
        w = torch.exp(self.sharpness[:, 0] * (cos - 1.0))
        return torch.einsum("...n,nc->...c", w, self.amplitude)

    def integral(self) -> torch.Tensor:
        """Each lobe's integral over the sphere. [N, 3]."""
        lam = self.sharpness
        return self.amplitude * 2 * math.pi / lam * (1 - torch.exp(-2 * lam))

    def product(self, other: "SphericalGaussians") -> "SphericalGaussians":
        """The lobe-by-lobe product of two sets."""
        lam = self.sharpness + other.sharpness
        um = (self.sharpness * self.axis + other.sharpness * other.axis) / torch.clamp(lam,
                                                                                      min=1e-8)
        norm = torch.sqrt((um * um).sum(-1, keepdim=True) + 1e-12)
        new_sharp = lam * norm
        return SphericalGaussians(axis=um / norm, sharpness=new_sharp,
                                  amplitude=self.amplitude * other.amplitude
                                  * torch.exp(new_sharp - lam))

    def inner_product(self, other: "SphericalGaussians") -> torch.Tensor:
        """The integral of the product over the sphere, summed over every
        pair of lobes. [3]."""
        lam_sum = self.sharpness[:, None] + other.sharpness[None, :]
        um = (self.sharpness[:, None] * self.axis[:, None]
              + other.sharpness[None, :] * other.axis[None, :])
        dm = torch.sqrt((um * um).sum(-1, keepdim=True) + 1e-12)
        expo = torch.exp(dm - lam_sum)
        return (self.amplitude[:, None] * other.amplitude[None, :] * 2 * math.pi
                * expo * (1 - torch.exp(-2 * dm)) / torch.clamp(dm, min=1e-8)).sum((0, 1))

    def cosine_integral(self, normal: torch.Tensor) -> torch.Tensor:
        """The lobes times the clamped cosine about each ``normal`` [..., 3],
        integrated and summed over the lobes. [..., 3]."""
        n = normal.reshape(-1, 3)
        out = _cosine_integral(self.axis[None], self.sharpness[None], self.amplitude[None], n)
        return out.reshape(normal.shape[:-1] + (3,))


def random_sg(num: int, *, generator: torch.Generator | None = None,
              device=None) -> SphericalGaussians:
    """Lobes about normalised normal axes, sharpness in [4, 30), amplitude
    in [0.1, 1)."""
    kw = dict(generator=generator, device=device)
    return SphericalGaussians(
        axis=gmath.safe_normalize(torch.randn((num, 3), **kw)),
        sharpness=torch.rand((num, 1), **kw) * 26.0 + 4.0,
        amplitude=torch.rand((num, 3), **kw) * 0.9 + 0.1,
    )


def fit_sg_to_cubemap(cube: torch.Tensor, num_gaussians: int, *,
                      generator: torch.Generator | None = None,
                      init: SphericalGaussians | None = None,
                      num_steps: int = 400, lr: float = 0.1) -> SphericalGaussians:
    """``num_gaussians`` lobes fitted to a cubemap [6, R, R, 3] by Adam on
    the mean L1 error over its texel directions, from ``init`` (else
    ``random_sg`` from ``generator``), in (axis, log sharpness, log
    amplitude)."""
    from ..ops.cubemap import texel_directions

    dirs = texel_directions(cube.shape[1], cube.device).reshape(-1, 3)
    target = cube.detach().reshape(-1, 3)
    sg0 = init if init is not None else random_sg(num_gaussians, generator=generator,
                                                  device=cube.device)
    axis = sg0.axis.detach().clone().requires_grad_(True)
    log_sharp = torch.log(sg0.sharpness).detach().clone().requires_grad_(True)
    log_amp = torch.log(sg0.amplitude).detach().clone().requires_grad_(True)
    opt = torch.optim.Adam([axis, log_sharp, log_amp], lr=lr, eps=1e-8, foreach=False)

    def build():
        return SphericalGaussians(axis=gmath.safe_normalize(axis),
                                  sharpness=torch.exp(log_sharp), amplitude=torch.exp(log_amp))

    with torch.enable_grad():
        for _ in range(num_steps):
            opt.zero_grad()
            loss = (build().evaluate(dirs) - target).abs().mean()
            loss.backward()
            opt.step()
    with torch.no_grad():
        return SphericalGaussians(*(x.detach() for x in build()))


def sg_brdf_lobe(normals: torch.Tensor, wo: torch.Tensor, roughness: torch.Tensor
                 ) -> SphericalGaussians:
    """The GGX distribution as an SG about the reflected view direction,
    warped by 4 N.V."""
    alpha2 = torch.clamp(roughness ** 4, min=1e-6)
    n_dot_v = torch.clamp((normals * wo).sum(-1, keepdim=True), min=1e-4)
    refl = 2.0 * n_dot_v * normals - wo
    return SphericalGaussians(
        axis=gmath.safe_normalize(refl), sharpness=2.0 / alpha2 / (4.0 * n_dot_v),
        amplitude=(1.0 / (math.pi * alpha2)).expand(normals.shape[:-1] + (3,)))


class TextureSG(NamedTuple):
    """An SG environment, its parameters stored before their activations:
    raw axes, log sharpness and log amplitude."""

    axis: torch.Tensor        # [K, 3]
    sharpness: torch.Tensor   # [K, 1] log
    amplitude: torch.Tensor   # [K, 3] log

    @classmethod
    def from_random(cls, num_gaussians: int, *, generator: torch.Generator | None = None,
                    device=None) -> "TextureSG":
        kw = dict(generator=generator, device=device)
        return cls(axis=torch.randn((num_gaussians, 3), **kw),
                   sharpness=3.0 + torch.randn((num_gaussians, 1), **kw) / 3.0,
                   amplitude=torch.randn((num_gaussians, 3), **kw) / 3.0 - 2.0)

    @classmethod
    def from_cubemap(cls, cube: torch.Tensor, num_gaussians: int, **kw) -> "TextureSG":
        sg = fit_sg_to_cubemap(cube, num_gaussians, **kw)
        return cls(axis=sg.axis, sharpness=torch.log(sg.sharpness),
                   amplitude=torch.log(torch.clamp(sg.amplitude, min=1e-8)))

    def as_sg(self) -> SphericalGaussians:
        return SphericalGaussians(axis=gmath.safe_normalize(self.axis),
                                  sharpness=torch.exp(self.sharpness),
                                  amplitude=torch.exp(self.amplitude))

    def sample(self, directions: torch.Tensor) -> torch.Tensor:
        return self.as_sg().evaluate(directions)

    def visualize(self, *, width: int = 800, height: int = 400) -> torch.Tensor:
        """A lat-long radiance image [H, W, 3]."""
        dev = self.axis.device
        gy = (torch.arange(height, device=dev) + 0.5) / height * math.pi
        gx = ((torch.arange(width, device=dev) + 0.5) / width * 2.0 - 1.0) * math.pi
        theta, phi = torch.meshgrid(gy, gx, indexing="ij")
        sin_t = torch.sin(theta)
        return self.sample(torch.stack((sin_t * torch.sin(phi), torch.cos(theta),
                                        -sin_t * torch.cos(phi)), -1))

    def integral(self, normals: torch.Tensor, wo: torch.Tensor, *, albedo: torch.Tensor,
                 roughness: torch.Tensor, metallic: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
        """(diffuse, specular) shading of M points [M, 3] each: the light
        lobes times each point's GGX lobe, integrated against its cosine,
        with Schlick's Fresnel and Smith's shadowing."""
        light = self.as_sg()
        spec = sg_brdf_lobe(normals, wo, roughness)
        new_half = gmath.safe_normalize(spec.axis + wo)
        v_dot_h = torch.clamp((wo * new_half).sum(-1, keepdim=True), min=1e-4)
        f0 = 0.04 * (1 - metallic) + metallic * albedo
        fres = f0 + (1.0 - f0) * 2.0 ** (-(5.55473 * v_dot_h + 6.8316) * v_dot_h)
        n_dot_v = torch.clamp((normals * wo).sum(-1, keepdim=True), min=1e-4)
        n_dot_l = torch.clamp((spec.axis * normals).sum(-1, keepdim=True), min=1e-4)
        k = roughness ** 2 / 2.0
        g1 = n_dot_v / (n_dot_v * (1 - k) + k + 1e-6)
        g2 = n_dot_l / (n_dot_l * (1 - k) + k + 1e-6)
        moi = fres * g1 * g2 / (4 * n_dot_v * n_dot_l + 1e-6)
        # each point's lobe times every light lobe: [M, K, .]
        lam = light.sharpness[None] + spec.sharpness[:, None]
        um = (light.sharpness * light.axis)[None] + (spec.sharpness * spec.axis)[:, None]
        um = um / torch.clamp(lam, min=1e-8)
        norm = torch.sqrt((um * um).sum(-1, keepdim=True) + 1e-12)
        amp = light.amplitude[None] * spec.amplitude[:, None] * torch.exp(lam * norm - lam)
        spec_term = _cosine_integral(um / norm, lam * norm, amp, normals)
        diff_term = _cosine_integral(light.axis[None], light.sharpness[None],
                                     light.amplitude[None], normals)
        return diff_term * (albedo / math.pi), spec_term * moi
