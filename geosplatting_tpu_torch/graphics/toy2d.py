"""The 2D toy: flatland cameras and analytic circle scenes whose views are
1-D rgba rows, where every quantity of a splatting or ray-marching idea can
be plotted.

Counterpart of ``geosplatting_tpu/graphics/toy2d.py`` (``shading2d``,
``Cameras2D``, ``CircleShape2D``), as dataclasses of tensors. Random
circles come from a ``torch.Generator`` where the JAX package splits a key.
"""
from __future__ import annotations

import dataclasses
import math

import torch


def shading2d(x: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """A position [..., 2] -> its RGB [..., 3]."""
    colors = torch.clamp(x / (2 * scale) + 0.5, 0.0, 1.0)
    return torch.cat((colors, 1.0 - colors[..., 0:1] * colors[..., 1:2]), -1)


@dataclasses.dataclass
class Cameras2D:
    c2w: torch.Tensor     # [..., 2, 3]: rotation (2 x 2) | position
    focal: torch.Tensor   # [...]
    width: int = 800
    near: float = 1e-3
    far: float = 1e3

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self.c2w.shape[:-2])

    def __len__(self) -> int:
        return self.shape[0]

    def __getitem__(self, idx) -> "Cameras2D":
        return dataclasses.replace(self, c2w=self.c2w[idx], focal=self.focal[idx])

    @classmethod
    def from_lookat(cls, eye: torch.Tensor, target: torch.Tensor, *, width: int = 800,
                    hfov_degrees: float = 90.0, near: float = 1e-3, far: float = 1e3
                    ) -> "Cameras2D":
        eye = torch.as_tensor(eye, dtype=torch.float32)
        target = torch.as_tensor(target, dtype=torch.float32, device=eye.device).expand(eye.shape)
        fwd = target - eye
        fwd = fwd / torch.linalg.norm(fwd, dim=-1, keepdim=True).clamp(min=1e-8)
        right = torch.stack((fwd[..., 1], -fwd[..., 0]), -1)
        # columns: right | backward (the camera looks down its -y) | eye
        c2w = torch.cat((torch.stack((right, -fwd), -1), eye[..., None]), -1)
        focal = torch.tensor(0.5 * width / math.tan(math.radians(hfov_degrees) / 2.0),
                             dtype=torch.float32, device=eye.device)
        return cls(c2w=c2w, focal=focal.expand(eye.shape[:-1]).clone(), width=width,
                   near=near, far=far)

    @classmethod
    def from_orbit(cls, *, center=(0.0, 0.0), radius: float = 1.0, num_samples: int = 8,
                   device=None, **kwargs) -> "Cameras2D":
        center = torch.as_tensor(center, dtype=torch.float32, device=device)
        phi = torch.arange(num_samples, dtype=torch.float32, device=device) * (
            2.0 * math.pi / num_samples)
        eye = center + radius * torch.stack((torch.cos(phi), torch.sin(phi)), -1)
        return cls.from_lookat(eye, center.expand(eye.shape), **kwargs)

    def generate_rays(self) -> tuple[torch.Tensor, torch.Tensor]:
        """Per-pixel rays: (origins [..., W, 2], unit directions [..., W, 2])."""
        dev = self.c2w.device
        shp = self.shape
        xs = torch.arange(self.width, dtype=torch.float32, device=dev) + 0.5 - self.width / 2.0
        d_cam = torch.stack((xs.expand(shp + (self.width,)),
                             -self.focal[..., None].expand(shp + (self.width,))), -1)
        rot = self.c2w[..., :2, :2].reshape(shp + (1, 2, 2))
        d_world = (rot @ d_cam[..., None])[..., 0]
        d_world = d_world / torch.linalg.norm(d_world, dim=-1, keepdim=True).clamp(min=1e-8)
        origins = self.c2w[..., :2, 2].reshape(shp + (1, 2)).expand(d_world.shape)
        return origins, d_world


@dataclasses.dataclass
class CircleShape2D:
    origins: torch.Tensor   # [C, 2]
    radius: torch.Tensor    # [C, 1]

    @classmethod
    def random(cls, size: int, *, generator: torch.Generator | None = None,
               device=None) -> "CircleShape2D":
        """Radii in [0.1, 0.3), centres uniform in the box that keeps each
        circle 0.8 (1 - r) from the origin's axes."""
        radius = torch.rand((size, 1), generator=generator, device=device) * 0.2 + 0.1
        u = torch.rand((size, 2), generator=generator, device=device)
        return cls(origins=(u * 2 - 1) * ((1 - radius) * 0.8), radius=radius)

    def render(self, cameras: Cameras2D) -> torch.Tensor:
        """The closest hit of each pixel's ray, shaded by its position:
        rgba [..., W, 4] (alpha 1 on a hit)."""
        o, d = cameras.generate_rays()                                 # [..., W, 2]
        oc = o[..., None, :, :] - self.origins[:, None, :]             # [..., C, W, 2]
        b = 2.0 * (d[..., None, :, :] * oc).sum(-1)
        c = (oc * oc).sum(-1) - (self.radius ** 2)[..., :1]
        disc = b * b - 4 * c
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        t1, t2 = (-b - sq) / 2.0, (-b + sq) / 2.0
        far2 = 2.0 * cameras.far
        t1 = torch.where((t1 > cameras.near) & (disc >= 0), t1, far2)
        t2 = torch.where((t2 > cameras.near) & (disc >= 0), t2, far2)
        ts = torch.minimum(t1, t2).amin(-2)[..., None]                  # [..., W, 1]
        alpha = (ts < cameras.far).float()
        return torch.cat((shading2d(o + ts * d) * alpha, alpha), -1)

    def visualize(self, *, width: int, height: int, scale: float = 1.0) -> torch.Tensor:
        """A top-down rgba [H, W, 4] view of the scene."""
        dev = self.origins.device
        xs = torch.linspace(-scale, scale, width, device=dev)
        ys = torch.linspace(-scale, scale, height, device=dev)
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        q = torch.stack((gx, gy), -1).flip(0)
        d2 = ((q - self.origins[:, None, None, :]) ** 2).sum(-1, keepdim=True)
        alpha = (d2 < (self.radius[:, None, None, :] ** 2)).any(0).float()
        return torch.cat((shading2d(q) * alpha, alpha), -1)
