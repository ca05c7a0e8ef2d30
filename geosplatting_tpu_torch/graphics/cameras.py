"""Pinhole cameras with the reference's coordinate conventions.

Counterpart of ``geosplatting_tpu/graphics/cameras.py``: ``c2w`` is an
OpenGL-style camera-to-world [..., 3, 4] (camera looks down -z, y up);
``view_matrix`` flips y/z to the rasterizer convention (+z forward, y down);
``projection_matrix`` is the OpenGL frustum over that view space and
``resize`` scales the intrinsics to a new image size. A plain dataclass of
tensors; width/height/near/far are Python numbers.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from .. import _kernels
from . import gmath


@dataclasses.dataclass
class Cameras:
    c2w: torch.Tensor  # [..., 3, 4]
    fx: torch.Tensor   # [...]
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    width: int = 800
    height: int = 800
    near: float = 0.01
    far: float = 1e3

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self.c2w.shape[:-2])

    @property
    def device(self) -> torch.device:
        return self.c2w.device

    def __len__(self) -> int:
        return self.shape[0]

    def __getitem__(self, idx) -> "Cameras":
        return dataclasses.replace(
            self, c2w=self.c2w[idx], fx=self.fx[idx], fy=self.fy[idx],
            cx=self.cx[idx], cy=self.cy[idx],
        )

    @classmethod
    def cat(cls, items: list["Cameras"]) -> "Cameras":
        """Batches of cameras concatenated; image size and clip planes are
        the first item's."""
        def join(name):
            return torch.cat([getattr(c, name) for c in items])

        return dataclasses.replace(items[0], c2w=join("c2w"), fx=join("fx"), fy=join("fy"),
                                   cx=join("cx"), cy=join("cy"))

    def to(self, device) -> "Cameras":
        return dataclasses.replace(
            self, c2w=self.c2w.to(device), fx=self.fx.to(device),
            fy=self.fy.to(device), cx=self.cx.to(device), cy=self.cy.to(device),
        )

    # ---- constructors ------------------------------------------------------
    @classmethod
    def from_lookat(
        cls,
        eye: torch.Tensor,
        target: torch.Tensor,
        up: torch.Tensor | None = None,
        *,
        fov_degrees: float = 60.0,
        width: int = 800,
        height: int = 800,
        near: float = 0.01,
        far: float = 1e3,
    ) -> "Cameras":
        eye = torch.as_tensor(eye, dtype=torch.float32)
        target = torch.as_tensor(target, dtype=torch.float32, device=eye.device)
        if up is None:
            up = torch.tensor([0.0, 0.0, 1.0], device=eye.device)
        up = torch.as_tensor(up, dtype=torch.float32, device=eye.device).expand(eye.shape)
        forward = gmath.safe_normalize(target - eye)  # camera -z
        right = gmath.safe_normalize(torch.cross(forward, up, dim=-1))
        true_up = torch.cross(right, forward, dim=-1)
        rot = torch.stack((right, true_up, -forward), dim=-1)  # columns
        c2w = torch.cat((rot, eye[..., :, None]), dim=-1)
        focal = torch.tensor(
            0.5 * height / math.tan(math.radians(fov_degrees) * 0.5),
            dtype=torch.float32, device=eye.device,
        )
        bs = eye.shape[:-1]
        return cls(
            c2w=c2w,
            fx=focal.expand(bs).clone(),
            fy=focal.expand(bs).clone(),
            cx=torch.full(bs, width / 2.0, device=eye.device),
            cy=torch.full(bs, height / 2.0, device=eye.device),
            width=width, height=height, near=near, far=far,
        )

    @classmethod
    def from_orbit(
        cls,
        *,
        center,
        radius: float,
        elevation_degrees: float,
        num_samples: int,
        device: str | torch.device | None = None,
        **kwargs,
    ) -> "Cameras":
        """Cameras on a circle around ``center``; on the card unless
        ``device`` names another device (raises without one)."""
        device = _kernels.resolve_device(device)
        center = torch.as_tensor(center, dtype=torch.float32, device=device)
        phi = torch.arange(num_samples, dtype=torch.float32, device=device) * (
            2.0 * math.pi / num_samples
        )
        el = torch.tensor(math.radians(elevation_degrees), device=device)
        eye = center + radius * torch.stack(
            (
                torch.cos(el) * torch.cos(phi),
                torch.cos(el) * torch.sin(phi),
                torch.sin(el).expand_as(phi),
            ),
            dim=-1,
        )
        return cls.from_lookat(eye, center.expand(eye.shape), **kwargs)

    @classmethod
    def from_sphere(
        cls,
        *,
        center,
        radius: float,
        num_samples: int,
        generator: torch.Generator | None = None,
        directions: torch.Tensor | None = None,
        device: str | torch.device | None = None,
        **kwargs,
    ) -> "Cameras":
        """Cameras at uniform random directions ``radius`` from ``center``,
        looking at it: ``gmath.sample_sphere`` from ``generator``, or the
        unit ``directions`` [num_samples, 3] given. On the card unless
        ``device`` names another device."""
        device = _kernels.resolve_device(device)
        if directions is None:
            directions = gmath.sample_sphere((num_samples,), generator=generator, device=device)
        return cls._looking_at(center, radius, directions.to(device), **kwargs)

    @classmethod
    def from_hemisphere(
        cls,
        *,
        center,
        radius: float,
        num_samples: int,
        generator: torch.Generator | None = None,
        directions: torch.Tensor | None = None,
        device: str | torch.device | None = None,
        **kwargs,
    ) -> "Cameras":
        """``from_sphere`` with every direction folded to z >= 0."""
        device = _kernels.resolve_device(device)
        if directions is None:
            directions = gmath.sample_sphere((num_samples,), generator=generator, device=device)
        d = directions.to(device)
        d = torch.cat((d[:, :2], d[:, 2:].abs()), -1)
        return cls._looking_at(center, radius, d, **kwargs)

    @classmethod
    def _looking_at(cls, center, radius: float, directions: torch.Tensor, **kwargs):
        center = torch.as_tensor(center, dtype=torch.float32, device=directions.device)
        eye = center + radius * directions
        return cls.from_lookat(eye, center.expand(eye.shape), **kwargs)

    # ---- matrices -----------------------------------------------------------
    @property
    def intrinsic_matrix(self) -> torch.Tensor:
        z = torch.zeros_like(self.fx)
        o = torch.ones_like(self.fx)
        k = torch.stack((self.fx, z, self.cx, z, self.fy, self.cy, z, z, o), dim=-1)
        return k.reshape(self.shape + (3, 3))

    @property
    def view_matrix(self) -> torch.Tensor:
        """World-to-camera [..., 4, 4] in +z-forward/y-down convention."""
        flip = torch.tensor([1.0, -1.0, -1.0], device=self.c2w.device)
        r = self.c2w[..., :3, :3] * flip
        t = self.c2w[..., :3, 3:4]
        r_inv = r.transpose(-1, -2)
        t_inv = -r_inv @ t
        top = torch.cat((r_inv, t_inv), dim=-1)
        bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], device=self.c2w.device).expand(
            self.shape + (1, 4)
        )
        return torch.cat((top, bottom), dim=-2)

    @property
    def projection_matrix(self) -> torch.Tensor:
        """OpenGL-style frustum [..., 4, 4] over the +z-forward view space."""
        n, f = self.near, self.far
        t = self.cy * (n / self.fy)
        b = (self.cy - self.height) * (n / self.fy)
        r = self.cx * (n / self.fx)
        l = (self.cx - self.width) * (n / self.fx)  # noqa: E741
        zeros = torch.zeros_like(self.fx)
        rows = torch.stack((
            2 * n / (r - l), zeros, (r + l) / (r - l), zeros,
            zeros, 2 * n / (t - b), (t + b) / (t - b), zeros,
            zeros, zeros, torch.full_like(self.fx, (f + n) / (f - n)),
            torch.full_like(self.fx, -2 * f * n / (f - n)),
            zeros, zeros, torch.ones_like(self.fx), zeros,
        ), dim=-1)
        return rows.reshape(self.shape + (4, 4))

    @property
    def camera_pos(self) -> torch.Tensor:
        return self.c2w[..., :3, 3]

    # ---- rays ---------------------------------------------------------------
    def generate_rays(self) -> tuple[torch.Tensor, torch.Tensor]:
        """Per-pixel world-space ray (origins, directions), [..., H, W, 3]."""
        dev = self.c2w.device
        xs = torch.arange(self.width, dtype=torch.float32, device=dev) + 0.5
        ys = torch.arange(self.height, dtype=torch.float32, device=dev) + 0.5
        py, px = torch.meshgrid(ys, xs, indexing="ij")  # [H, W]
        shp = self.shape

        def expand(v):
            return v.reshape(shp + (1, 1))

        dx = (px - expand(self.cx)) / expand(self.fx)
        dy = (py - expand(self.cy)) / expand(self.fy)
        # OpenGL camera: x right, y up, looking -z => flip image-space y
        d_cam = torch.stack((dx, -dy, -torch.ones_like(dx)), dim=-1)
        rot = self.c2w[..., :3, :3].reshape(shp + (1, 1, 3, 3))
        d_world = gmath.safe_normalize((rot @ d_cam[..., None])[..., 0])
        origins = self.c2w[..., :3, 3].reshape(shp + (1, 1, 3)).expand(d_world.shape)
        return origins, d_world

    def resize(self, width: int, height: int) -> "Cameras":
        """The same cameras at ``width`` x ``height``: fx, cx scaled by the
        width's ratio, fy, cy by the height's."""
        sx = width / self.width
        sy = height / self.height
        return dataclasses.replace(self, fx=self.fx * sx, fy=self.fy * sy, cx=self.cx * sx,
                                   cy=self.cy * sy, width=width, height=height)
