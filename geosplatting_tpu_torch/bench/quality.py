"""A synthetic PBR scene whose geometry, albedo, roughness and lighting are
known exactly: the dataset of the quality benchmark.

Counterpart of ``geosplatting_tpu/bench/quality.py``, with the same
constants. Two spheres inside the [-1, 1]^3 reconstruction box, hit by
exact ray-sphere intersection and shadowed by exact binary shadow rays; the
ground-truth views (under the training environment and under a held-out
one for relighting) go through ``ops.envshade.env_shade``, the estimator
stages 2 and 3 train with, at a high sample count.

Scene:
  - sphere A: centre (0, 0, -0.12), radius 0.42, a checkered two-tone
    albedo, roughness 0.65
  - sphere B: centre (0.28, 0.3, 0.38), radius 0.22, a warm constant
    albedo, roughness 0.18
  - train environment: ambient + a warm key blob + a cool rim blob
  - relight environment: ambient + two blobs from opposite directions

Randomness: ``render_gt_views`` takes each view's ``ShadeDraws`` or a
``torch.Generator`` to draw them from. The tensor entry points run on the
card unless ``device`` names another device.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import _kernels
from ..graphics import images as gimages
from ..graphics.cameras import Cameras
from ..ops import envshade as es

SPHERE_CENTERS = np.array([[0.0, 0.0, -0.12], [0.28, 0.30, 0.38]], np.float32)
SPHERE_RADII = np.array([0.42, 0.22], np.float32)
ROUGHNESS = np.array([0.65, 0.18], np.float32)
KD_A1 = np.array([0.70, 0.25, 0.20], np.float32)
KD_A2 = np.array([0.20, 0.45, 0.70], np.float32)
KD_B = np.array([0.75, 0.60, 0.25], np.float32)


def _const(x: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


def _intersect_sphere(origins, dirs, center, radius) -> torch.Tensor:
    """Smallest positive t, +inf on a miss. origins / dirs [..., 3]."""
    oc = origins - _const(center, origins)
    b = (oc * dirs).sum(-1)
    c = (oc * oc).sum(-1) - float(radius) * float(radius)
    disc = b * b - c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t0 = -b - sq
    t1 = -b + sq
    t = torch.where(t0 > 1e-4, t0, t1)
    return torch.where((disc > 0) & (t > 1e-4), t, torch.inf)


def scene_hit(origins: torch.Tensor, dirs: torch.Tensor):
    """(hit, pos, normal, obj) for the closer of the two spheres."""
    ts = torch.stack([_intersect_sphere(origins, dirs, SPHERE_CENTERS[i], SPHERE_RADII[i])
                      for i in range(2)], -1)
    obj = (ts[..., 1] < ts[..., 0]).long()    # argmin, the first on a tie
    t = torch.minimum(ts[..., 0], ts[..., 1])
    hit = torch.isfinite(t)
    t_safe = torch.where(hit, t, 2.0)
    pos = origins + dirs * t_safe[..., None]
    center = _const(SPHERE_CENTERS, pos)[obj]
    radius = _const(SPHERE_RADII, pos)[obj]
    normal = (pos - center) / radius[..., None]
    return hit, pos, normal, obj


def scene_kd(pos: torch.Tensor, obj: torch.Tensor) -> torch.Tensor:
    """Linear-space albedo at surface points."""
    checker = (torch.sin(9.0 * pos[..., 0]) * torch.sin(9.0 * pos[..., 1])
               * torch.sin(9.0 * pos[..., 2])) > 0
    kd_a = torch.where(checker[..., None], _const(KD_A1, pos), _const(KD_A2, pos))
    return torch.where((obj == 0)[..., None], kd_a, _const(KD_B, pos))


def scene_roughness(obj: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(ROUGHNESS, device=obj.device)[obj]


def visibility(origins: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Exact binary shadow rays against both spheres ([M] in {0, 1})."""
    blocked = torch.zeros(origins.shape[:-1], dtype=torch.bool, device=origins.device)
    for i in range(2):
        t = _intersect_sphere(origins, dirs, SPHERE_CENTERS[i], SPHERE_RADII[i])
        blocked = blocked | torch.isfinite(t)
    return 1.0 - blocked.float()


def _blob(dirs, center_dir, sharpness, color) -> torch.Tensor:
    c = _const(np.asarray(center_dir, np.float32), dirs)
    c = c / float(np.linalg.norm(np.asarray(center_dir)))
    cos = (dirs * c).sum(-1, keepdim=True)
    return _const(np.asarray(color, np.float32), dirs) * torch.exp(sharpness * (cos - 1.0))


def make_envmap(h: int = 64, w: int = 128, kind: str = "train",
                device: str | torch.device | None = None) -> torch.Tensor:
    """Procedural HDR lat-long environment [h, w, 3] (linear radiance)."""
    device = _kernels.resolve_device(device)
    u = (torch.arange(w, device=device) + 0.5) / w
    v = (torch.arange(h, device=device) + 0.5) / h
    uv = torch.stack(torch.meshgrid(u, v, indexing="xy"), -1)
    dirs = es._tc_to_dir(uv)
    if kind == "train":
        env = (0.22 + _blob(dirs, [0.5, 0.8, 0.3], 28.0, [9.0, 7.5, 5.5])
               + _blob(dirs, [-0.7, 0.2, -0.5], 10.0, [0.6, 0.9, 1.5]))
    elif kind == "relight":
        env = (0.15 + _blob(dirs, [-0.4, 0.7, 0.55], 32.0, [4.0, 8.0, 10.0])
               + _blob(dirs, [0.8, 0.1, -0.55], 14.0, [2.2, 1.0, 0.5]))
    else:
        raise ValueError(kind)
    return env.expand(h, w, 3).float().contiguous()


def _view_rays(cam: Cameras) -> tuple[torch.Tensor, torch.Tensor]:
    origins, dirs = cam.generate_rays()
    return origins.reshape(-1, 3), dirs.reshape(-1, 3)


@torch.no_grad()
def _render_gt_one(cam: Cameras, env: torch.Tensor, draws: es.ShadeDraws,
                   shadows: bool) -> torch.Tensor:
    o, d = _view_rays(cam)
    hit, pos, normal, obj = scene_hit(o, d)
    kd = scene_kd(pos, obj)
    rough = scene_roughness(obj)
    arm = torch.stack((torch.zeros_like(rough), rough, torch.zeros_like(rough)), -1)
    diff, spec, _ = es.env_shade(
        pos, normal, cam.c2w[:, 3], kd, arm, es.compute_light_pdf(env), draws,
        visibility_fn=visibility if shadows else None, shadow_scale=1.0 if shadows else 0.0,
    )
    rgb = diff * kd + spec                      # metallic = 0
    a = hit.float()[..., None]
    srgb = gimages.rgb2srgb(torch.clamp(rgb, 0.0, 1.0)) * a
    return torch.cat((srgb, a), -1).reshape(cam.height, cam.width, 4)


def render_gt_views(cams: Cameras, env: torch.Tensor, generator: torch.Generator | None = None,
                    spp_x: int = 16, shadows: bool = True,
                    draws: list[es.ShadeDraws] | None = None) -> torch.Tensor:
    """[B, H, W, 4] sRGB premultiplied ground-truth views (the dataset's
    images): view i shades with ``draws[i]`` when given, else with
    ``spp_x`` x ``spp_x`` sample steps drawn from ``generator``."""
    outs = []
    for i in range(len(cams)):
        cam = cams[i]
        d = draws[i].to(cams.device) if draws is not None else es.draw_shade(
            cam.width * cam.height, num_samples_x=spp_x, generator=generator,
            device=cams.device)
        outs.append(_render_gt_one(cam, env, d, shadows))
    return torch.stack(outs)


@torch.no_grad()
def gt_material_maps(cams: Cameras) -> tuple[torch.Tensor, torch.Tensor]:
    """([B, H, W, 4] sRGB albedo, [B, H, W, 2] (roughness, alpha)) maps."""
    albedos, roughs = [], []
    for i in range(len(cams)):
        cam = cams[i]
        hw = (cam.height, cam.width)
        hit, pos, _, obj = scene_hit(*_view_rays(cam))
        a = hit.float()[..., None]
        kd = gimages.rgb2srgb(torch.clamp(scene_kd(pos, obj), 0, 1)) * a
        albedos.append(torch.cat((kd, a), -1).reshape(hw + (4,)))
        roughs.append(torch.cat((scene_roughness(obj)[..., None] * a, a), -1).reshape(hw + (2,)))
    return torch.stack(albedos), torch.stack(roughs)


def make_cameras(kind: str, n: int, *, width: int, height: int,
                 device: str | torch.device | None = None) -> Cameras:
    """The train orbits (n - n // 2 at 10 degrees of elevation, n // 2 at
    42) or the test orbit (26 degrees, between the train views)."""
    device = _kernels.resolve_device(device)
    orbit = dict(center=torch.zeros(3), radius=2.2, width=width, height=height, device=device)
    if kind == "train":
        lo = Cameras.from_orbit(elevation_degrees=10.0, num_samples=n - n // 2, **orbit)
        hi = Cameras.from_orbit(elevation_degrees=42.0, num_samples=n // 2, **orbit)
        return Cameras.cat([lo, hi])
    if kind == "test":
        cams = Cameras.from_orbit(elevation_degrees=26.0, num_samples=2 * n, **orbit)
        # the odd samples: a phase between the train orbits' views
        return cams[torch.arange(n, device=device) * 2 + 1]
    raise ValueError(kind)

