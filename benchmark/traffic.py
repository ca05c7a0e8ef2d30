"""The benchmark's one traffic generator: every input of a run, from its seed.

A cell's traffic is the parameters in ``workloads/<cell>.json``; this module
turns them and ``--seed`` into tensors on the device, the same for the same
seed, and hands the same tensors to the program and to the reference:

- the views: ``views`` orbit cameras (``orbit``: radius, elevation) at
  ``resolution``², visited in an order drawn from the seed;
- the ground truth of a view: the analytic shaded sphere of radius 0.5
  (``sphere_gt``), sRGB rgba;
- per training step: the per-pixel random background, the jitter noise and
  the Monte-Carlo draws of each camera (``ShadeDraws``' four tensors);
- per relight chunk: one set of draws that every camera of the chunk shares
  (as the relight evaluation does), and once per run the relight
  environment and the albedo scaling.

Every random tensor comes from a generator on the device seeded by
``subseed(seed, index, salt)``, so a step's inputs can be made again after
the window for the reference without keeping them.
"""
from __future__ import annotations

import torch

# salts of the generators: one stream per kind of input
SALT_WEIGHTS, SALT_ORDER, SALT_STEP, SALT_CHUNK, SALT_SCENE, SALT_SAMPLE = range(6)
LIGHT_BANK = 2048   # env_shade's stratified light bank (m^2 = 45^2 directions)


def subseed(seed: int, index: int, salt: int) -> int:
    """A 63-bit seed for input stream ``salt`` at position ``index``."""
    x = (seed * 0x9E3779B97F4A7C15 + index * 0xBF58476D1CE4E5B9 + salt * 0x94D049BB133111EB)
    x ^= x >> 31
    return x % (1 << 63)


def generator(device, seed: int, index: int, salt: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(subseed(seed, index, salt))


def view_order(traffic: dict, seed: int) -> list[int]:
    g = torch.Generator().manual_seed(subseed(seed, 0, SALT_ORDER))
    return torch.randperm(traffic["views"], generator=g).tolist()


def orbit(pkg, traffic: dict, device):
    """The cell's orbit cameras, as ``pkg``'s ``Cameras``."""
    o = traffic["orbit"]
    return pkg.Cameras.from_orbit(
        center=[0.0, 0.0, 0.0], radius=o["radius"], elevation_degrees=o["elevation_degrees"],
        num_samples=traffic["views"], width=traffic["resolution"],
        height=traffic["resolution"], device=device)


def rgb2srgb(x: torch.Tensor) -> torch.Tensor:
    x = torch.clamp(x, 0.0, 1.0)
    return torch.where(x <= 0.0031308, 12.92 * x,
                       1.055 * torch.pow(torch.clamp(x, min=0.0031308), 1.0 / 2.4) - 0.055)


def sphere_gt(origins: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """sRGB rgba of a shaded sphere of radius 0.5 at the origin, seen along
    the rays (analytic hits); [..., 4]."""
    b = (origins * dirs).sum(-1)
    c = (origins * origins).sum(-1) - 0.25
    disc = b * b - c
    t = -b - torch.sqrt(torch.clamp(disc, min=0.0))
    hit = (disc > 0) & (t > 0)
    n = (origins + t[..., None] * dirs) / 0.5
    light = torch.tensor([0.577, 0.577, 0.577], device=n.device)
    shade = torch.clamp((n * light).sum(-1), 0.1, 1.0)
    rgb = torch.where(hit[..., None], shade[..., None] * 0.8, 0.0).expand(*hit.shape, 3)
    a = hit[..., None].float()
    return torch.cat((rgb2srgb(rgb) * a, a), -1)


def ground_truth(cams, views: list[int]) -> torch.Tensor:
    """[len(views), H, W, 4] ground truth of the given views."""
    out = []
    for i in views:
        o, d = cams[i:i + 1].generate_rays()
        out.append(sphere_gt(o, d)[0])
    return torch.stack(out)


def shade_draws(g: torch.Generator, num_points: int, num_samples_x: int, device) -> tuple:
    """(ub, vb, bidx, u) of one ``env_shade`` call: the layout of
    ``ShadeDraws``, drawn in four calls."""
    m2 = int(round(LIGHT_BANK ** 0.5)) ** 2
    s = num_samples_x * num_samples_x
    kw = dict(generator=g, device=device)
    return (torch.rand(m2, **kw), torch.rand(m2, **kw),
            torch.randint(0, m2, (s, num_points), **kw), torch.rand((s, num_points, 3), **kw))


def step_inputs(traffic: dict, seed: int, step: int, shapes: dict, device) -> dict:
    """Training step ``step``'s random inputs for a batch of ``traffic['batch']``
    cameras: background [B, H, W, 3], jitter noise, and per camera the
    draws' tensors."""
    g = generator(device, seed, step, SALT_STEP)
    b, r = traffic["batch"], traffic["resolution"]
    background = torch.rand((b, r, r, 3), generator=g, device=device)
    jitter = torch.randn(shapes["jitter"], generator=g, device=device)
    draws = [shade_draws(g, shapes["shade_points"], shapes["num_samples_x"], device)
             for _ in range(b)]
    return {"background": background, "jitter": jitter, "draws": draws}


def step_views(traffic: dict, order: list[int], step: int) -> list[int]:
    b, v = traffic["batch"], traffic["views"]
    return [order[(step * b + j) % v] for j in range(b)]


def chunk_views(traffic: dict, order: list[int], chunk: int) -> list[int]:
    c, v = traffic["chunk"], traffic["views"]
    return [order[(chunk * c + j) % v] for j in range(c)]


def chunk_draws(traffic: dict, seed: int, chunk: int, shapes: dict, device) -> tuple:
    g = generator(device, seed, chunk, SALT_CHUNK)
    return shade_draws(g, shapes["shade_points"], shapes["num_samples_x"], device)


def relight_scene(traffic: dict, seed: int, device) -> dict:
    """The relight environment [H, W, 3] (a smooth positive HDR field with a
    bright lobe) and the albedo scaling [3]."""
    g = generator(device, seed, 0, SALT_SCENE)
    h, w = traffic["envmap"]
    coarse = torch.rand((1, 3, 8, 16), generator=g, device=device) * 1.5 + 0.1
    env = torch.nn.functional.interpolate(coarse, size=(h, w), mode="bilinear",
                                          align_corners=False)[0].permute(1, 2, 0)
    cy, cx = torch.rand(2, generator=g, device=device) * torch.tensor([h * 0.5, w], device=device)
    yy = torch.arange(h, device=device)[:, None].float()
    xx = torch.arange(w, device=device)[None, :].float()
    lobe = torch.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * 6.0 ** 2)) * 20.0
    env = (env + lobe[..., None]).contiguous()
    scaling = torch.rand(3, generator=g, device=device) * 0.4 + 0.8
    return {"envmap": env, "albedo_scaling": scaling}
