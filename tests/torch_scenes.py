"""Scenes and meshes with closed-form ground truth, shared by the port's
tests and ``chip_smoke.py``: the analytic sphere's views (``sphere_gt``,
``sphere_hits``), a Blender-layout scene of it (``write_sphere_scene``), a
Syn4Relight-layout scene of a Lambertian sphere under constant environments
(``write_s4r_scene``, ``S4R_*``) and the UV sphere mesh (``uv_sphere``).
Imports only torch, numpy and the port (the card has no JAX)."""
from __future__ import annotations

import json
import math
from pathlib import Path


def sphere_gt(cams):
    """sRGB rgba views of a shaded sphere of radius 0.5 (analytic ray hits)."""
    import torch

    from geosplatting_tpu_torch.graphics import images

    origins, dirs = cams.generate_rays()
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
    return torch.cat((images.rgb2srgb(rgb) * a, a), -1)


def write_sphere_scene(root, counts: dict, render_res: int, device) -> None:
    """A Blender-layout scene of the analytic sphere (sphere_gt) under root:
    transforms_<split>.json with views on a circle at height 0.35 x 3 of
    radius 0.94 x 3 (the Blender parser scales them by 2/3), val and test
    views offset by 0.3 of a step, and 800x800 RGBA PNGs rendered at
    render_res and upsampled by pixel replication."""
    import numpy as np

    from geosplatting_tpu_torch.data.dataparsers.blender_family import (
        IMAGE_WH, BlenderDataparser,
    )
    from geosplatting_tpu_torch.data.dataset import cameras_of
    from geosplatting_tpu_torch.data.io import dump_float32_image

    root = Path(root)
    rep = IMAGE_WH // render_res
    for split, num in counts.items():
        (root / split).mkdir(parents=True, exist_ok=True)
        frames = []
        for i in range(num):
            th = 2 * np.pi * (i + (0.3 if split != "train" else 0)) / num
            eye = 3.0 * np.array([np.cos(th) * 0.94, np.sin(th) * 0.94, 0.35])
            fwd = -eye / np.linalg.norm(eye)
            right = np.cross(fwd, [0.0, 0.0, 1.0])
            right /= np.linalg.norm(right)
            c2w = np.eye(4)
            c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, np.cross(right, fwd), -fwd, eye
            frames.append({"file_path": f"./{split}/r_{i}", "transform_matrix": c2w.tolist()})
        with open(root / f"transforms_{split}.json", "w") as f:
            json.dump({"camera_angle_x": 0.8, "frames": frames}, f)
        cams = cameras_of(BlenderDataparser().parse(root, split), render_res / IMAGE_WH, device)
        gt = sphere_gt(cams).cpu().numpy()
        for i in range(num):
            dump_float32_image(root / split / f"r_{i}.png",
                               np.kron(gt[i], np.ones((rep, rep, 1), np.float32)))


# the S4R scene of chip_smoke.py's chain phase and the S4R tests: a Lambertian
# sphere of radius 0.5 and albedo S4R_ALBEDO under constant lat-long
# environments, so that every image is a closed form: a convex object under a
# uniform environment is unshadowed, and its radiance is albedo x the
# environment's radiance
S4R_ALBEDO = (0.6, 0.5, 0.4)
S4R_RADIANCE = {"train": 1.0, "envmap6": 0.7, "envmap12": 1.3}
S4R_ROUGHNESS = 0.5


def sphere_hits(cams):
    """(hit mask [..., H, W, 1] float) of the sphere of radius 0.5 at the origin."""
    origins, dirs = cams.generate_rays()
    b = (origins * dirs).sum(-1)
    c = (origins * origins).sum(-1) - 0.25
    disc = b * b - c
    hit = (disc > 0) & (-b - (disc.clamp(min=0.0)).sqrt() > 0)
    return hit[..., None].float()


def write_s4r_scene(root, counts: dict, render_res: int, device) -> None:
    """A Syn4Relight-layout scene of the closed-form sphere (S4R_*) under
    root, its environments in root's parent. The stored poses are the
    inverse of the parser's axis swap and 2/3 scale applied to orbit
    cameras around the origin (radius 2, elevation 20 degrees, test views
    offset by 0.3 of a step); the ground truth is rendered at render_res
    from the cameras parsed back, and upsampled to 800 x 800 by pixel
    replication: train/r_i_rgb.hdr (linear albedo x L_train) with
    r_i_mask.png; test/r_i_rgba.png, r_i_albedo.png (sRGB) and r_i_rough.png
    (linear), alpha the mask; test_rli/envmap{6,12}_r_i.png (sRGB);
    ../envmap{6,12}.hdr (16 x 32)."""
    import numpy as np
    import torch

    from geosplatting_tpu_torch.data.dataparsers.blender_family import (
        IMAGE_WH, Syn4RelightDataparser,
    )
    from geosplatting_tpu_torch.data.dataset import cameras_of
    from geosplatting_tpu_torch.data.io import dump_float32_image
    from geosplatting_tpu_torch.graphics import images

    root = Path(root)
    rep = IMAGE_WH // render_res
    albedo = np.asarray(S4R_ALBEDO, np.float32)
    for env in ("envmap6", "envmap12"):
        dump_float32_image(root.parent / f"{env}.hdr",
                           np.full((16, 32, 3), S4R_RADIANCE[env], np.float32))

    def up(img):
        return np.kron(img, np.ones((rep, rep, 1), np.float32))

    def srgb(x):
        return images.rgb2srgb(torch.as_tensor(x)).numpy()

    for split, num in counts.items():
        (root / split).mkdir(parents=True, exist_ok=True)
        frames = []
        for i in range(num):
            th = 2 * np.pi * (i + (0.3 if split != "train" else 0)) / num
            el = np.deg2rad(20.0)
            eye = 2.0 * np.array([np.cos(th) * np.cos(el), np.sin(el), np.sin(th) * np.cos(el)])
            fwd = -eye / np.linalg.norm(eye)
            right = np.cross(fwd, [0.0, 1.0, 0.0])
            right /= np.linalg.norm(right)
            parsed = np.stack((right, np.cross(right, fwd), -fwd, eye), -1)   # [3, 4], +y up
            parsed[:, 3] *= 1.5              # the parser scales translations by 2/3
            stored = np.eye(4)
            stored[:3] = np.stack((-parsed[2], -parsed[0], parsed[1]))  # rows (-y, z, -x) inverted
            frames.append({"file_path": f"./{split}/r_{i}", "transform_matrix": stored.tolist()})
        with open(root / f"transforms_{split}.json", "w") as f:
            json.dump({"camera_angle_x": 0.8, "frames": frames}, f)
    (root / "test_rli").mkdir(exist_ok=True)
    for split, num in counts.items():
        cams = cameras_of(Syn4RelightDataparser().parse(root, split), render_res / IMAGE_WH,
                          device)
        mask = sphere_hits(cams).cpu().numpy()
        for i in range(num):
            m = up(mask[i])
            if split == "train":
                dump_float32_image(root / split / f"r_{i}_rgb.hdr",
                                   albedo * S4R_RADIANCE["train"] * m)
                dump_float32_image(root / split / f"r_{i}_mask.png", m)
                continue
            for name, value in (("rgba", srgb(albedo * S4R_RADIANCE["train"])),
                                ("albedo", srgb(albedo)),   # roughness is stored linear
                                ("rough", np.full(3, S4R_ROUGHNESS, np.float32))):
                dump_float32_image(root / split / f"r_{i}_{name}.png",
                                   np.concatenate((value * m, m), -1))
            for env in ("envmap6", "envmap12"):
                dump_float32_image(root / "test_rli" / f"{env}_r_{i}.png",
                                   np.concatenate((srgb(albedo * S4R_RADIANCE[env]) * m, m), -1))


def uv_sphere(rows: int, cols: int, radius: float = 0.5, device=None):
    """The UV sphere of scripts/prior_scale_demo.py:43-63: (rows + 1) rings
    of cols vertices from polar angle 1e-3 to pi - 1e-3, two triangles a
    quad, the columns wrapped: 2 x rows x cols faces."""
    import torch

    from geosplatting_tpu_torch.graphics.mesh import TriangleMesh

    th = torch.linspace(1e-3, math.pi - 1e-3, rows + 1, dtype=torch.float64)
    ph = torch.arange(cols, dtype=torch.float64) * (2 * math.pi / cols)
    tt, pp = torch.meshgrid(th, ph, indexing="ij")
    v = torch.stack((tt.sin() * pp.cos(), tt.cos(), tt.sin() * pp.sin()), -1).reshape(-1, 3)
    r = torch.arange(rows)[:, None]
    c = torch.arange(cols)[None, :]
    c1 = (c + 1) % cols
    i00, i01, i10, i11 = r * cols + c, r * cols + c1, (r + 1) * cols + c, (r + 1) * cols + c1
    f = torch.cat((torch.stack((i00, i10, i01), -1).reshape(-1, 3),
                   torch.stack((i01, i10, i11), -1).reshape(-1, 3)))
    return TriangleMesh(vertices=(v * radius).float().to(device), indices=f.to(device))
