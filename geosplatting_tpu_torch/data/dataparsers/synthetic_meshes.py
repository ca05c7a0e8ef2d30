"""Rendered layouts: a known mesh drawn into train, val and test views at
parse time. ``MeshViewSynthesisDataparser`` (the pretty shader),
``MeshDRDataparser`` (depth), ``MeshPBRDataparser`` (split-sum PBR under an
HDR environment) and ``ShapeNetDataparser`` (the pure shader).

Counterpart of ``geosplatting_tpu/data/dataparsers/synthetic_meshes.py``.
The mesh is centred on its bounding box and scaled into [-1, 1]^3; val
views lie on an orbit at the model's pitch, train and test views at
uniform random directions drawn once per parser from ``view_sampling_seed``
(train the first, test the last of one draw). The JAX package draws them
with its key; here they come from a CPU ``torch.Generator`` seeded the same,
so they are reproducible on any device but are not the JAX package's
directions (its tests inject those through ``_view_directions``). The views
are rendered on the parser's ``device`` (the dataset's). The shaders raise
where a view would drop triangles; the rendered layouts pass 2048 triangles
a tile (``TILE_CAPACITY``), eight times the JAX package's 256, which drops them without a
word on dense meshes (a 200 x 192 UV sphere seen at 800 x 800 puts 1,463
triangles in the tile at its pole).
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any

import numpy as np
import torch

from ... import _kernels
from ...graphics import shaders
from ...graphics.cameras import Cameras
from ...graphics.mesh import TriangleMesh
from ...graphics.mesh_io import load_mesh
from ..io import load_float32_image
from .blender_family import ParsedSplit

_MVS_MODELS = {
    "spot": ("spot_triangulated.obj", 45.0, 3.0),
    "cube": ("cube.obj", 45.0, 3.0),
    "damicornis": ("usnm_93379-150k.obj", 15.0, 3.0),
}
_DR_MODELS = {
    "spot": ("spot.obj", 45.0, 3.0, False),
    "inputmodels": ("block.obj", 45.0, 3.0, False),
    "damicornis": ("usnm_93379-150k.obj", 15.0, 3.0, False),
    "lego": ("lego.ply", 45.0, 3.0, True),
}
_PBR_MODELS = {
    "spot": ("spot.obj", 45.0, 3.0, None),
    "damicornis": ("usnm_93379-150k.obj", 15.0, 3.0, (0.0, 0.25, 0.0)),
}
TILE_CAPACITY = 2048


def _normalized_mesh(path: Path, device) -> TriangleMesh:
    data = load_mesh(path)
    v = data["vertices"]
    v = v - 0.5 * (v.min(0) + v.max(0))
    v = v / max(np.abs(v).max(), 1e-8)
    return TriangleMesh(vertices=torch.as_tensor(v, dtype=torch.float32, device=device),
                        indices=torch.as_tensor(data["indices"], device=device).long())


def _view_directions(seed: int, num: int) -> torch.Tensor:
    """The unit directions [num, 3] of the random views: normalised normals
    from a CPU generator seeded with ``seed``."""
    from ...graphics import gmath

    return gmath.sample_sphere((num,), generator=torch.Generator().manual_seed(seed))


def _split_cameras(seed: int, split: str, *, radius: float, pitch: float, n_train: int,
                   n_val: int, n_test: int, width: int, height: int, device) -> Cameras:
    kw = dict(width=width, height=height, near=1e-2, far=1e2, fov_degrees=45.0, device=device)
    if split == "val":
        return Cameras.from_orbit(center=[0.0, 0.0, 0.0], radius=radius,
                                  elevation_degrees=pitch, num_samples=n_val, **kw)
    if split not in ("train", "test"):
        raise ValueError(f"unknown split: {split}")
    cams = Cameras.from_sphere(center=[0.0, 0.0, 0.0], radius=radius,
                               num_samples=n_train + n_test,
                               directions=_view_directions(seed, n_train + n_test), **kw)
    return cams[:n_train] if split == "train" else cams[n_train:]


def _rendered_split(cams: Cameras, render_one, meta: Any) -> ParsedSplit:
    with torch.no_grad():
        images = np.stack([render_one(cams[i]).cpu().numpy() for i in range(len(cams))])

    def host(x):
        return x.cpu().numpy()

    return ParsedSplit(
        c2w=host(cams.c2w), focal=float(cams.fx[0]),
        fx=host(cams.fx), fy=host(cams.fy), cx=host(cams.cx), cy=host(cams.cy),
        width=cams.width, height=cams.height, near=cams.near, far=cams.far,
        image_paths=[], images=images, meta=meta,
    )


@dataclasses.dataclass(frozen=True)
class _MeshLayout:
    resolution: int = 800
    num_train_views: int = 100
    num_val_views: int = 100
    num_test_views: int = 200
    view_sampling_seed: int = 123
    device: str | torch.device | None = None   # the card unless another is named

    def _cameras(self, split: str, pitch: float, radius: float) -> Cameras:
        return _split_cameras(
            self.view_sampling_seed, split, radius=radius, pitch=pitch,
            n_train=self.num_train_views, n_val=self.num_val_views,
            n_test=self.num_test_views, width=self.resolution, height=self.resolution,
            device=_kernels.resolve_device(self.device))


@dataclasses.dataclass(frozen=True)
class MeshViewSynthesisDataparser(_MeshLayout):
    """Known models under the pretty shader."""

    resolution: int = 512
    num_train_views: int = 192
    num_val_views: int = 64
    num_test_views: int = 128

    def parse(self, path: Path, split: str) -> ParsedSplit:
        name, pitch, radius = _MVS_MODELS[path.name]
        mesh = _normalized_mesh(path / name, _kernels.resolve_device(self.device))
        return _rendered_split(
            self._cameras(split, pitch, radius),
            lambda c: shaders.render_pretty(mesh, c, tile_capacity=TILE_CAPACITY),
            {"mesh": mesh})

    @staticmethod
    def recognize(path: Path) -> bool:
        return path.name in _MVS_MODELS and (path / _MVS_MODELS[path.name][0]).exists()


@dataclasses.dataclass(frozen=True)
class MeshDRDataparser(_MeshLayout):
    """Known models' depth (rgb = depth, alpha = coverage), for
    depth-supervised reconstruction."""

    def parse(self, path: Path, split: str) -> ParsedSplit:
        name, pitch, radius, _z_up = _DR_MODELS[path.name]
        mesh = _normalized_mesh(path / name, _kernels.resolve_device(self.device))

        def render_depth_rgba(c):
            d = shaders.render_depth(mesh, c, tile_capacity=TILE_CAPACITY)
            depth, a = d[..., 0:1], d[..., 1:2]
            return torch.cat((depth, depth, depth, a), -1)

        return _rendered_split(self._cameras(split, pitch, radius), render_depth_rgba,
                               {"mesh": mesh})

    @staticmethod
    def recognize(path: Path) -> bool:
        return path.name in _DR_MODELS and (path / _DR_MODELS[path.name][0]).exists()


@dataclasses.dataclass(frozen=True)
class MeshPBRDataparser(_MeshLayout):
    """Known models under split-sum PBR: the vertex colours (0.75 without
    them) as albedo, the model's (roughness, metallic), and the lat-long
    HDR ``envmap_path`` as a 128-texel cubemap prefiltered by the sampled
    GGX filter."""

    envmap_path: str = "data/irrmaps/aerodynamics_workshop_2k.hdr"

    def parse(self, path: Path, split: str) -> ParsedSplit:
        from ...graphics.textures import TextureLatLng
        from ...ops import cubemap as cm

        device = _kernels.resolve_device(self.device)
        name, pitch, radius, ks_const = _PBR_MODELS[path.name]
        data = load_mesh(path / name)
        mesh = _normalized_mesh(path / name, device)
        v = mesh.num_vertices
        kd = torch.as_tensor(data.get("colors", np.full((v, 3), 0.75, np.float32)),
                             dtype=torch.float32, device=device)
        ks = torch.tensor((ks_const or (0.0, 0.5, 0.0))[1:3], device=device).expand(v, 2)
        env = torch.as_tensor(load_float32_image(self.envmap_path)[..., :3], device=device)
        with torch.no_grad():
            cube = TextureLatLng(data=env).as_cubemap(128).data
            env_base, env_mips = cm.prefilter_splitsum(cube, method="sampled")
        return _rendered_split(
            self._cameras(split, pitch, radius),
            lambda c: shaders.render_pbr(mesh, c, kd=kd, ks=ks, env_base=env_base,
                                         env_mips=env_mips, tile_capacity=TILE_CAPACITY),
            {"mesh": mesh})

    @staticmethod
    def recognize(path: Path) -> bool:
        return path.name in _PBR_MODELS and (path / _PBR_MODELS[path.name][0]).exists()


@dataclasses.dataclass(frozen=True)
class ShapeNetDataparser(_MeshLayout):
    """ShapeNet ``models/model_normalized.obj`` under the pure shader."""

    num_val_views: int = 20
    num_test_views: int = 20
    view_sampling_seed: int = 1

    def parse(self, path: Path, split: str) -> ParsedSplit:
        mesh = _normalized_mesh(path / "models" / "model_normalized.obj",
                                _kernels.resolve_device(self.device))
        return _rendered_split(
            self._cameras(split, 45.0, 3.0),
            lambda c: shaders.render_pure(mesh, c, tile_capacity=TILE_CAPACITY),
            {"mesh": mesh})

    @staticmethod
    def recognize(path: Path) -> bool:
        return ((path / "models" / "model_normalized.obj").exists()
                and (path / "models" / "model_normalized.mtl").exists())
