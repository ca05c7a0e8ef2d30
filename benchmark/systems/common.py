"""What the systems share: the package namespace and the stage-1 start."""
from __future__ import annotations

import importlib
from types import SimpleNamespace

import torch

PROGRAM = "geosplatting_tpu_torch"
REFERENCE = "benchmark.reference.plain"


def package(root: str) -> SimpleNamespace:
    """The classes and functions a system module uses, from the program (``PROGRAM``)
    or from the reference's frozen copy (``REFERENCE``): the two have the
    same layout."""
    def imp(name):
        return importlib.import_module(f"{root}.{name}")

    cams = imp("graphics.cameras")
    geo = imp("models.geosplat")
    mc = imp("models.geosplat_mc")
    defer = imp("models.geosplat_defer")
    mct = imp("train.geosplat_mc_trainer")
    dft = imp("train.geosplat_defer_trainer")
    es = imp("ops.envshade")
    fc = imp("graphics.flexicubes")
    return SimpleNamespace(
        root=root, Cameras=cams.Cameras, GeoSplatter=geo.GeoSplatter,
        GeoSplatterMC=mc.GeoSplatterMC, export_stage1=mc.export_stage1,
        compact_export=mc.compact_export, GeoSplatterDefer=defer.GeoSplatterDefer,
        GeoSplatMCTrainer=mct.GeoSplatMCTrainer,
        GeoSplatMCTrainerConfig=mct.GeoSplatMCTrainerConfig,
        GeoSplatDeferTrainer=dft.GeoSplatDeferTrainer,
        GeoSplatDeferTrainerConfig=dft.GeoSplatDeferTrainerConfig,
        ShadeDraws=es.ShadeDraws, make_grid=fc.make_grid,
    )


def stage1_sphere(pkg, cfg: dict, gen: torch.Generator, device):
    """A stage-1 ``GeoSplatter`` at the configuration's grid and scale with
    random weights from ``gen`` and the SDF sphere init (radius
    ``sdf_radius``): the in-memory stand-in for a stage-1 run."""
    stage1 = pkg.GeoSplatter(resolution=cfg["grid"], scale=cfg["scene_scale"],
                             triplane_resolution=cfg["triplane_resolution"],
                             triplane_components=cfg["triplane_components"],
                             generator=gen, device=device)
    with torch.no_grad():
        stage1.sdf.copy_(torch.linalg.norm(stage1.grid.base_vertices(device), dim=-1)
                         - cfg["sdf_radius"])
    return stage1


def draws_of(pkg, raw: tuple):
    return pkg.ShadeDraws(*raw)
